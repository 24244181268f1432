"""The exact layout rewrites of the port's FastDiffSR UNet against the
JAX package's: ``apply_upsample2_conv3`` in each Upsample form, the whole
UNet in each mode (tconv, d2s2, fold down/all, skip_concat split/swap,
conv_split, stats_barrier) against the Flax UNet in the same mode with
the same converted parameters, the gradients of every parameter in train
mode against the port's literal form, JAX's validation errors, and the
builders' reading of the environment.

Tiny UNet: inner 16, groups 8, mults (1, 2), 2 res blocks, 16x16, batch
2. Its up path has blocks where the split/swap forms apply (ups_0, ups_1,
ups_5, ups_6: each GroupNorm group inside one part) and blocks where
they do not (ups_2, ups_4: 48 channels, group size 6, a 32-channel
part)."""

import functools
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdiffsr_tpu.models import unet_fastdiffsr as jax_unet
from fastdiffsr_tpu.models.unet_fastdiffsr import FastDiffSRUNet as FlaxUNet
from fastdiffsr_tpu_torch.models import unet_fastdiffsr
from fastdiffsr_tpu_torch.models.convert import flax_params_to_torch
from fastdiffsr_tpu_torch.models.unet_fastdiffsr import (
    FastDiffSRUNet, apply_upsample2_conv3, fold2, resblock_names, unfold2,
    unet_from_config)
from fastdiffsr_tpu_torch.ops.groupnorm import gn_swish_custom

torch.set_num_threads(2)

KW = dict(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
          res_blocks=2, dropout=0.0)
UPS = "ups_0,ups_1,ups_2,ups_4,ups_5,ups_6"
# mode -> constructor arguments (the same on both sides)
MODES = {
    "tconv": {"upsample_mode": "tconv"},
    "d2s2": {"upsample_mode": "d2s2"},
    "fold_down": {"fold": "down"},
    "fold_all": {"fold": "all"},
    "split": {"skip_concat": "split"},
    "swap": {"skip_concat": "swap"},
    "conv_split": {"conv_split": UPS},
    "stats_barrier": {"stats_barrier": "downs_1,mid_0,ups_2,ups_6"},
    "tconv_fold_all": {"upsample_mode": "tconv", "fold": "all"},
    "d2s2_split": {"upsample_mode": "d2s2", "skip_concat": "split"},
}
# K1 calls per forward: 2 per ResnetBlock (12 of them) + the final Block,
# and one more for each of the 4 up blocks whose block1 takes the parts
K1_CALLS = {"split": 25 + 4, "d2s2_split": 25 + 4}


@functools.lru_cache(maxsize=None)
def _tree():
    """Seeded Flax params of the tiny UNet (GroupNorm affines and biases
    moved off 1/0) as numpy, and the inputs."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 6)).astype(np.float32)
    lvl = np.asarray([0.7, 0.3], np.float32)
    params = jax.jit(FlaxUNet(**KW).init)(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]),
        jnp.asarray(lvl[:1]))["params"]
    leaves, treedef = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, params))
    leaves = [v + rng.standard_normal(v.shape).astype(np.float32) * 0.05
              if v.ndim == 1 else v for v in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves), x, lvl


def _port(tree, **kw):
    net = FastDiffSRUNet(**dict(KW, **kw)).eval()
    net.load_state_dict(flax_params_to_torch(tree), strict=True)
    return net


@pytest.mark.parametrize("mode", ["", "tconv", "d2s2"])
@pytest.mark.parametrize("h,w,c", [(8, 8, 16), (5, 7, 8)])
def test_apply_upsample2_conv3_matches_jax(mode, h, w, c):
    """Each form against JAX's same form on the same inputs, f32: atol
    2e-6 (tests/test_ops.py's bound between the forms), odd sizes too;
    the port's output is channels-last."""
    rng = np.random.default_rng(h * w)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, c)) / np.sqrt(9 * c)).astype(
        np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    want = np.asarray(jax_unet.apply_upsample2_conv3(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), mode, jnp.float32))
    got = apply_upsample2_conv3(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(k).permute(3, 2, 0, 1), torch.from_numpy(b), mode,
        torch.float32)
    assert got.shape == (2, c, 2 * h, 2 * w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=2e-6)


def test_upsample_forms_agree_in_bf16():
    """bf16 compute: tconv and d2s2 against the literal form within two
    bf16 steps of max|y| (each rounds its own products and sums)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 16, 9, 6)).astype(
        np.float32)).permute(0, 3, 1, 2)
    w = torch.randn(5, 6, 3, 3, generator=torch.Generator().manual_seed(1))
    b = torch.randn(5, generator=torch.Generator().manual_seed(2))
    want = apply_upsample2_conv3(x, w, b, "", torch.bfloat16).float()
    for mode in ("tconv", "d2s2"):
        got = apply_upsample2_conv3(x, w, b, mode, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert (got.float() - want).abs().max() <= 2 ** -7 * want.abs().max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_upsample_tconv_is_conv_transpose2d(dtype):
    """``ops.tconv.upsample_tconv`` (the tconv form's transposed conv, an
    ``fdsr::`` operator): F.conv_transpose2d's values, channels-last, and
    its gradients (gradcheck in f64)."""
    import torch.nn.functional as F
    from fastdiffsr_tpu_torch.ops.tconv import upsample_tconv
    g = torch.Generator().manual_seed(7)
    args = [torch.randn(s, generator=g, dtype=dtype, requires_grad=True)
            for s in ((2, 5, 5, 7), (5, 3, 4, 4), (3,))]
    got = upsample_tconv(*args)
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(
        got, F.conv_transpose2d(*args, stride=2, padding=1), rtol=0,
        atol=0)
    if dtype == torch.float64:
        assert torch.autograd.gradcheck(upsample_tconv, tuple(args))


def test_upsample_tconv_stays_one_operator_in_an_export():
    """An exported tconv Upsample keeps ``fdsr::upsample_tconv``, so the
    artifact runs it on cuDNN's deterministic algorithms whatever the
    loading process sets."""
    w = torch.randn(4, 6, 3, 3, generator=torch.Generator().manual_seed(1))
    b = torch.zeros(4)

    class Up(torch.nn.Module):
        def forward(self, x):
            return apply_upsample2_conv3(x, w, b, "tconv", torch.float32)

    with torch.no_grad():
        ep = torch.export.export(Up(), (torch.randn(1, 6, 5, 5),))
    ops = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert "fdsr.upsample_tconv.default" in ops
    assert not any("convolution" in o for o in ops)


def test_fold2_is_jax_fold2_and_unfold2_inverts_it():
    x = np.random.default_rng(1).standard_normal((4, 3, 5, 6)).astype(
        np.float32)                                        # NHWC
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    y = fold2(xt)
    assert y.shape == (2, 12, 3, 5)
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(y.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jax_unet.fold2(jnp.asarray(x))))
    assert torch.equal(unfold2(y), xt)


def _recording(calls):
    def rec(x, scale, bias, groups, eps=1e-5):
        calls.append((tuple(x.shape), groups, x.is_contiguous()))
        return gn_swish_custom(x, scale, bias, groups, eps)
    return rec


@pytest.mark.parametrize("mode", sorted(MODES))
def test_unet_mode_matches_jax(mode, monkeypatch):
    """The port's UNet in ``mode`` against the Flax UNet in the same mode
    with the same parameters, f32: atol 2e-4 (as tests/test_torch_unet.py:
    GroupNorm variance formulas and summation orders differ; outputs are
    O(1)). Every GroupNorm -> Swish goes through gn_swish_custom (K1) on a
    contiguous NHWC map; fold's level-0 maps carry 2C channels in twice
    the groups."""
    tree, x, lvl = _tree()
    kw = MODES[mode]
    want = np.asarray(FlaxUNet(**KW, **kw).apply(
        {"params": tree}, jnp.asarray(x), jnp.asarray(lvl),
        deterministic=True))
    calls = []
    monkeypatch.setattr(unet_fastdiffsr, "gn_swish_custom",
                        _recording(calls))
    with torch.no_grad():
        got = _port(tree, **kw)(torch.from_numpy(x), torch.from_numpy(lvl))
    assert got.shape == (2, 16, 16, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    assert len(calls) == K1_CALLS.get(mode, 25)
    assert all(c for _, _, c in calls)
    if "fold" in kw:
        folded = [(s, g) for s, g, _ in calls if s[0] == 1]
        # level 0: 2 down blocks, and with 'all' 3 up blocks + the final
        want_n = 11 if kw["fold"] == "all" else 4
        assert len(folded) == want_n
        assert all(g == 2 * KW["norm_groups"] for _, g in folded)


@pytest.mark.parametrize("mode", ["fold_down", "fold_all", "split", "swap",
                                  "conv_split", "tconv", "d2s2"])
def test_train_mode_gradients_match_literal(mode):
    """Train mode with dropout 0.3 on both nets and generators of one
    seed: the form draws the literal form's masks (fold in the unfolded
    layout), so the output and the gradient of every parameter of a loss
    agree with the literal form's, f32: output atol 1e-5, each gradient
    within 1e-4 of its tensor's max |g|."""
    tree, x, lvl = _tree()
    nets = [_port(tree, **kw, dropout=0.3).train()
            for kw in ({}, MODES[mode])]
    outs, grads = [], []
    for net in nets:
        y = net(torch.from_numpy(x), torch.from_numpy(lvl),
                generator=torch.Generator().manual_seed(5))
        (y.square().mean() + y.mean()).backward()
        outs.append(y.detach())
        grads.append({k: p.grad for k, p in net.named_parameters()})
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-5)
    assert grads[0].keys() == grads[1].keys()
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=0,
                                   atol=1e-4 * max(g.abs().max().item(),
                                                   1e-6), msg=k)
    # dropout is on: another seed draws other masks
    with torch.no_grad():
        other = nets[1](torch.from_numpy(x), torch.from_numpy(lvl),
                        generator=torch.Generator().manual_seed(6))
    assert (other - outs[1]).abs().max() > 1e-3


# (constructor arguments, batch) whose JAX module raises a ValueError
BAD = {
    "skip_concat": ({"skip_concat": "cat"}, 2),
    "conv_split_upsample": ({"conv_split": "ups_3"}, 2),
    "conv_split_down": ({"conv_split": "downs_1"}, 2),
    "conv_split_quant": ({"conv_split": "ups_0", "quant": "w8a8"}, 2),
    "conv_split_fold": ({"conv_split": "ups_0", "fold": "down"}, 2),
    "conv_split_skip": ({"conv_split": "ups_0", "skip_concat": "swap"}, 2),
    "barrier": ({"stats_barrier": "mid_0,up_12"}, 2),
    "fold": ({"fold": "up"}, 2),
    "fold_quant": ({"fold": "down", "quant": "w8a8"}, 2),
    "fold_skip": ({"fold": "all", "skip_concat": "split"}, 2),
    "fold_odd_batch": ({"fold": "down"}, 3),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validation_errors_are_jaxs(case):
    """The port raises the ValueError JAX raises, with its message: at
    construction, or for the batch at the forward."""
    kw, batch = BAD[case]
    x = jnp.zeros((batch, 16, 16, 6))
    with pytest.raises(ValueError) as jax_err:
        FlaxUNet(**KW, **kw).init(jax.random.PRNGKey(0), x,
                                  jnp.ones((batch,)))
    with pytest.raises(ValueError) as port_err:
        net = FastDiffSRUNet(**KW, **kw)
        net(torch.zeros((batch, 16, 16, 6)), torch.ones((batch,)))
    assert str(port_err.value) == str(jax_err.value)


def test_resblock_names_are_jaxs():
    for mults, rb in (((1, 2), 2), ((1, 2, 4, 4), 2), ((1, 2, 4, 8, 8), 3)):
        assert resblock_names(len(mults), rb) == FlaxUNet(
            channel_mults=mults, res_blocks=rb)._resblock_names()


def test_upsample_mode_is_checked():
    with pytest.raises(ValueError, match="upsample_mode='dense'"):
        FastDiffSRUNet(**KW, upsample_mode="dense")


# environment variable -> values tried (None: unset)
ENV = {
    "FASTDIFFSR_TPU_UPSAMPLE": (None, "dense", "tconv", "d2s2", "", "bad"),
    "FASTDIFFSR_TPU_FOLD": (None, "down", "all", "bad"),
    "FASTDIFFSR_TPU_SKIP_CONCAT": (None, "split", "swap", "bad"),
    "FASTDIFFSR_TPU_CONV_SPLIT": (None, "ups_0,ups_5"),
}
READER = {"FASTDIFFSR_TPU_UPSAMPLE": "default_upsample_mode",
          "FASTDIFFSR_TPU_FOLD": "default_fold",
          "FASTDIFFSR_TPU_SKIP_CONCAT": "default_skip_concat",
          "FASTDIFFSR_TPU_CONV_SPLIT": "default_conv_split"}
ATTR = {"FASTDIFFSR_TPU_UPSAMPLE": "upsample_mode",
        "FASTDIFFSR_TPU_FOLD": "fold",
        "FASTDIFFSR_TPU_SKIP_CONCAT": "skip_concat",
        "FASTDIFFSR_TPU_CONV_SPLIT": "conv_split"}


@pytest.mark.parametrize("var,value", [(v, x) for v in sorted(ENV)
                                       for x in ENV[v]])
def test_builder_reads_the_variable_as_jax(var, value, monkeypatch):
    """Each reader gives JAX's value (or raises JAX's error), and
    ``unet_from_config`` builds that mode, as JAX's builder does."""
    for v in ENV:
        monkeypatch.delenv(v, raising=False)
    if value is not None:
        monkeypatch.setenv(var, value)
    port_read = getattr(unet_fastdiffsr, READER[var])
    jax_read = getattr(jax_unet, READER[var])
    try:
        want = jax_read()
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            port_read()
        assert str(err.value) == str(e)
        return
    assert port_read() == want
    opt = {"inner_channel": 16, "norm_groups": 8,
           "channel_multiplier": [1, 2], "res_blocks": 2}
    net = unet_from_config(opt, device="cpu")
    assert getattr(net, ATTR[var]) == want
    jax_net = jax_unet.unet_from_config(opt)
    assert getattr(jax_net, ATTR[var]) == want
    if var == "FASTDIFFSR_TPU_UPSAMPLE":
        assert net.ups[3].mode == want


def test_constructors_default_to_the_literal_forms():
    """As the Flax modules: only the builders read the variables."""
    net = FastDiffSRUNet(**KW)
    assert (net.upsample_mode, net.fold, net.skip_concat, net.conv_split,
            net.stats_barrier) == ("", "", "", "", "")
    assert [m.mode for m in net.ups if hasattr(m, "mode")] == [""]


def test_chip_smoke_rewrite_env_builds_each_mode(monkeypatch):
    """chip_smoke's phase 23 builds each mode through ``unet_from_config``
    from the variables of ``rewrite_env``: one rewrite each over the
    literal forms, at the full-width config's block names; ``environ``
    restores the environment."""
    import chip_smoke
    from fastdiffsr_tpu_torch.config import load_json_config
    monkeypatch.setenv("FASTDIFFSR_TPU_FOLD", "all")
    monkeypatch.delenv("FASTDIFFSR_TPU_SKIP_CONCAT", raising=False)
    before = dict(os.environ)
    opt = load_json_config(str(
        pathlib.Path(unet_fastdiffsr.__file__).parents[1] / "configs"
        / "sr_fastdiffsr_test_64_256.json"))["model"]["unet"]
    want = {"literal": ("", "", "", ""), "tconv": ("tconv", "", "", ""),
            "d2s2": ("d2s2", "", "", ""), "fold_down": ("", "down", "", ""),
            "fold_all": ("", "all", "", ""), "split": ("", "", "split", ""),
            "swap": ("", "", "swap", "")}
    for mode in chip_smoke.REWRITE_MODES:
        with chip_smoke.environ(chip_smoke.rewrite_env(mode)):
            net = unet_from_config(opt, device="cpu")
        got = (net.upsample_mode, net.fold, net.skip_concat, net.conv_split)
        if mode == "conv_split":
            assert got[:3] == ("", "", "")
            assert sum(1 for m in net.ups
                       if getattr(getattr(m, "res_block", None), "csplit",
                                  0)) == 12
        else:
            assert got == want[mode]
    assert dict(os.environ) == before


def test_chip_smoke_switches_the_upsample_form():
    """``set_upsample_mode`` reaches every Upsample form of the SR3, guided
    and ConditionalUNet nets, and ``upsample_modes`` reads them back."""
    import chip_smoke
    from fastdiffsr_tpu_torch.models.cond_unet import ConditionalUNet
    from fastdiffsr_tpu_torch.models.unet_guided import GuidedUNet
    from fastdiffsr_tpu_torch.models.unet_sr3 import SR3UNet
    nets = [SR3UNet(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                    attn_res=(), res_blocks=1, image_size=16,
                    upsample_mode="tconv"),
            GuidedUNet(image_size=16, model_channels=32,
                       channel_mults=(1, 2), res_blocks=1,
                       attention_resolutions=(), upsample_mode="tconv"),
            ConditionalUNet(nf=8, depth=2, upsample_mode="tconv")]
    for net in nets:
        assert chip_smoke.upsample_modes(net) == {"tconv"}
        chip_smoke.set_upsample_mode(net, "")
        assert chip_smoke.upsample_modes(net) == {""}
