"""The port's SR3 (ddpm/tesr) and guided (gdp) UNets against the Flax
UNets of the JAX package. Every leaf of the Flax tree is first filled
with seeded random values at a sane scale (the guided UNet's zero-init
layers would otherwise make it output exactly 0), then converted with
the port's converters. Tiny sizes where both attention paths fire: SR3
inner 16, groups 8, mults (1, 2), attn_res (8,) at 16x16 (attention at
8x8 in the level and in mid_0); guided 32 channels (its GroupNorm has 32
groups), mults (1, 2), attention at ds 2 with 2 heads, one down and one
up ResBlock. Also one training loss per variant, K1 under every
GroupNorm -> Swish, and ``use_checkpoint`` gradients under dropout."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdiffsr_tpu.diffusion import DiffusionEngine as JaxEngine
from fastdiffsr_tpu.diffusion import DiffusionSpec as JaxSpec
from fastdiffsr_tpu.diffusion import ScheduleBuffers as JaxBuffers
from fastdiffsr_tpu.models.convert import (torch_guided_unet_to_flax,
                                           torch_unet_to_flax)
from fastdiffsr_tpu.models.unet_guided import GuidedUNet as FlaxGuided
from fastdiffsr_tpu.models.unet_guided import \
    guided_timestep_embedding as jax_guided_embedding
from fastdiffsr_tpu.models.unet_sr3 import SR3UNet as FlaxSR3
from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine, DiffusionSpec,
                                            ScheduleBuffers)
from fastdiffsr_tpu_torch.models import unet_fastdiffsr, unet_guided
from fastdiffsr_tpu_torch.models.convert import (flax_converter,
                                                 flax_guided_params_to_torch,
                                                 flax_params_to_torch,
                                                 flax_sr3_params_to_torch)
from fastdiffsr_tpu_torch.models.unet_guided import (
    GuidedResBlock, GuidedUNet, guided_timestep_embedding,
    guided_unet_from_config, init_guided_params)
from fastdiffsr_tpu_torch.models.unet_sr3 import SR3UNet, sr3_unet_from_config
from fastdiffsr_tpu_torch.ops.groupnorm import gn_swish_custom

torch.set_num_threads(2)

SIZE = 16
SR3_KW = dict(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
              attn_res=(8,), res_blocks=1, image_size=SIZE)
GUIDED_KW = dict(image_size=SIZE, model_channels=32, channel_mults=(1, 2),
                 res_blocks=1, attention_resolutions=(2,),
                 num_head_channels=32)
SCHED = {"schedule": "linear", "n_timestep": 50, "linear_start": 1e-4,
         "linear_end": 5e-2}


def randomize(tree, seed):
    """Every leaf seeded: kernels N(0, 1/fan_in), norm scales 1 + 0.1 N,
    biases 0.1 N."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, v in flat:
        name = path[-1].key
        z = rng.standard_normal(v.shape).astype(np.float32)
        if name == "kernel":
            v = z / np.sqrt(np.prod(v.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * z
        else:
            v = 0.1 * z
        out.append(v.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


@functools.lru_cache(maxsize=None)
def _flax_init(arch):
    """(Flax net, its jitted init) of a tiny UNet, compiled once."""
    net = FlaxSR3(**SR3_KW) if arch == "sr3" else FlaxGuided(**GUIDED_KW)
    return net, jax.jit(net.init)


@functools.lru_cache(maxsize=None)
def _flax(arch, seed=0):
    """(Flax net, randomized params as numpy) of a tiny UNet."""
    net, init = _flax_init(arch)
    params = init(jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 6)),
                  jnp.ones((1,)))["params"]
    return net, randomize(jax.tree_util.tree_map(np.asarray, params), seed)


def _port(arch, tree, **kw):
    net = (SR3UNet(**SR3_KW, **kw) if arch == "sr3"
           else GuidedUNet(**GUIDED_KW, **kw))
    conv = (flax_sr3_params_to_torch if arch == "sr3"
            else flax_guided_params_to_torch)
    net.load_state_dict(conv(tree), strict=True)
    return net


LEVELS = {"discrete": np.asarray([3.0, 41.0], np.float32),
          "continuous": np.asarray([0.93, 0.27], np.float32)}


@pytest.mark.parametrize("arch", ["sr3", "guided"])
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_unet_matches_flax(arch, level):
    """f32 forward on both sides: atol 1e-4 of max(1, max|y|) (GroupNorm
    variance formulas, the attention's summation order)."""
    flax_net, tree = _flax(arch)
    net = _port(arch, tree).eval()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, SIZE, SIZE, 6)).astype(np.float32)
    lvl = LEVELS[level]
    want = np.asarray(flax_net.apply({"params": tree}, jnp.asarray(x),
                                     jnp.asarray(lvl), deterministic=True))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(lvl))
    assert got.shape == (2, SIZE, SIZE, 3) and got.dtype == torch.float32
    assert np.abs(want).max() > 0.1      # randomized: no vacuous zeros
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("arch", ["sr3", "guided"])
def test_both_attention_paths_and_resamples_are_built(arch):
    """The tiny configs reach what the test means to cover: attention in
    a level and in the middle (SR3: downs/ups and mid_0; guided: input,
    middle and output blocks), and the guided up/down ResBlocks."""
    _, tree = _flax(arch)
    names = set(tree)
    if arch == "sr3":
        attn = {k for k in names if "attn" in tree[k]}
        assert "mid_0" in attn and any(k.startswith("downs") for k in attn)
        assert any(k.startswith("ups") for k in attn)
    else:
        net = _port(arch, tree)
        kinds = {(b.up, b.down) for b in net.modules()
                 if isinstance(b, GuidedResBlock)}
        assert {(True, False), (False, True)} <= kinds
        assert {"middle_1", "input_3_1"} <= names
        assert any(k.startswith("output") and k.endswith("_1")
                   and "qkv" in tree[k] for k in names)


@pytest.mark.parametrize("arch", ["sr3", "guided"])
def test_converter_is_the_inverse_of_the_jax_converter(arch):
    """The torch names are the reference's: the JAX package's own
    converter maps the port's state dict back onto the Flax tree."""
    _, tree = _flax(arch)
    sd = {k: v.numpy() for k, v in flax_converter(
        "ddpm" if arch == "sr3" else "gdp")(tree).items()}
    back = (torch_unet_to_flax(sd) if arch == "sr3"
            else torch_guided_unet_to_flax(sd))
    a = jax.tree_util.tree_leaves_with_path(tree)
    b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(a) == len(b) == len(_port(arch, tree).state_dict())
    for path, v in a:
        np.testing.assert_array_equal(b[path], v, err_msg=str(path))


def test_converter_dispatch():
    assert flax_converter("fastdiffsr") is flax_params_to_torch
    assert flax_converter("tesr") is flax_sr3_params_to_torch
    assert flax_converter("gdp") is flax_guided_params_to_torch
    with pytest.raises(ValueError, match="which_model_G"):
        flax_converter("sr4")


def test_guided_timestep_embedding_matches_jax():
    t = np.asarray([0.0, 3.0, 999.0], np.float32)
    for dim in (32, 33):
        np.testing.assert_allclose(
            guided_timestep_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jax_guided_embedding(jnp.asarray(t), dim)),
            rtol=0, atol=2e-5)


def test_guided_init_has_the_zero_layers():
    """Flax's zeros_init layers are zero in the port's init too, so a
    freshly initialised guided UNet outputs exactly 0."""
    net = init_guided_params(GuidedUNet(**GUIDED_KW), seed=1).eval()
    with torch.no_grad():
        y = net(torch.randn(1, SIZE, SIZE, 6), torch.tensor([5.0]))
    assert torch.equal(y, torch.zeros_like(y))
    assert net.input_blocks[1][0].in_layers[2].weight.abs().max() > 0


def test_from_config_constructors(monkeypatch):
    """``model_channels`` sets the guided width and ``inner_channel`` is
    ignored; SR3 reads ``attn_res``; both builders read the Upsample form
    from FASTDIFFSR_TPU_UPSAMPLE with JAX's default, tconv ('dense' is the
    literal form), and the constructors default to the literal form."""
    monkeypatch.delenv("FASTDIFFSR_TPU_UPSAMPLE", raising=False)
    g_opt = {"model_channels": 32, "inner_channel": 8,
             "channel_multiplier": [1, 2], "res_blocks": 1}
    s_opt = {"inner_channel": 16, "norm_groups": 8,
             "channel_multiplier": [1, 2], "attn_res": [8],
             "res_blocks": 1}
    g = guided_unet_from_config(g_opt, image_size=SIZE, device="cpu")
    assert g.input_blocks[0][0].out_channels == 32 and not g.training
    s = sr3_unet_from_config(s_opt, image_size=SIZE, device="cpu")
    assert s.downs[1].attn is None and s.downs[3].attn is not None

    def modes(net):
        return {m.upsample_mode if isinstance(m, GuidedResBlock) else m.mode
                for m in net.modules()
                if isinstance(m, (GuidedResBlock, unet_fastdiffsr.Upsample))
                and (not isinstance(m, GuidedResBlock) or m.up)}

    assert modes(g) == modes(s) == {"tconv"}
    monkeypatch.setenv("FASTDIFFSR_TPU_UPSAMPLE", "dense")
    assert modes(guided_unet_from_config(g_opt, image_size=SIZE,
                                         device="cpu")) == {""}
    assert modes(sr3_unet_from_config(s_opt, image_size=SIZE,
                                      device="cpu")) == {""}
    assert modes(SR3UNet(**SR3_KW)) == modes(GuidedUNet(**GUIDED_KW)) == {""}
    for cls, kw in ((SR3UNet, SR3_KW), (GuidedUNet, GUIDED_KW)):
        with pytest.raises(ValueError, match="upsample_mode='dense'"):
            cls(**kw, upsample_mode="dense")


@pytest.mark.parametrize("arch", ["sr3", "guided"])
@pytest.mark.parametrize("mode", ["tconv", "d2s2"])
def test_unet_upsample_modes_match_flax(arch, mode):
    """The Upsample forms on both sides (SR3's Upsample, the guided up
    ResBlock's in_layers conv), same params: f32 atol 1e-4 of max(1,
    max|y|), as test_unet_matches_flax."""
    _, tree = _flax(arch)
    flax_net = (FlaxSR3(**SR3_KW, upsample_mode=mode) if arch == "sr3"
                else FlaxGuided(**GUIDED_KW, upsample_mode=mode))
    net = _port(arch, tree, upsample_mode=mode).eval()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, SIZE, SIZE, 6)).astype(np.float32)
    lvl = LEVELS["discrete"]
    want = np.asarray(flax_net.apply({"params": tree}, jnp.asarray(x),
                                     jnp.asarray(lvl), deterministic=True))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(lvl))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


def _recording(calls):
    def rec(x, scale, bias, groups, eps=1e-5):
        calls.append(x.is_contiguous())
        return gn_swish_custom(x, scale, bias, groups, eps)
    return rec


@pytest.mark.parametrize("arch", ["sr3", "guided"])
def test_k1_runs_every_groupnorm_swish_on_nhwc_maps(arch, monkeypatch):
    """SR3: every Block; guided: every ResBlock's in_layers norm and the
    final out norm. Each K1 input is a contiguous NHWC map, in a
    train-mode forward with dropout and its backward."""
    calls = []
    for mod in (unet_fastdiffsr, unet_guided):
        monkeypatch.setattr(mod, "gn_swish_custom", _recording(calls))
    _, tree = _flax(arch)
    net = _port(arch, tree, dropout=0.3).train()
    out = net(torch.randn(2, SIZE, SIZE, 6), torch.tensor([4.0, 9.0]),
              generator=torch.Generator().manual_seed(0))
    out.square().mean().backward()
    if arch == "sr3":
        want = sum(isinstance(m, unet_fastdiffsr.Block)
                   for m in net.modules())
    else:
        want = sum(isinstance(m, GuidedResBlock) for m in net.modules()) + 1
    assert len(calls) == want and all(calls)


# variant -> (arch, level the denoiser sees)
VARIANTS = {"ddpm": "sr3", "tesr": "sr3", "gdp": "guided"}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_training_loss_and_grads_match_jax(variant, monkeypatch):
    """One training loss per variant on its own UNet, with the noise and
    the noise level injected (JAX's draws patched), dropout off. Loss
    atol 1e-5 of max(1, loss); each gradient leaf within 2e-4 of its max
    |g| plus 1e-6 of the largest gradient of the net (a leaf whose true
    gradient is 0, such as a conv bias ahead of a GroupNorm with one
    channel per group, holds only rounding)."""
    arch = VARIANTS[variant]
    flax_net, tree = _flax(arch, seed=2)
    rng = np.random.default_rng(5)
    batch = {k: rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
             for k in ("HR", "SR")}
    noise = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    gamma = np.asarray([0.93, 0.41], np.float32)
    t = np.asarray([3, 37], np.int32)
    spec = JaxSpec.for_variant(variant)
    jeng = JaxEngine(spec, JaxBuffers.create(SCHED))
    jeng.sample_gammas = lambda key, b: (jnp.asarray(gamma), None)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(t))

    def jloss(params):
        return jeng.training_loss(
            lambda x, lvl: flax_net.apply({"params": params}, x, lvl,
                                          deterministic=True),
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    monkeypatch.undo()

    net = _port(arch, tree).train()
    eng = DiffusionEngine(DiffusionSpec.for_variant(variant),
                          ScheduleBuffers.create(SCHED, device="cpu"))
    draws = ({"gamma": torch.from_numpy(gamma)}
             if spec.conditioning == "continuous_gamma"
             else {"t": torch.from_numpy(t).long()})
    loss = eng.training_loss(lambda x, lvl: net(x, lvl),
                             {k: torch.from_numpy(v)
                              for k, v in batch.items()},
                             None, noise=torch.from_numpy(noise), **draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0,
                               atol=1e-5 * max(1.0, float(want_loss)))
    want = flax_converter(variant)(jax.tree_util.tree_map(np.asarray,
                                                          want_grads))
    gmax = max(v.abs().max().item() for v in want.values())
    for name, p in net.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=2e-4 * np.abs(w).max() + 1e-6 * gmax,
                                   err_msg=name)


def test_use_checkpoint_gradients_equal_under_dropout():
    """Train mode, dropout 0.3, the same generator seed: the gradients
    with ``use_checkpoint`` (each ResBlock recomputed in the backward)
    equal those without it, because the dropout masks are drawn outside
    the checkpointed part; and dropout does change them."""
    _, tree = _flax("guided")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, SIZE, SIZE, 6)).astype(np.float32))
    lvl = torch.tensor([4.0, 30.0])

    def grads(use_checkpoint, seed=7, train=True):
        net = _port("guided", tree, dropout=0.3,
                    use_checkpoint=use_checkpoint).train(train)
        out = net(x, lvl, generator=torch.Generator().manual_seed(seed))
        out.square().mean().backward()
        return {k: p.grad.clone() for k, p in net.named_parameters()}

    plain, ckpt = grads(False), grads(True)
    for k, g in plain.items():
        torch.testing.assert_close(ckpt[k], g, rtol=0,
                                   atol=1e-6 * g.abs().max().item() + 1e-12,
                                   msg=k)
    other = grads(False, seed=8)
    assert any((other[k] - g).abs().max() > 1e-4 * g.abs().max()
               for k, g in plain.items())


def test_chip_smoke_reference_norm_covers_every_k1_site():
    """The on-card comparison arm swaps K1 for gn_swish_reference in the
    FastDiffSR/SR3 Block and in the guided UNet, and restores both."""
    import chip_smoke
    from fastdiffsr_tpu_torch.ops.groupnorm import gn_swish_reference
    with chip_smoke.reference_norm():
        assert unet_fastdiffsr.gn_swish_custom is gn_swish_reference
        assert unet_guided.gn_swish_custom is gn_swish_reference
    assert unet_fastdiffsr.gn_swish_custom is gn_swish_custom
    assert unet_guided.gn_swish_custom is gn_swish_custom


def test_chip_smoke_counts_evals_per_image():
    """The UNet evals per image that the smoke's launch counts assume:
    T for the ancestral sampler, the subsequence's length for the others."""
    import chip_smoke

    def cfg(T, **diffusion):
        return {"model": {"beta_schedule": {"val": {"n_timestep": T}},
                          "diffusion": diffusion}}

    assert chip_smoke.evals_per_image(cfg(1000)) == 1000
    assert chip_smoke.evals_per_image(cfg(1000, sampler="ddim",
                                          ddim_steps=50)) == 50
    assert chip_smoke.evals_per_image(cfg(20, sampler="dpm",
                                          ddim_steps=10)) == 10
    assert chip_smoke.evals_per_image(cfg(20, sampler="dpm")) == 20
