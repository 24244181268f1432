"""EDiffSR's denoisers in the port (``models/nafnet.py``,
``models/cond_unet.py``) against the JAX package's, with the same
weights carried across by the converters, at 10x13 inputs (the padders
of both nets act). Tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiffsr_tpu.models.cond_unet import ConditionalUNet as JaxCondUNet
from fastdiffsr_tpu.models.convert import torch_nafnet_to_flax
from fastdiffsr_tpu.models.nafnet import ConditionalNAFNet as JaxNAFNet
from fastdiffsr_tpu_torch.models.cond_unet import ConditionalUNet
from fastdiffsr_tpu_torch.models.convert import (
    flax_cond_unet_params_to_torch, flax_nafnet_params_to_torch)
from fastdiffsr_tpu_torch.models.nafnet import ConditionalNAFNet
from fastdiffsr_tpu_torch.models.unet_fastdiffsr import init_params

torch.set_num_threads(2)

NAF = dict(width=16, enc_blk_nums=(2, 1), middle_blk_num=1,
           dec_blk_nums=(1, 1))


def _inputs(seed=0, h=10, w=13):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32),
            rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32),
            np.array([3.0, 77.0], np.float32))


def _randomized(net, seed):
    """Flax-style init, then every bias, LayerNorm scale and the
    beta/gamma residual scales (zero at init, which would make every
    NAFBlock the identity) drawn around their init values."""
    init_params(net, seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            z = torch.randn(p.shape, generator=g)
            if name.endswith(".g"):
                p.copy_(1.0 + 0.1 * z)
            elif name.endswith(("bias", "beta", "gamma")):
                p.copy_(0.2 * z)
    return net.eval()


def _numpy_sd(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def _port(net, x, c, t):
    with torch.no_grad():
        return net(torch.from_numpy(x), torch.from_numpy(c),
                   torch.from_numpy(t)).numpy()


@pytest.mark.parametrize("up_mode", ["", "tconv"])
def test_nafnet_matches_jax(up_mode):
    """A port NAFNet's reference-layout state dict through the JAX
    package's ``torch_nafnet_to_flax`` gives a tree of the Flax init's
    exact structure and shapes, and the JAX forward of it equals the
    port's within 1e-4 absolute (inputs in [-1, 1]); the port's
    converter inverts it exactly."""
    x, c, t = _inputs()
    net = _randomized(ConditionalNAFNet(**NAF, up_mode=up_mode), 1)
    sd = _numpy_sd(net)
    params = torch_nafnet_to_flax(sd)
    jnet = JaxNAFNet(**NAF, up_mode=up_mode)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, c, t)
    assert (jax.tree_util.tree_map(lambda a: a.shape, shapes["params"])
            == jax.tree_util.tree_map(np.shape, params))
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, x, c, t))
    got = _port(net, x, c, t)
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() <= 1e-4
    back = flax_nafnet_params_to_torch(params)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k])


def test_nafnet_up_modes_agree():
    """'' (1x1 conv + PixelShuffle) and 'tconv' (one stride-2 transposed
    conv) are one function of the same weights: within 1e-5."""
    x, c, t = _inputs(1, 16, 16)
    a = _randomized(ConditionalNAFNet(**NAF, up_mode=""), 2)
    b = ConditionalNAFNet(**NAF, up_mode="tconv").eval()
    b.load_state_dict(a.state_dict(), strict=True)
    np.testing.assert_allclose(_port(a, x, c, t), _port(b, x, c, t),
                               atol=1e-5)


def test_nafnet_bf16_matches_jax():
    """dtype bfloat16 on both sides (float32 parameters, bf16 convs and
    linears, float32 output): within 0.05 * max|y|, about six bf16 steps
    through the nine blocks of this net."""
    x, c, t = _inputs(2)
    net = _randomized(ConditionalNAFNet(**NAF, dtype=torch.bfloat16), 3)
    params = torch_nafnet_to_flax(_numpy_sd(net))
    jnet = JaxNAFNet(**NAF, dtype=jnp.bfloat16, up_mode="tconv")
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, x, c, t))
    net.up_mode = "tconv"
    got = _port(net, x, c, t)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_cond_unet_matches_jax():
    """ConditionalUNet (nf 8, depth 2; reflect padder 10x13 -> 12x16): a
    random Flax tree of the init's structure through
    ``flax_cond_unet_params_to_torch`` loads strictly and the forward
    equals JAX's within 1e-4 absolute; the port's state dict read back
    by the reference-name converter of tests/test_cond_unet.py gives the
    same tree."""
    from tests.test_cond_unet import _convert

    x, c, t = _inputs(3)
    jnet = JaxCondUNet(nf=8, depth=2)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, c, t)
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(np.prod(s.shape[:-1]) or 1)).astype(np.float32),
        shapes["params"])
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, x, c, t))
    net = ConditionalUNet(nf=8, depth=2).eval()
    net.load_state_dict(flax_cond_unet_params_to_torch(params), strict=True)
    got = _port(net, x, c, t)
    assert got.shape == x.shape
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())
    again = _convert(_numpy_sd(net), depth=2)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(again))
    for path, leaf in flat:
        node = again
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(node), leaf)


@pytest.mark.parametrize("kw", [{"dw_mode": "shift"}, {"fold_mode": "enc"},
                                {"fold_mode": "all"}])
def test_nafnet_tpu_layout_modes_raise(kw):
    """The layout modes (once refused): ``dw_mode='shift'`` and
    ``fold_mode='enc'|'all'`` against the JAX NAFNet in the same mode on
    the same random tree, within 1e-4 absolute as
    test_nafnet_matches_jax, and against the port's literal form within
    1e-5; the state dict is the literal one."""
    x, c, t = _inputs(7)
    lit = _randomized(ConditionalNAFNet(**NAF, up_mode="tconv"), 8)
    net = ConditionalNAFNet(**NAF, up_mode="tconv", **kw).eval()
    net.load_state_dict(lit.state_dict(), strict=True)
    jnet = JaxNAFNet(**NAF, up_mode="tconv", **kw)
    params = torch_nafnet_to_flax(_numpy_sd(lit))
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, x, c, t))
    got = _port(net, x, c, t)
    assert got.shape == x.shape
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_allclose(got, _port(lit, x, c, t), atol=1e-5)
    with pytest.raises(ValueError, match="bad"):
        ConditionalNAFNet(**NAF, **{k: "bad" for k in kw})


@pytest.mark.parametrize("fold_mode", ["enc", "all"])
def test_nafnet_fold_skips_odd_batch(fold_mode, monkeypatch):
    """At an odd batch neither net folds (JAX folds at even batch only):
    the port calls no fold2 and equals its literal form bit for bit and
    the JAX net in the same mode within 1e-4."""
    from fastdiffsr_tpu_torch.models import nafnet

    calls = []
    monkeypatch.setattr(nafnet, "fold2",
                        lambda x: calls.append(x.shape) or x)
    rng = np.random.default_rng(9)
    x, c = (rng.uniform(-1, 1, (3, 10, 13, 3)).astype(np.float32)
            for _ in range(2))
    t = np.array([3.0, 40.0, 77.0], np.float32)
    lit = _randomized(ConditionalNAFNet(**NAF, up_mode="tconv"), 10)
    net = ConditionalNAFNet(**NAF, up_mode="tconv",
                            fold_mode=fold_mode).eval()
    net.load_state_dict(lit.state_dict(), strict=True)
    got = _port(net, x, c, t)
    assert calls == []
    np.testing.assert_array_equal(got, _port(lit, x, c, t))
    jnet = JaxNAFNet(**NAF, up_mode="tconv", fold_mode=fold_mode)
    want = np.asarray(jax.jit(jnet.apply)(
        {"params": torch_nafnet_to_flax(_numpy_sd(lit))}, x, c, t))
    assert np.abs(got - want).max() <= 1e-4


def test_cond_unet_upsample_modes_raise():
    """The tconv and d2s2 Upsample forms (once refused) against the JAX
    ConditionalUNet in the same form, same random tree: within 1e-4 of
    max(1, max|y|), as test_cond_unet_matches_jax; an unknown form
    raises."""
    x, c, t = _inputs(5)
    rng = np.random.default_rng(6)
    shapes = jax.eval_shape(JaxCondUNet(nf=8, depth=2).init,
                            jax.random.PRNGKey(0), x, c, t)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(np.prod(s.shape[:-1]) or 1)).astype(np.float32),
        shapes["params"])
    for mode in ("tconv", "d2s2"):
        want = np.asarray(jax.jit(JaxCondUNet(
            nf=8, depth=2, upsample_mode=mode).apply)({"params": params},
                                                      x, c, t))
        net = ConditionalUNet(nf=8, depth=2, upsample_mode=mode).eval()
        net.load_state_dict(flax_cond_unet_params_to_torch(params),
                            strict=True)
        got = _port(net, x, c, t)
        assert got.shape == x.shape
        assert (np.abs(got - want).max()
                <= 1e-4 * max(1.0, np.abs(want).max()))
    with pytest.raises(ValueError, match="upsample_mode='bad'"):
        ConditionalUNet(nf=8, depth=2, upsample_mode="bad")


def test_cond_unet_builder_reads_the_upsample_form(monkeypatch):
    """``cond_unet_from_config`` (EDiffSR's builder) takes the Upsample
    form from FASTDIFFSR_TPU_UPSAMPLE with JAX's default, tconv, as JAX's
    ediffsr/train.py does; the constructor defaults to the literal form."""
    from fastdiffsr_tpu_torch.models.cond_unet import cond_unet_from_config
    monkeypatch.delenv("FASTDIFFSR_TPU_UPSAMPLE", raising=False)
    setting = {"nf": 8, "depth": 2}
    assert cond_unet_from_config(setting, device="cpu").upsample_mode == \
        "tconv"
    monkeypatch.setenv("FASTDIFFSR_TPU_UPSAMPLE", "d2s2")
    assert cond_unet_from_config(setting, device="cpu").upsample_mode == \
        "d2s2"
    monkeypatch.setenv("FASTDIFFSR_TPU_UPSAMPLE", "dense")
    assert cond_unet_from_config(setting, device="cpu").upsample_mode == ""
    assert ConditionalUNet(nf=8, depth=2).upsample_mode == ""


def test_convert_cli_nafnet(tmp_path):
    """``python -m fastdiffsr_tpu_torch.models.convert --arch nafnet``
    writes a reference NAFNet state dict (here a port one) that loads
    strictly; a key outside the NAFNet raises."""
    from fastdiffsr_tpu_torch.models.convert import main

    net = _randomized(ConditionalNAFNet(**NAF), 5)
    torch.save(net.state_dict(), tmp_path / "G.pth")
    out = main(["--arch", "nafnet", str(tmp_path / "G.pth"),
                str(tmp_path / "naf.pt")])
    fresh = ConditionalNAFNet(**NAF)
    fresh.load_state_dict(torch.load(out, weights_only=True), strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, net.state_dict()[k])
    bad = dict(net.state_dict(), **{"mystery.weight": torch.zeros(1)})
    torch.save(bad, tmp_path / "bad.pth")
    with pytest.raises(KeyError, match="mystery"):
        main(["--arch", "nafnet", str(tmp_path / "bad.pth"),
              str(tmp_path / "x.pt")])
