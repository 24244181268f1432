"""The MSI transformers of the port (``msi/swinir.py``, ``msi/hat.py``)
against the JAX package's at the ``--tiny`` widths of JAX ``msi/main.py``:
every Flax leaf randomised, carried to the port by its Flax->torch
converter, and the port's state dict carried back by the JAX package's
``torch_<arch>_to_flax`` (the reference layout) to the very same tree.
Forwards agree within 1e-4 * max(1, max|y|). Also NHWC pixel shuffle,
and ``load_reference_msi_pth``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiffsr_tpu.models import convert as jconvert
from fastdiffsr_tpu.models.nafnet import pixel_shuffle as jax_pixel_shuffle
from fastdiffsr_tpu.msi.hat import HAT as JaxHAT
from fastdiffsr_tpu.msi.swinir import SwinIR as JaxSwinIR
from fastdiffsr_tpu_torch.models import convert
from fastdiffsr_tpu_torch.msi.hat import HAT
from fastdiffsr_tpu_torch.msi.swinir import SwinIR

torch.set_num_threads(2)

TOL = 1e-4


def randomize_tree(tree, seed):
    """Every leaf redrawn: kernels LeCun-scaled normal, biases 0.1 N,
    norm scales 1 + 0.1 N, bias tables 0.5 N."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        z = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return z / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * z
        if name == "relative_position_bias_table":
            return 0.5 * z
        return 0.1 * z
    return jax.tree_util.tree_map_with_path(
        lambda p, x: draw(p, x).astype(np.float32), tree)


def flax_init(net, x):
    return jax.jit(net.init)(jax.random.PRNGKey(0), x)["params"]


def numpy_sd(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def assert_trees_equal(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, u), (_, v) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v),
                                      err_msg=str(p))


def check_arch(jnet, net, arch, inputs, seed=0):
    """Randomised Flax leaves -> port (flax converter, strict load);
    port state dict -> JAX ``torch_<arch>_to_flax`` gives the same tree;
    the forwards agree on every input. Returns the max relative gap."""
    init = flax_init(jnet, jnp.asarray(inputs[0]))
    params = randomize_tree(init, seed)
    net.load_state_dict(convert.flax_converter(arch)(params))
    net.eval()
    back = getattr(jconvert, f"torch_{arch}_to_flax")(numpy_sd(net))
    assert_trees_equal(back, jax.tree_util.tree_map(np.asarray, params))
    apply = jax.jit(jnet.apply)
    worst = 0.0
    for x in inputs:
        want = np.asarray(apply({"params": back}, jnp.asarray(x)))
        with torch.no_grad():
            got = net(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        gap = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert gap <= TOL, (x.shape, gap)
        worst = max(worst, gap)
    return worst


def _img(rng, h, w, b=1):
    return rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("scale", [2, 3])
def test_swinir_matches_jax(scale):
    """Tiny SwinIR (JAX main.py --tiny: embed 24, depths (2, 2), heads
    (3, 3), window 4): 10x13 (reflect-padded to 12x16, block 1 shifted
    with the mask of 12x16), 3x5 (padded to 4x8: no shift, min <= window)
    and a batch of two 8x8 (a window multiple)."""
    rng = np.random.default_rng(scale)
    kw = dict(upscale=scale, embed_dim=24, depths=(2, 2), num_heads=(3, 3),
              window_size=4, mlp_ratio=2.0)
    check_arch(JaxSwinIR(**kw, drop_path_rate=0.0), SwinIR(**kw), "swinir",
               [_img(rng, 10, 13), _img(rng, 3, 5), _img(rng, 8, 8, 2)],
               seed=scale)


def test_hat_matches_jax():
    """Tiny HAT (embed 24, depths (2, 2), heads (2, 2), window 4,
    squeeze 4; OCAB windows of 6 over a zero pad of 1): 10x13 (padded,
    shifted blocks), 3x5 (no shift) and 8x8 at x2."""
    rng = np.random.default_rng(5)
    kw = dict(upscale=2, embed_dim=24, depths=(2, 2), num_heads=(2, 2),
              window_size=4, squeeze_factor=4, mlp_ratio=2.0)
    check_arch(JaxHAT(**kw), HAT(**kw), "hat",
               [_img(rng, 10, 13), _img(rng, 3, 5), _img(rng, 8, 8, 2)])


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_keeps_the_jax_channel_order(r):
    """nn.PixelShuffle between the NHWC permutes is JAX's NHWC
    ``pixel_shuffle`` (channel c*r^2 + i*r + j), exactly."""
    x = np.random.default_rng(r).standard_normal((2, 3, 5, 4 * r * r)
                                                  ).astype(np.float32)
    want = np.asarray(jax_pixel_shuffle(jnp.asarray(x), r))
    got = torch.nn.PixelShuffle(r)(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_load_reference_msi_pth(tmp_path):
    """A reference-style file (``module.`` prefix, the index buffers,
    shift masks and ``mean``) loads strictly into the port's SwinIR; a
    key of another arch is refused, naming it; ``convert --arch swinir``
    writes the same parameters."""
    net = SwinIR(upscale=2, embed_dim=12, depths=(2,), num_heads=(2,),
                 window_size=4)
    sd = net.state_dict()
    ref = {f"module.{k}": v for k, v in sd.items()}
    ref["module.mean"] = torch.zeros(1, 3, 1, 1)
    ref["module.layers.0.residual_group.blocks.0.attn."
        "relative_position_index"] = torch.zeros(16, 16, dtype=torch.long)
    ref["module.layers.0.residual_group.blocks.1.attn_mask"] = torch.zeros(
        4, 16, 16)
    path = tmp_path / "swinir.pth"
    torch.save(ref, path)
    got = convert.load_reference_msi_pth(str(path), "swinir")
    assert set(got) == set(sd)
    SwinIR(upscale=2, embed_dim=12, depths=(2,), num_heads=(2,),
           window_size=4).load_state_dict(got, strict=True)
    out = tmp_path / "out.pt"
    convert.main(["--arch", "swinir", str(path), str(out)])
    saved = torch.load(out, weights_only=True)
    assert all(torch.equal(saved[k], sd[k]) for k in sd)

    ref["module.body_modulist.0.head.0.0.weight"] = torch.zeros(1)
    torch.save(ref, path)
    with pytest.raises(KeyError, match="body_modulist"):
        convert.load_reference_msi_pth(str(path), "swinir")
    with pytest.raises(ValueError, match="unknown MSI arch"):
        convert.load_reference_msi_pth(str(path), "unet")
