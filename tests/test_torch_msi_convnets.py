"""HSENet, TransENet, NDSRGAN (generator and discriminator) and the VGG
feature extractor of the port against the JAX package's, at the
``--tiny`` widths of JAX ``msi/main.py``, as ``test_torch_msi_models.py``
does for the transformers (randomised Flax leaves, both converters, the
reference layout); forwards within 1e-4 * max(1, max|y|). Also the
bilinear x2 down/up of HSENet against ``jax.image.resize(...,
antialias=False)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastdiffsr_tpu.models import vgg_feat as jvgg
from fastdiffsr_tpu.msi.hsenet import HSENet as JaxHSENet
from fastdiffsr_tpu.msi.hsenet import _bilinear as jax_bilinear
from fastdiffsr_tpu.msi.ndsrgan import DRRDBNet as JaxDRRDBNet
from fastdiffsr_tpu.msi.ndsrgan import Discriminator as JaxDiscriminator
from fastdiffsr_tpu.msi.transenet import TransENet as JaxTransENet
from fastdiffsr_tpu_torch.models import convert, vgg_feat
from fastdiffsr_tpu_torch.msi.hsenet import HSENet
from fastdiffsr_tpu_torch.msi.ndsrgan import DRRDBNet, Discriminator
from fastdiffsr_tpu_torch.msi.transenet import TransENet
from tests.test_torch_msi_models import (TOL, _img, check_arch, flax_init,
                                         randomize_tree)

torch.set_num_threads(2)


@pytest.mark.parametrize("hw", [(12, 20), (10, 14), (7, 9)])
def test_bilinear_half_and_back_matches_jax(hw):
    """F.interpolate bilinear (align_corners=False) is jax.image.resize
    bilinear without antialias, down to (h//2, w//2) and back, also off
    a neat grid (10x14 -> 5x7, odd 7x9 -> 3x4)."""
    h, w = hw
    x = np.random.default_rng(h).standard_normal((2, h, w, 5)).astype(
        np.float32)
    down_j = jax_bilinear(jnp.asarray(x), (h // 2, w // 2))
    up_j = np.asarray(jax_bilinear(down_j, (h, w)))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    down = F.interpolate(t, size=(h // 2, w // 2), mode="bilinear",
                         align_corners=False)
    up = F.interpolate(down, size=(h, w), mode="bilinear",
                       align_corners=False)
    np.testing.assert_allclose(down.permute(0, 2, 3, 1).numpy(),
                               np.asarray(down_j), atol=1e-6)
    np.testing.assert_allclose(up.permute(0, 2, 3, 1).numpy(), up_j,
                               atol=1e-6)


def test_hsenet_matches_jax():
    """Tiny HSENet (n_feats 8, one BasicModule) at 12x20 and 10x14 (even,
    not powers of two: the half-scale branch runs at 6x10 and 5x7) and an
    odd 9x7, x2, and 12x20 at x3."""
    rng = np.random.default_rng(1)
    inputs = [_img(rng, 12, 20), _img(rng, 10, 14, 2), _img(rng, 9, 7)]
    check_arch(JaxHSENet(scale=2, n_feats=8, n_basic_modules=1),
               HSENet(scale=2, n_feats=8, n_basic_modules=1), "hsenet",
               inputs)
    check_arch(JaxHSENet(scale=3, n_feats=8, n_basic_modules=1),
               HSENet(scale=3, n_feats=8, n_basic_modules=1), "hsenet",
               inputs[:1], seed=3)


def test_transenet_matches_jax():
    """Tiny TransENet (n_feats 8, encoder and decoder depth 1; dim 512,
    6 heads of 32) at 16x24 (2x3 patches of 8) and batch 2 of 8x8, x2."""
    rng = np.random.default_rng(2)
    kw = dict(scale=2, n_feats=8, en_depth=1, de_depth=1)
    check_arch(JaxTransENet(**kw), TransENet(**kw), "transenet",
               [_img(rng, 16, 24), _img(rng, 8, 8, 2)])


@pytest.mark.parametrize("scale", [4, 3])
def test_ndsrgan_matches_jax(scale):
    """Tiny DRRDBNet (nf 8, nc 4, 2 DCRDBs) at 10x13, two nearest x2
    stages (x4) or one x3."""
    rng = np.random.default_rng(scale)
    kw = dict(scale=scale, nf=8, nc=4, n_blocks=2)
    check_arch(JaxDRRDBNet(**kw), DRRDBNet(**kw), "ndsrgan",
               [_img(rng, 10, 13)], seed=scale)


def test_ndsrgan_refuses_mixed_scales():
    with pytest.raises(ValueError, match="upscale_factor=6"):
        DRRDBNet(scale=6)


def test_discriminator_matches_jax():
    """The GroupNorm patch discriminator at 32x40 (a 2x3 logit map)."""
    x = _img(np.random.default_rng(7), 32, 40, 2)
    jnet = JaxDiscriminator()
    params = randomize_tree(flax_init(jnet, jnp.asarray(x)), 7)
    net = Discriminator()
    net.load_state_dict(convert.flax_converter("ndsrgan_discriminator")(
        params))
    want = np.asarray(jax.jit(jnet.apply)({"params": params},
                                          jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 3, 1)
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())


def _vgg_pack(seed, use_bn):
    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for i, (kind, c) in enumerate(vgg_feat.layer_table(use_bn)):
        if kind == "conv":
            params[f"conv{i}_w"] = (rng.standard_normal((3, 3, cin, c))
                                    * np.sqrt(2.0 / (9 * cin))).astype(
                                        np.float32)
            params[f"conv{i}_b"] = 0.01 * rng.standard_normal(c).astype(
                np.float32)
            cin = c
        elif kind == "bn":
            for k, v in (("scale", 1 + 0.1 * rng.standard_normal(c)),
                         ("bias", 0.1 * rng.standard_normal(c)),
                         ("mean", 0.1 * rng.standard_normal(c)),
                         ("var", rng.uniform(0.5, 1.5, c))):
                params[f"bn{i}_{k}"] = v.astype(np.float32)
    return params


@pytest.mark.parametrize("layer,use_bn,norm", [(11, False, False),
                                               (34, False, True),
                                               (20, True, True)])
def test_vgg_features_match_jax(layer, use_bn, norm):
    """VGG19 ``features[:layer + 1]`` (with BatchNorm, input norm) on a
    random pack; (11, no BN, no norm) is ``msi_feature_extractor``."""
    assert vgg_feat.layer_table(use_bn) == jvgg.layer_table(use_bn)
    pack = _vgg_pack(layer, use_bn)
    x = _img(np.random.default_rng(layer), 32, 32, 2)
    want = np.asarray(jvgg.VGGFeatureExtractor(
        pack, feature_layer=layer, use_bn=use_bn, use_input_norm=norm)(
            jnp.asarray(x)))
    net = (vgg_feat.msi_feature_extractor(pack) if layer == 11 else
           vgg_feat.VGGFeatureExtractor(pack, feature_layer=layer,
                                        use_bn=use_bn, use_input_norm=norm))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())


def test_vgg_pack_is_gated(tmp_path, monkeypatch):
    """Without a pack ``load_default`` raises; with one it loads it."""
    monkeypatch.setenv("FASTDIFFSR_TPU_VGG", str(tmp_path / "none.npz"))
    with pytest.raises(FileNotFoundError, match="VGG19 weight pack"):
        vgg_feat.load_default()
    np.savez(tmp_path / "vgg.npz", **_vgg_pack(0, False))
    monkeypatch.setenv("FASTDIFFSR_TPU_VGG", str(tmp_path / "vgg.npz"))
    net = vgg_feat.load_default(feature_layer=11, use_input_norm=False)
    assert len(net.features) == 12
