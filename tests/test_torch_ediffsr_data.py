"""EDiffSR's data path in the port (``ediffsr/deg.py``, ``imgproc.py``,
``data.py``) against the JAX package's: the bicubic conditioning
upsample against ``jax.image.resize``, the host image utilities, every
dataset mode image for image from the same seed, the loaders, and the
PIL-free bilinear resize against PIL. Tolerances are stated per test."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fastdiffsr_tpu.ediffsr import data as jdata
from fastdiffsr_tpu.ediffsr import deg as jdeg
from fastdiffsr_tpu.ediffsr import imgproc as jimg
from fastdiffsr_tpu_torch.ediffsr import data as tdata
from fastdiffsr_tpu_torch.ediffsr import deg as tdeg
from fastdiffsr_tpu_torch.ediffsr import imgproc as timg
from fastdiffsr_tpu_torch.metrics import save_img

torch.set_num_threads(2)


@pytest.mark.parametrize("scale", [2, 4, 8])
def test_upscale_matches_jax_resize(scale):
    """deg.upscale (Keys a=-0.5, weights renormalised at the borders)
    against jax.image.resize bicubic: within 1e-6."""
    x = np.random.default_rng(scale).uniform(0, 1, (2, 8, 7, 3)).astype(
        np.float32)
    want = np.asarray(jdeg.upscale(jnp.asarray(x), scale))
    got = tdeg.upscale(torch.from_numpy(x), scale).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


def test_resize_bicubic_downscale_matches_jax():
    """The antialiased (widened-kernel) branch, 16x12 -> 5x9: within
    1e-6."""
    x = np.random.default_rng(0).uniform(0, 1, (1, 16, 12, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 5, 9, 3),
                                       method="bicubic"))
    got = tdeg.resize_bicubic(torch.from_numpy(x), 5, 9).numpy()
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("scale", [0.25, 0.5, 1.0 / 3.0, 2.0])
def test_imresize_matches_jax(scale):
    """MATLAB imresize (the on-the-fly LR degradation): equal."""
    img = np.random.default_rng(1).uniform(0, 1, (24, 36, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(timg.imresize(img, scale),
                                  jimg.imresize(img, scale))


def test_colour_and_crop_utilities_match_jax():
    rng = np.random.default_rng(2)
    f = rng.uniform(0, 1, (8, 9, 3)).astype(np.float32)
    u = (f * 255).astype(np.uint8)
    for fn in ("rgb2ycbcr", "bgr2ycbcr"):
        for img in (f, u):
            for only_y in (True, False):
                np.testing.assert_array_equal(
                    getattr(timg, fn)(img.copy(), only_y),
                    getattr(jimg, fn)(img.copy(), only_y))
    np.testing.assert_array_equal(timg.ycbcr2rgb(f), jimg.ycbcr2rgb(f))
    for tar in ("gray", "y", "RGB"):
        for a, b in zip(timg.channel_convert(3, tar, [f]),
                        jimg.channel_convert(3, tar, [f])):
            np.testing.assert_array_equal(a, b)
    img = np.zeros((13, 18, 3), np.float32)
    assert timg.modcrop(img, 4).shape == (12, 16, 3)
    assert timg.modcrop(img[:, :, 0], 4).shape == (12, 16)


def test_augment_matches_jax():
    """The same three flip/rot draws from the same generator state."""
    rng = np.random.default_rng(3)
    imgs = [rng.uniform(0, 1, (6, 6, 3)).astype(np.float32)
            for _ in range(2)]
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(8):
        for a, b in zip(timg.augment(imgs, True, True, r1),
                        jimg.augment(imgs, True, True, r2)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("src,dst", [((20, 24), (16, 16)),
                                     ((17, 13), (32, 20)),
                                     ((33, 18), (20, 18))])
def test_bilinear_resize_matches_pil(src, dst):
    """The PIL-free _bilinear_resize against PIL's BILINEAR (what the JAX
    package calls) on a float image: within 1e-5."""
    img = np.random.default_rng(4).uniform(0, 1, src + (3,)).astype(
        np.float32)
    got = tdata._bilinear_resize(img, *dst)
    want = jdata._bilinear_resize(img, *dst)
    assert got.shape == want.shape == dst + (3,)
    assert np.abs(got - want).max() <= 1e-5


def _write(d, imgs):
    d.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(imgs):
        save_img(img, str(d / f"{i}.png"))
    return str(d)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """GT/LQ folders (4 images, GT 34x30 so modcrop and the on-the-fly
    resize act), a mask-free bokeh meta file."""
    root = tmp_path_factory.mktemp("ediffsr_data")
    rng = np.random.default_rng(5)
    gt = [rng.integers(0, 256, (34, 30, 3), dtype=np.uint8)
          for _ in range(4)]
    lq = [g[::4, ::4][:8, :7].copy() for g in gt]
    same = [rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)
            for _ in range(2)]
    meta = root / "meta.txt"
    meta.write_text("0, Canon50mmf1.8BS, Sony50mmf16.0BS, 3\n"
                    "1, Sony50mmf1.8BS, Canon50mmf16.0BS, 7\n")
    return {"GT": _write(root / "GT", gt), "LQ": _write(root / "LQ", lq),
            "BGT": _write(root / "BGT", same),
            "BLQ": _write(root / "BLQ", same[::-1]), "meta": str(meta)}


def _mode_opt(tree, mode, phase):
    base = {"mode": mode, "phase": phase, "scale": 4, "seed": 7,
            "use_flip": True, "use_rot": True}
    if mode in ("LQGT", "SteLQGT"):
        base.update(dataroot_GT=tree["GT"], dataroot_LQ=tree["LQ"])
    elif mode == "LQGT_onthefly":
        base.update(mode="LQGT", dataroot_GT=tree["GT"])
    elif mode == "GT":
        base.update(dataroot_GT=tree["GT"])
    elif mode in ("LQ", "SteLQ"):
        base.update(dataroot_LQ=tree["LQ"])
    else:
        base.update(scale=1, dataroot_GT=tree["BGT"],
                    dataroot_LQ=tree["BLQ"], dataroot_meta=tree["meta"])
    if phase == "train":
        base.update(GT_size=16 if mode[:5] != "Bokeh" else 8)
    elif mode == "LQGT":
        base.update(LR_size=4)          # the val center crop
    return base


@pytest.mark.parametrize("mode,phase", [
    ("LQGT", "train"), ("LQGT", "val"), ("LQGT_onthefly", "train"),
    ("LQGT_onthefly", "val"), ("GT", "train"), ("GT", "val"),
    ("LQ", "train"), ("LQ", "val"), ("SteLQGT", "train"), ("SteLQ", "val"),
    ("BokehLQGT", "train"), ("BokehLQ", "val")])
def test_dataset_modes_match_jax(tree, mode, phase):
    """Every mode, both phases, from the same seed: the same crops,
    flips and values image for image, three passes over the set (the
    on-the-fly LR goes through the bilinear resize and MATLAB imresize:
    within 1e-5; the rest equal)."""
    opt = _mode_opt(tree, mode, phase)
    ours = tdata.create_ediffsr_dataset(copy.deepcopy(opt))
    theirs = jdata.create_ediffsr_dataset(copy.deepcopy(opt))
    assert len(ours) == len(theirs) > 0
    for _ in range(3):
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert set(a) == set(b)
            for k in a:
                if isinstance(a[k], np.ndarray) and a[k].ndim == 3:
                    assert a[k].shape == b[k].shape, k
                    np.testing.assert_allclose(a[k], b[k], atol=1e-5,
                                               rtol=0, err_msg=k)
                else:
                    assert a[k] == b[k], k


def test_loaders_match_jax(tree):
    """create_ediffsr_loaders: the same shuffled train batches over two
    epochs and the same val batches (manual_seed seeds both)."""
    opt = {"train": {"manual_seed": 3}, "datasets": {
        "train": dict(_mode_opt(tree, "LQGT", "train"), batch_size=2,
                      n_workers=1, seed=None),
        "val": dict(_mode_opt(tree, "LQGT", "val"), seed=None)}}
    ours = tdata.create_ediffsr_loaders(copy.deepcopy(opt))
    theirs = jdata.create_ediffsr_loaders(copy.deepcopy(opt))
    for split, epochs in (("train", 2), ("val", 1)):
        for _ in range(epochs):
            pairs = list(zip(ours[split], theirs[split]))
            assert len(pairs) == len(theirs[split]) > 0
            for a, b in pairs:
                for k in ("GT", "LQ"):
                    np.testing.assert_array_equal(a[k], b[k])


def test_lmdb_root_raises(tmp_path):
    opt = {"mode": "LQGT", "phase": "train", "scale": 4, "GT_size": 16,
           "dataroot_GT": str(tmp_path / "train_HR.lmdb"),
           "dataroot_LQ": str(tmp_path / "train_LR.lmdb")}
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tdata.create_ediffsr_dataset(opt)


def test_mask_to_and_add_noise_match_jax(tmp_path):
    """mask_to (nearest-resized keep masks, holes 1.0; a fixed id and one
    random id per image from the same numpy generator): equal to JAX's;
    add_noise's sigma > 1 means sigma / 255."""
    masks = tmp_path / "masks"
    masks.mkdir()
    rng = np.random.default_rng(6)
    for i in range(3):
        Image.fromarray(((rng.uniform(size=(12, 10, 3)) > 0.5) * 255)
                        .astype(np.uint8)).save(masks / f"{i:06d}.png")
    x = rng.uniform(0, 1, (2, 8, 7, 3)).astype(np.float32)
    for mask_id in (1, -1):
        want = np.asarray(jdeg.mask_to(jnp.asarray(x), str(masks), mask_id,
                                       n=3, rng=np.random.default_rng(0)))
        got = tdeg.mask_to(torch.from_numpy(x), str(masks), mask_id, n=3,
                           rng=np.random.default_rng(0)).numpy()
        np.testing.assert_array_equal(got, want)
    xt = torch.from_numpy(x)
    a = tdeg.add_noise(xt, 0.1, torch.Generator().manual_seed(0))
    b = tdeg.add_noise(xt, 25.5, torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
