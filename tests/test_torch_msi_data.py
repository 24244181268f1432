"""The MSI data path of the port (``msi/data.py``, ``msi/degradation.py``)
against the JAX package's: the numpy port of PIL's uint8 bicubic resize
is bit-equal to PIL; the dataset, the loader's batches and flips, the
noise options and the SRMD degradation give JAX's arrays from the same
seeds."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fastdiffsr_tpu.msi import data as jdata
from fastdiffsr_tpu.msi import degradation as jdeg
from fastdiffsr_tpu_torch.msi import data, degradation

torch.set_num_threads(2)


@pytest.mark.parametrize("scale", [2, 3, 4, 8])
def test_pil_bicubic_is_bit_equal(scale):
    """Down by ``scale`` and back up, at even and odd sizes (an output
    of 1 pixel too), on random uint8 tiles."""
    rng = np.random.default_rng(scale)
    for h, w in ((32, 32), (33, 47), (17, 9), (64, 40), (8, 23)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for ow, oh in ((max(w // scale, 1), max(h // scale, 1)),
                       (w * scale, h * scale), (w, max(h // scale, 1))):
            want = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                          Image.BICUBIC))
            got = data.pil_bicubic_resize(img, ow, oh)
            np.testing.assert_array_equal(got, want, err_msg=str(
                (h, w, ow, oh)))


def _write_tree(root, rng, classes=("forest", "river"), n=3, hw=(36, 41)):
    for cls in classes:
        d = root / cls
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)
                            ).save(d / f"{cls}{i}.png")
    Image.fromarray(rng.integers(0, 256, (30, 30, 3), dtype=np.uint8)
                    ).save(root / "top.png")


def _same_sample(a, b):
    assert set(a) == set(b)
    for k in ("LR", "HR", "Bicubic"):
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["path"] == b["path"] and a["class"] == b["class"]
    assert int(a["Index"]) == int(b["Index"])


@pytest.mark.parametrize("crop,scale", [(32, 4), (None, 3)])
def test_dataset_matches_jax(tmp_path, crop, scale):
    """Files in JAX's order (top-level images and class subfolders), the
    centre crop, the scale-multiple cut, LR/HR/Bicubic bit for bit and
    the class from the parent folder."""
    _write_tree(tmp_path, np.random.default_rng(0))
    ours = data.RGBSRDataset([str(tmp_path)], crop, scale, split="val")
    theirs = jdata.RGBSRDataset([str(tmp_path)], crop, scale, split="val")
    assert ours.files == theirs.files == data.list_images([str(tmp_path)])
    assert len(ours) == len(theirs) == 7
    for i in range(len(ours)):
        _same_sample(ours[i], theirs[i])


def test_loader_matches_jax(tmp_path):
    """Two epochs of shuffled batches of 2: the same order and the same
    per-batch flips (default_rng(seed + epoch))."""
    _write_tree(tmp_path, np.random.default_rng(1))
    ours = data.MSIDataLoader(data.RGBSRDataset([str(tmp_path)], 24, 2),
                              batch_size=2, shuffle=True, seed=5)
    theirs = jdata.MSIDataLoader(jdata.RGBSRDataset([str(tmp_path)], 24, 2),
                                 batch_size=2, shuffle=True, seed=5)
    flips = 0
    for _ in range(2):
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == 3      # 7 images, drop_last
        for x, y in zip(a, b):
            for k in ("path", "class"):
                assert list(x[k]) == list(y[k])
            for k in ("LR", "HR", "Bicubic", "Index"):
                np.testing.assert_array_equal(x[k], y[k])
            unflipped = np.stack([data.lr_hr_bicubic(
                data.load_rgb(p), 2, 24)[1] for p in x["path"]])
            flips += not np.array_equal(unflipped, x["HR"])
    assert 0 < flips < 6


@pytest.mark.parametrize("noise", [("Gaussain", 12.0), ("Poisson", 0.05)])
def test_noise_options_match_jax(tmp_path, noise):
    """The test sets' LR noise (the reference's spellings) draws what JAX
    draws from the dataset's seed, read after read."""
    _write_tree(tmp_path, np.random.default_rng(2))
    ours = data.RGBSRDataset([str(tmp_path)], 32, 4, split="val",
                             noise=noise, seed=9)
    theirs = jdata.RGBSRDataset([str(tmp_path)], 32, 4, split="val",
                                noise=noise, seed=9)
    clean = data.RGBSRDataset([str(tmp_path)], 32, 4, split="val")
    for i in range(3):      # each read draws: read each sample once
        sample = ours[i]
        _same_sample(sample, theirs[i])
        assert not np.array_equal(sample["LR"], clean[i]["LR"])
    with pytest.raises(ValueError, match="unknown noise type"):
        data.RGBSRDataset([str(tmp_path)], 32, 4, noise=("Gaussian", 1))[0]


def test_tiff_needs_pil(tmp_path, monkeypatch):
    """Non-PNG images go through PIL; without it the error names the
    format."""
    img = np.random.default_rng(3).integers(0, 256, (9, 7, 3), np.uint8)
    path = tmp_path / "a.tif"
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(data.load_rgb(str(path)), img)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(RuntimeError, match=r"\.tif images needs PIL"):
        data.load_rgb(str(path))


@pytest.mark.parametrize("l", [21, 8])
def test_batch_blur_matches_jax(l):
    """Per-image depthwise blur, reflect-padded (odd and even kernels)."""
    rng = np.random.default_rng(l)
    x = rng.uniform(0, 1, (3, 24, 20, 3)).astype(np.float32)
    k = degradation.random_batch_kernel(rng, 3, l=l, rate_iso=0.5)
    want = np.asarray(jdeg.batch_blur(jnp.asarray(x), jnp.asarray(k)))
    got = degradation.batch_blur(torch.from_numpy(x),
                                 torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("random,noise", [(True, True), (False, True),
                                          (True, False)])
def test_srmd_matches_jax(random, noise):
    """The same kernels, noise levels and PCA basis from one seed, and
    the same LR and code from the image path given the same LR noise;
    without noise ``__call__`` itself agrees (no draw reaches the
    image)."""
    kw = dict(scale=4, random=random, noise=noise, rate_iso=0.5, seed=3)
    ours, theirs = degradation.SRMDPreprocessing(**kw), \
        jdeg.SRMDPreprocessing(**kw)
    np.testing.assert_array_equal(ours.pca_weight.numpy(),
                                  np.asarray(theirs.pca_weight))
    hr = np.random.default_rng(4).uniform(0, 1, (2, 32, 24, 3)).astype(
        np.float32)
    for _ in range(2):
        (k1, n1), (k2, n2) = ours.draw(2), theirs.draw(2)
        np.testing.assert_array_equal(k1, k2)
        np.testing.assert_array_equal(n1, n2)
    eps = np.random.default_rng(5).standard_normal((2, 8, 6, 3)).astype(
        np.float32)
    lr, code = ours.apply(torch.from_numpy(hr), torch.from_numpy(k1),
                          torch.from_numpy(n1), torch.from_numpy(eps))
    jlr, jcode = theirs._device(jnp.asarray(hr), jnp.asarray(k2),
                                jnp.asarray(n2), jnp.asarray(eps))
    np.testing.assert_allclose(lr.numpy(), np.asarray(jlr), atol=1e-5)
    np.testing.assert_allclose(code.numpy(), np.asarray(jcode), atol=1e-6)
    assert code.shape == (2, 15 + noise)
    if not noise:
        (lr, code, k), (jlr, jcode, jk) = (
            ours(torch.from_numpy(hr), return_kernel=True),
            theirs(jnp.asarray(hr), return_kernel=True))
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_allclose(lr.numpy(), np.asarray(jlr), atol=1e-5)


def test_noise_injectors_and_noising():
    """The uint8 injectors take JAX's draws; gaussian_noising clamps."""
    img = np.random.default_rng(6).integers(0, 256, (12, 10, 3), np.uint8)
    for fn, kw in ((degradation.add_gaussian_noise, dict(amplitude=20.0)),
                   (degradation.add_salt_pepper_noise, dict(density=0.2))):
        got = fn(img, rng=np.random.default_rng(7), **kw)
        want = getattr(jdeg, fn.__name__)(img, rng=np.random.default_rng(7),
                                          **kw)
        np.testing.assert_array_equal(got, want)
    x = np.random.default_rng(8).uniform(0, 1, (2, 4, 4, 3)).astype(
        np.float32)
    sig = np.array([[0.5], [0.0]], np.float32)
    eps = np.random.default_rng(9).standard_normal(x.shape).astype(
        np.float32)
    got = degradation.gaussian_noising(torch.from_numpy(x),
                                       torch.from_numpy(sig),
                                       torch.from_numpy(eps)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdeg.gaussian_noising(
        jnp.asarray(x), jnp.asarray(sig), jnp.asarray(eps))), atol=1e-7)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_create_downsampling_dataset_matches_jax(tmp_path):
    """Blur-degraded LR PNGs per class folder, named
    ``<name>_downsample.png``, as the JAX package writes them (uint8 after
    rounding: at most one step apart where the float sums differ)."""
    src = tmp_path / "src"
    _write_tree(src, np.random.default_rng(10), n=2, hw=(34, 30))
    n = degradation.create_downsampling_dataset(str(src), str(tmp_path / "a"),
                                                4, seed=2)
    assert n == jdeg.create_downsampling_dataset(str(src),
                                                 str(tmp_path / "b"), 4,
                                                 seed=2) == 5
    for root, _, files in os.walk(tmp_path / "b"):
        for f in files:
            want = np.asarray(Image.open(os.path.join(root, f)))
            got = data.load_rgb(os.path.join(
                str(tmp_path / "a"), os.path.relpath(root, tmp_path / "b"),
                f))
            assert got.shape == want.shape
            assert np.abs(got.astype(int) - want).max() <= 1
