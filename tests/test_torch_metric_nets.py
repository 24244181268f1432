"""The port's metric networks and metrics against the JAX package, on
the same synthetic weight packs (the real backbone weights are not
fetched): LPIPS-alex (``lpips_torch``) against ``LPIPSJax``, Inception
pool3 (``models/inception``) against JAX's with one module-scoped JAX
run, the resize to 299 on an upscale and a downscale, FID end to end
(``cli/fid``) against JAX's ``calc_fid``, ``ssim_skimage``, the PNG
reader and the validation panel. Tolerances: LPIPS 1e-5 absolute
(identical images exactly 0), pool3 1e-4 of max|f|, FID 1e-3
relative."""

import struct
import warnings
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdiffsr_tpu import metrics as JM
from fastdiffsr_tpu.cli import fid as jax_fid
from fastdiffsr_tpu.lpips_jax import LPIPSJax
from fastdiffsr_tpu.models.inception import InceptionFID as JaxInception
from fastdiffsr_tpu.models.inception import torch_inception_to_params
from fastdiffsr_tpu_torch import metrics as M
from fastdiffsr_tpu_torch.cli import fid
from fastdiffsr_tpu_torch.lpips_torch import (LPIPS, lpips_params_from_pack,
                                              random_pack)
from fastdiffsr_tpu_torch.models import inception
from tests.test_inception import TorchInceptionFID

torch.set_num_threads(2)


def _images(seed, n=2, size=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
            for _ in range(n)]


@pytest.fixture()
def lpips_env(tmp_path, monkeypatch):
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **random_pack(0))
    monkeypatch.setenv("FASTDIFFSR_TPU_LPIPS", str(path))
    monkeypatch.setattr(M, "_LPIPS", {})
    monkeypatch.setattr(M, "_LPIPS_WARNED", False)
    return path


def test_lpips_matches_jax(lpips_env):
    a, b = _images(1)
    want = LPIPSJax.load_default().distance(a, b)
    net = LPIPS.load_default(device="cpu")
    assert abs(net.distance(a, b) - want) <= 1e-5 and want > 0
    assert net.distance(a, a) == 0.0
    assert abs(M.calculate_lpips(a, b, device="cpu") - want) <= 1e-5


def test_lpips_params_from_pack_layout():
    pack = random_pack(0)
    p = lpips_params_from_pack(pack)
    w = pack["conv1_w"]
    assert p["conv1_w"].shape == (w.shape[3], w.shape[2], 5, 5)
    np.testing.assert_array_equal(p["conv1_w"][7, 3].numpy(),
                                  w[:, :, 3, 7])


def test_calculate_lpips_none_without_pack(tmp_path, monkeypatch):
    monkeypatch.setenv("FASTDIFFSR_TPU_LPIPS", str(tmp_path / "none.npz"))
    monkeypatch.setattr(M, "_LPIPS", {})
    monkeypatch.setattr(M, "_LPIPS_WARNED", False)
    a, b = _images(2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert M.calculate_lpips(a, b, device="cpu") is None
        assert M.calculate_lpips(a, b, device="cpu") is None
    assert [str(w.message) for w in caught
            if "LPIPS unavailable" in str(w.message)] != []
    assert len(caught) == 1


@pytest.fixture(scope="module")
def inception_pack(tmp_path_factory):
    """(pack path, params in the pack's layout) of a seeded Inception, its
    conv kernels at He scale (torch's default init, sqrt(6) times
    smaller, leaves pool3 almost blind to the input and every FID 0)."""
    params = {k: v * np.float32(np.sqrt(6.0)) if k.endswith(".conv.weight")
              else v for k, v in torch_inception_to_params(
                  TorchInceptionFID().eval().state_dict()).items()}
    path = tmp_path_factory.mktemp("inception") / "inception_fid.npz"
    np.savez(path, **params)
    return path, params


def test_pack_shapes_are_the_graphs(inception_pack):
    """``pack_shapes`` (which ``params_from_pack`` holds a pack to) lists
    what the torchvision layout holds; a short pack raises, naming the
    array."""
    _, params = inception_pack
    assert inception.pack_shapes() == {k: v.shape
                                       for k, v in params.items()}
    assert {k: v.shape for k, v in inception.random_pack(0).items()} == \
        inception.pack_shapes()
    short = dict(params)
    del short["Mixed_7c.branch_pool.bn.running_var"]
    with pytest.raises(KeyError, match="Mixed_7c.branch_pool.bn"):
        inception.params_from_pack(short)


@pytest.fixture(scope="module")
def jax_features(inception_pack):
    """The one JAX Inception run (its CPU compile is the slow part)."""
    _, params = inception_pack
    x = np.random.default_rng(3).uniform(0, 1, (3, 64, 64, 3)).astype(
        np.float32)
    return x, np.asarray(JaxInception(params)(jnp.asarray(x)))


def test_inception_pool3_matches_jax(inception_pack, jax_features):
    """Resize 64 -> 299 and pool3, tolerance 1e-4 of max|f|."""
    _, params = inception_pack
    x, want = jax_features
    got = inception.InceptionFID(
        inception.params_from_pack(params), device="cpu")(x)
    assert got.shape == want.shape == (3, 2048)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("size", [64, 512])
def test_resize_299_matches_jax(size):
    """The likeliest place for the packages to differ: both sample at
    half-pixel centres without antialiasing, up (64) and down (512)."""
    x = np.random.default_rng(size).uniform(0, 1, (1, size, size, 3)
                                            ).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3),
                                       method="bilinear", antialias=False))
    got = inception.resize_299(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_fid_matches_jax(inception_pack, tmp_path, monkeypatch, capsys):
    """cli.fid's main on two directories (one holds an image of another
    size, so the mixed-size pre-resize runs) against the JAX package's
    calc_fid: relative 1e-3."""
    path, _ = inception_pack
    monkeypatch.setenv("FASTDIFFSR_TPU_INCEPTION", str(path))
    rng = np.random.default_rng(4)
    a, b = tmp_path / "fake", tmp_path / "real"
    for d in (a, b):
        d.mkdir()
    for i in range(4):
        img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        M.save_img(img, str(a / f"{i}.png"))
        noisy = np.clip(img.astype(int) + rng.integers(-60, 61, img.shape),
                        0, 255).astype(np.uint8)
        M.save_img(noisy, str(b / f"{i}.png"))
    M.save_img(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8),
               str(a / "9_odd.png"))
    M.save_img(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
               str(b / "9.png"))
    want = jax_fid.calc_fid(str(a), str(b))
    got = fid.main([str(a), str(b), "--device", "cpu"])
    assert f"FID: {got}" in capsys.readouterr().out
    assert np.isfinite(want) and want > 0
    assert abs(got - want) <= 1e-3 * abs(want)


def test_fid_without_pack_exits_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("FASTDIFFSR_TPU_INCEPTION", str(tmp_path / "x.npz"))
    with pytest.raises(SystemExit) as theirs:
        jax_fid.calc_fid(str(tmp_path), str(tmp_path))
    with pytest.raises(SystemExit) as ours:
        fid.calc_fid(str(tmp_path), str(tmp_path))
    assert str(ours.value) == str(theirs.value)
    assert "FID feature extractor unavailable" in str(ours.value)


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(5)
    f1, f2 = rng.standard_normal((2, 40, 6))
    s = [fid.activation_statistics(f) for f in (f1, f2)]
    t = [jax_fid.activation_statistics(f) for f in (f1, f2)]
    assert fid.frechet_distance(*s[0], *s[1]) == jax_fid.frechet_distance(
        *t[0], *t[1])


def test_chip_smoke_fid_reference_matches_frechet_distance():
    """The smoke's eigenvalue evaluation of FID equals scipy's sqrtm route
    within 1e-6 relative, with features that never vary (dead pool3
    channels) in both sets."""
    import chip_smoke
    rng = np.random.default_rng(6)
    f1, f2 = np.maximum(rng.standard_normal((2, 300, 48))
                        + np.asarray([0.0, 0.3])[:, None, None], 0)
    f1[:, :8] = f2[:, :8] = 0
    s1, s2 = (fid.activation_statistics(f) for f in (f1, f2))
    want = fid.frechet_distance(*s1, *s2)
    assert want > 0.1
    assert abs(chip_smoke.fid_reference(*s1, *s2) - want) <= 1e-6 * want


def test_ssim_skimage_matches_jax():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (30, 27, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-25, 26, a.shape), 0,
                255).astype(np.uint8)
    for x, y in ((a, b), (a[..., 0], b[..., 0])):
        np.testing.assert_allclose(M.ssim_skimage(x, y),
                                   JM.ssim_skimage(x, y), rtol=1e-12)


def _png(rows, w, color=2, chans=3):
    """A PNG of filtered scanlines (filter byte first in each row)."""
    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", w, len(rows), 8, color, 0, 0, 0)
    raw = b"".join(bytes([f]) + r.tobytes() for f, r in rows)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_decode_png_sub_and_up_filters():
    """Filters None / Sub / Up as a PNG encoder writes them; RGBA loses
    its alpha; Average and Paeth are left to PIL (None)."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (3, 5, 4), dtype=np.uint8)
    flat = img.reshape(3, -1)
    sub = flat[0].astype(int).reshape(5, 4)
    sub[1:] -= flat[0].astype(int).reshape(5, 4)[:-1]
    rows = [(1, (sub % 256).astype(np.uint8).reshape(-1)),
            (2, ((flat[1].astype(int) - flat[0]) % 256).astype(np.uint8)),
            (0, flat[2])]
    np.testing.assert_array_equal(M.decode_png(_png(rows, 5, 6, 4)),
                                  img[..., :3])
    assert M.decode_png(_png([(4, flat[0])], 5, 6, 4)) is None


def test_load_img_reads_port_and_pil_pngs(tmp_path):
    from PIL import Image
    img = _images(8, 1, 17)[0]
    M.save_img(img, str(tmp_path / "port.png"))
    Image.fromarray(img).save(tmp_path / "pil.png", optimize=True)
    Image.fromarray(img[..., 0]).save(tmp_path / "grey.png")
    for name in ("port.png", "pil.png"):
        np.testing.assert_array_equal(M.load_img(str(tmp_path / name)), img)
    np.testing.assert_array_equal(M.load_img(str(tmp_path / "grey.png")),
                                  np.repeat(img[..., :1], 3, axis=2))


def test_plot_img_writes_a_panel(tmp_path):
    pytest.importorskip("matplotlib")
    a, b, c = _images(9, 3, 16)
    path = tmp_path / "p" / "0_panel.png"
    M.plot_img(str(path), a, b, c, 30.0, 0.9, 1.5, 0.1, 25.0, 0.8, 2.0,
               None)
    assert M.load_img(str(path)).ndim == 3
