"""The port's native PNG/JPEG decoder (``fastdiffsr_tpu_torch.native``)
against the JAX package's (``fastdiffsr_tpu.native``) and PIL on seeded
files, the dataset's routing to it, and its failure path. Both decoders
are compiled from their own packages' sources with the system g++."""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import fastdiffsr_tpu.native as jax_native
from fastdiffsr_tpu_torch import native
from fastdiffsr_tpu_torch.data import dataset
from tests.conftest import REPO_ROOT

H, W = 12, 10


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Seeded RGB PNGs, a grayscale and an RGBA PNG, and JPEGs."""
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    out = {"png": [], "jpg": []}
    for i in range(4):
        arr = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        p = d / f"{i}.png"
        Image.fromarray(arr).save(p)
        out["png"].append(str(p))
        q = d / f"{i}.jpg"
        Image.fromarray(arr).save(q, quality=90)
        out["jpg"].append(str(q))
    gray = d / "gray.png"
    Image.fromarray(rng.integers(0, 256, (H, W), dtype=np.uint8)).save(gray)
    rgba = d / "rgba.png"
    Image.fromarray(rng.integers(0, 256, (H, W, 4), dtype=np.uint8),
                    "RGBA").save(rgba)
    out["png_modes"] = [str(gray), str(rgba)]
    if native.get_lib() is None or jax_native.get_lib() is None:
        pytest.fail(f"a native decoder did not build: {native.FAILURE}")
    return out


def _pil(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


@pytest.mark.parametrize("kind", ["png", "jpg", "png_modes"])
def test_decode_rgb_matches_the_jax_decoder(images, kind):
    """decode_rgb and image_dims of the port equal the JAX package's bit
    for bit, for PNG and JPEG."""
    for p in images[kind]:
        assert native.image_dims(p) == jax_native.image_dims(p) == (W, H)
        got = native.decode_rgb(p)
        assert got.dtype == np.uint8 and got.shape == (H, W, 3)
        np.testing.assert_array_equal(got, jax_native.decode_rgb(p))


@pytest.mark.parametrize("kind", ["png", "jpg"])
def test_load_batch_matches_the_jax_decoder(images, kind):
    """load_batch_f32 with per-image flips on 3 threads, and unflipped on
    one, equals the JAX package's bit for bit and the uint8 decode mapped
    as x/255*2-1 and flipped."""
    paths = images[kind]
    flips = np.array([0, 1, 1, 0], np.uint8)
    got = native.load_batch_f32(paths, W, H, flips=flips, n_threads=3)
    want = jax_native.load_batch_f32(paths, W, H, flips=flips, n_threads=3)
    np.testing.assert_array_equal(got, want)
    for i, p in enumerate(paths):
        x = native.decode_rgb(p) * np.float32(2.0 / 255) - np.float32(1.0)
        np.testing.assert_array_equal(got[i], x[:, ::-1] if flips[i] else x)
    plain = native.load_batch_f32(paths, W, H, 1.0, 0.0, n_threads=1)
    np.testing.assert_array_equal(
        plain, jax_native.load_batch_f32(paths, W, H, 1.0, 0.0,
                                         n_threads=1))
    with pytest.raises(ValueError, match="flips"):
        native.load_batch_f32(paths, W, H, flips=[0, 1])


def test_png_matches_pil(images):
    """PNG (RGB, grayscale, RGBA) decodes bit-equal to PIL's RGB."""
    for p in images["png"] + images["png_modes"]:
        np.testing.assert_array_equal(native.decode_rgb(p), _pil(p))


def test_dataset_routes_png_and_jpeg_to_the_native_decoder(
        images, monkeypatch, tmp_path):
    """``_load_image`` takes the native decoder for .png/.jpg/.jpeg and
    PIL for other formats; with FASTDIFFSR_TPU_NO_NATIVE=1 PIL for all."""
    calls = []
    real = native.decode_rgb
    monkeypatch.setattr(native, "decode_rgb",
                        lambda p: calls.append(p) or real(p))
    bmp = str(tmp_path / "x.bmp")
    Image.open(images["png"][0]).save(bmp)
    monkeypatch.delenv("FASTDIFFSR_TPU_NO_NATIVE", raising=False)
    for p in images["png"] + images["jpg"] + [bmp]:
        np.testing.assert_array_equal(
            dataset._load_image(p),
            real(p) if p != bmp else _pil(p))
    assert calls == images["png"] + images["jpg"]
    calls.clear()
    monkeypatch.setenv("FASTDIFFSR_TPU_NO_NATIVE", "1")
    for p in images["png"] + images["jpg"]:
        np.testing.assert_array_equal(dataset._load_image(p), _pil(p))
    assert calls == []


def test_lrhr_dataset_decodes_folders_natively(images, tmp_path,
                                               monkeypatch):
    """An LRHRDataset over a PNG folder tree gives the same arrays with
    the native decoder as with NO_NATIVE=1 (PIL)."""
    root = tmp_path / "set"
    for sub in ("sr_8_16", "hr_16"):
        (root / sub).mkdir(parents=True)
        for i in range(3):
            arr = np.random.default_rng(i).integers(0, 256, (16, 16, 3),
                                                    dtype=np.uint8)
            Image.fromarray(arr).save(root / sub / f"{i}.png")
    out = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("FASTDIFFSR_TPU_NO_NATIVE", flag)
        ds = dataset.LRHRDataset(str(root), "img", 8, 16, split="val")
        out[flag] = [ds[i] for i in range(len(ds))]
    for a, b in zip(out["0"], out["1"]):
        for k in ("HR", "SR"):
            np.testing.assert_array_equal(a[k], b[k])


def test_failed_build_is_logged_once_and_pil_decodes(images, monkeypatch,
                                                     tmp_path, caplog):
    """A source that does not compile: get_lib logs one warning with the
    compiler's message, returns None from then on, and the dataset
    decodes with PIL."""
    bad = tmp_path / "loader.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "FAILURE", None)
    monkeypatch.delenv("FASTDIFFSR_TPU_NO_NATIVE", raising=False)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.get_lib() is None
        assert native.get_lib() is None
        p = images["png"][1]
        assert native.decode_rgb(p) is None
        np.testing.assert_array_equal(dataset._load_image(p), _pil(p))
    warnings = [r for r in caplog.records if r.name == native.__name__]
    assert len(warnings) == 1
    assert "failed" in warnings[0].getMessage()
    assert "loader.cc" in native.FAILURE


def test_port_never_loads_the_jax_library(images):
    """In a fresh process that decodes through the port, the port's
    library from build/native is mapped and the JAX package's
    libfastdiffsr_loader.so is not; no module of the JAX package is
    imported."""
    code = (
        "import sys\n"
        "from fastdiffsr_tpu_torch import native\n"
        "from fastdiffsr_tpu_torch.data import dataset\n"
        f"a = dataset._load_image({images['png'][0]!r})\n"
        "assert a.shape == (12, 10, 3)\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(int('libfdsr_loader.so' in maps),"
        " int('libfastdiffsr_loader.so' in maps),"
        " int(any(m == 'fastdiffsr_tpu' or m.startswith('fastdiffsr_tpu.')"
        " for m in sys.modules)), native.library_path())\n")
    env = {k: v for k, v in os.environ.items()
           if k != "FASTDIFFSR_TPU_NO_NATIVE"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0, out.stderr
    port, jax_lib, jax_mod, path = out.stdout.split()
    assert (port, jax_lib, jax_mod) == ("1", "0", "0")
    assert path.startswith(str(REPO_ROOT / "build" / "native"))
