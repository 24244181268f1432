"""The port's serving entry point, host side and import isolation: the
infer CLI on a tiny synthetic folder, PNG output, metrics and config
against the JAX package, no silent CPU, and no import of JAX or of the
JAX package anywhere in ``fastdiffsr_tpu_torch``."""

import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import REPO_ROOT

torch.set_num_threads(2)

PORT = REPO_ROOT / "fastdiffsr_tpu_torch"


def _tiny_config(tmp_path, droot, datatype="img"):
    cfg = json.loads((PORT / "configs" / "sr_fastdiffsr_infer_x4.json")
                     .read_text())
    cfg["name"] = "infer_unit"
    for ph in ("train", "val"):
        cfg["datasets"][ph].update(dataroot=str(droot), datatype=datatype,
                                   l_resolution=16, r_resolution=64)
    cfg["datasets"]["val"].update(data_len=3, batch_size=2)
    cfg["model"]["unet"].update(inner_channel=16, norm_groups=8,
                                channel_multiplier=[1, 2], res_blocks=1,
                                dropout=0.0)
    cfg["model"]["beta_schedule"]["val"]["n_timestep"] = 3
    cfg["path"] = {k: str(tmp_path / "exp" / k)
                   for k in ("log", "tb_logger", "results", "checkpoint")}
    cfg["path"]["resume_state"] = None
    path = tmp_path / "infer.json"
    path.write_text(json.dumps(cfg))
    return path


@pytest.fixture()
def folder_config(tmp_path):
    from PIL import Image
    droot = tmp_path / "data"
    rng = np.random.default_rng(0)
    for sub, size in [("lr_16", 16), ("hr_64", 64), ("sr_16_64", 64)]:
        (droot / sub).mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (size, size, 3),
                                         dtype=np.uint8)).save(
                droot / sub / f"{i:04d}.png")
    return _tiny_config(tmp_path, droot)


@pytest.mark.parametrize("forward", ["--fused", "--plain"])
def test_infer_cli_writes_pngs(folder_config, tmp_path, forward):
    from PIL import Image

    from fastdiffsr_tpu_torch.cli.infer import main
    summary = main(["-c", str(folder_config), "--device", "cpu",
                    "--dtype", "f32", forward])
    results = sorted((tmp_path / "exp" / "results").glob("*_sr.png"))
    assert [p.name for p in results] == ["0_sr.png", "1_sr.png", "2_sr.png"]
    img = np.asarray(Image.open(results[0]))
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    assert summary["images"] == 3 and summary["steady_images"] == 1
    log = (tmp_path / "exp" / "log" / "infer.log").read_text()
    assert re.search(r"mean latency: [\d.]+s over 1 images", log)


def test_infer_cli_npy_pack(tmp_path):
    """The npy-pack dataroot the chip smoke run writes needs no image
    decoder; fused and plain forwards agree on it (f32, atol 2 grey
    levels: uint8 rounding of outputs that agree to ~1e-5)."""
    from PIL import Image

    from fastdiffsr_tpu_torch.cli.infer import main
    rng = np.random.default_rng(1)
    droot = tmp_path / "pack"
    droot.mkdir()
    np.save(droot / "sr_16_64.npy",
            rng.integers(0, 255, (3, 64, 64, 3), dtype=np.uint8))
    np.save(droot / "hr_64.npy",
            rng.integers(0, 255, (3, 64, 64, 3), dtype=np.uint8))
    cfg = _tiny_config(tmp_path, droot, datatype="npy")
    out = {}
    for fwd in ("--fused", "--plain"):
        s = main(["-c", str(cfg), "--device", "cpu", "--dtype", "f32", fwd])
        out[fwd] = [np.asarray(Image.open(p), np.int16) for p in
                    sorted(pathlib.Path(s["results"]).glob("*_sr.png"))]
    assert len(out["--fused"]) == 3
    for a, b in zip(out["--fused"], out["--plain"]):
        assert np.abs(a - b).max() <= 2


def test_infer_cli_loads_resume_state(folder_config, tmp_path):
    """path.resume_state names a saved UNet state dict, which replaces the
    seeded params (strictly: one of another width is refused)."""
    from fastdiffsr_tpu_torch.cli.infer import main
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import (FastDiffSRUNet,
                                                             init_params)
    cfg = json.loads(folder_config.read_text())
    for width, name in ((16, "ok"), (8, "other_width")):
        net = init_params(FastDiffSRUNet(
            inner_channel=width, norm_groups=8, channel_mults=(1, 2),
            res_blocks=1, dropout=0.0), seed=5)
        torch.save(net.state_dict(), tmp_path / f"{name}.pt")
    args = ["--device", "cpu", "--dtype", "f32"]

    cfg["path"]["resume_state"] = str(tmp_path / "ok.pt")
    (tmp_path / "ok.json").write_text(json.dumps(cfg))
    assert main(["-c", str(tmp_path / "ok.json"), *args])["images"] == 3
    log = (tmp_path / "exp" / "log" / "infer.log").read_text()
    assert f"loaded params from {tmp_path / 'ok.pt'}" in log

    cfg["path"]["resume_state"] = str(tmp_path / "other_width.pt")
    (tmp_path / "bad.json").write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="size mismatch"):
        main(["-c", str(tmp_path / "bad.json"), *args])


def test_entry_points_refuse_silent_cpu(folder_config):
    """With no CUDA device, entry points called without a device raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is honoured")
    from fastdiffsr_tpu_torch.cli.infer import main
    from fastdiffsr_tpu_torch.diffusion import ScheduleBuffers
    from fastdiffsr_tpu_torch.models import unet_from_config
    from fastdiffsr_tpu_torch.train import pad_batch_with_keys
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-c", str(folder_config)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScheduleBuffers.create({"schedule": "linear", "n_timestep": 4,
                                "linear_start": 1e-4, "linear_end": 2e-2})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        unet_from_config({"inner_channel": 16, "norm_groups": 8,
                          "channel_multiplier": [1]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pad_batch_with_keys(np.zeros((1, 4, 4, 3)), 1, 0, 0)


@pytest.mark.parametrize("shape", [(13, 17, 3), (9, 6)])
def test_save_img_png_decodes_to_same_array(tmp_path, shape):
    from PIL import Image

    from fastdiffsr_tpu_torch.metrics import save_img
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "sub" / "x.png"
    save_img(img, str(path))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_metrics_match_jax_package():
    """PSNR/ERGAS are the same float64 formulas; SSIM filters with scipy
    instead of cv2.filter2D, same window and crop: rtol 1e-9 (float64
    sums in another order)."""
    pytest.importorskip("cv2")
    from fastdiffsr_tpu import metrics as JM
    from fastdiffsr_tpu_torch import metrics as M
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-20, 21, a.shape), 0,
                255).astype(np.uint8)
    for fn in ("calculate_psnr", "calculate_ergas", "calculate_ssim"):
        np.testing.assert_allclose(getattr(M, fn)(a, b),
                                   getattr(JM, fn)(a, b), rtol=1e-9,
                                   err_msg=fn)
    x = rng.uniform(-1.2, 1.2, (2, 5, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(M.tensor2img(x), JM.tensor2img(x))


def test_config_parse_matches_jax_package(tmp_path):
    from fastdiffsr_tpu.config import parse as jax_parse
    from fastdiffsr_tpu_torch.config import parse
    cfg = str(PORT / "configs" / "sr_fastdiffsr_test_64_256.json")
    ours = parse(cfg, "val", debug=True, root=str(tmp_path / "a"))
    theirs = jax_parse(cfg, "val", debug=True, root=str(tmp_path / "b"))
    for key in ("datasets", "model", "train", "phase", "name"):
        assert ours[key] == theirs[key], key
    assert ours["distributed"] == (torch.cuda.device_count() > 1)


def test_lmdb_datatype_raises(tmp_path):
    from fastdiffsr_tpu_torch.data import LRHRDataset
    with pytest.raises(NotImplementedError, match="lmdb"):
        LRHRDataset(str(tmp_path), datatype="lmdb")


def test_port_imports_without_jax_or_jax_package():
    """Every module of the port imports with jax, flax, optax and
    fastdiffsr_tpu blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'fastdiffsr_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import fastdiffsr_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, "
        "'fastdiffsr_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 15
    assert {f"fastdiffsr_tpu_torch.{m}" for m in (
        "lpips_torch", "models.inception", "cli.fid",
        "utils.wandb_logger", "diffusion.sde", "models.nafnet",
        "models.cond_unet", "ediffsr.options", "ediffsr.imgproc",
        "ediffsr.data", "ediffsr.deg", "ediffsr.schedulers",
        "ediffsr.train", "models.vgg_feat", "msi.data", "msi.degradation",
        "msi.swinir", "msi.hat", "msi.hsenet", "msi.transenet",
        "msi.ndsrgan", "msi.trainer", "msi.logger", "msi.plots",
        "msi.main")} <= names


IMPORT_OF_REFERENCE = re.compile(
    r"^\s*(?:from\s+(?:jax|flax|optax|fastdiffsr_tpu)(?![\w])"
    r"|import\s+(?:jax|flax|optax|fastdiffsr_tpu)(?![\w]))", re.M)


def test_source_scan_finds_no_reference_import():
    """No line of the port imports jax, flax, optax or the JAX package
    (the pattern stops at word characters, so ``fastdiffsr_tpu_torch``
    does not match it)."""
    assert IMPORT_OF_REFERENCE.search("from fastdiffsr_tpu.ops import x")
    assert IMPORT_OF_REFERENCE.search("    import fastdiffsr_tpu")
    assert not IMPORT_OF_REFERENCE.search("from fastdiffsr_tpu_torch import x")
    assert not IMPORT_OF_REFERENCE.search("import fastdiffsr_tpu_torch.ops")
    sources = sorted(PORT.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]
    hits = [f"{p}:{m.group(0).strip()}" for p in sources
            for m in IMPORT_OF_REFERENCE.finditer(p.read_text())]
    assert not hits, hits
