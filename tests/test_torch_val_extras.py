"""What the port's entry points report and write beyond the samples, on
the CPU at a tiny size: LPIPS in ``sr_mfe -p val`` (against the JAX
package's LPIPS on the saved images) and the comparison panels, with and
without an LPIPS pack and without matplotlib; the Weights & Biases flags
as a no-op where wandb does not import; cuDNN's heuristics around the
validation inside ``-p train``; the x8 configs (a -debug train + val at
32->256, ERGAS at scale 8); and ``infer``'s float32 default."""

import json
import logging
import sys

import numpy as np
import pytest
import torch

from fastdiffsr_tpu.config import infer_scale as jax_infer_scale
from fastdiffsr_tpu.config import parse as jax_parse
from fastdiffsr_tpu.lpips_jax import LPIPSJax
from fastdiffsr_tpu_torch import device as port_device
from fastdiffsr_tpu_torch import metrics as M
from fastdiffsr_tpu_torch.cli import infer, sr_mfe
from fastdiffsr_tpu_torch.config import infer_scale, parse
from fastdiffsr_tpu_torch.data import write_pack
from fastdiffsr_tpu_torch.lpips_torch import random_pack
from tests.conftest import REPO_ROOT
from tests.test_torch_sr_mfe import _config, _run_dir, _write

torch.set_num_threads(2)

CONFIGS = REPO_ROOT / "fastdiffsr_tpu_torch" / "configs"


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch, tmp_path):
    """A fresh working directory, loggers and LPIPS singletons per test;
    wandb never imports."""
    monkeypatch.chdir(tmp_path)
    for name in ("base", "val"):
        lg = logging.getLogger(name)
        for h in list(lg.handlers):
            lg.removeHandler(h)
            h.close()
    monkeypatch.setattr(M, "_LPIPS", {})
    monkeypatch.setattr(M, "_LPIPS_WARNED", False)
    monkeypatch.setitem(sys.modules, "wandb", None)


def _val_config(tmp_path, r=32):
    """-p val over 2 images of a seeded 8->``r`` pack (AlexNet needs 32
    pixels)."""
    write_pack(str(tmp_path / "pack"), 2, 11, 8, r)
    cfg = _config(tmp_path, "pack")
    for ds in cfg["datasets"].values():
        ds["r_resolution"] = r
    return _write(tmp_path, cfg, "val.json")


@pytest.mark.parametrize("with_pack", [True, False])
def test_val_reports_lpips_and_writes_panels(tmp_path, monkeypatch,
                                             with_pack):
    """With an LPIPS pack, ``lpips`` is the mean of the JAX package's
    LPIPS over the saved SR/HR images (atol 1e-5); without one there is
    no ``lpips`` key. Panels are written either way."""
    pack = tmp_path / "lpips_alex.npz"
    if with_pack:
        np.savez(pack, **random_pack(0))
    monkeypatch.setenv("FASTDIFFSR_TPU_LPIPS", str(pack))
    res = sr_mfe.main(["-p", "val", "-c", _val_config(tmp_path),
                       "--device", "cpu"])
    results = _run_dir(tmp_path) / "results"
    assert {p.name for p in results.glob("*_panel.png")} == {
        "0_panel.png", "1_panel.png"}
    if not with_pack:
        assert "lpips" not in res
        return
    ref = LPIPSJax.load_default()
    want = np.mean([ref.distance(M.load_img(str(results / f"{i}_sr.png")),
                                 M.load_img(str(results / f"{i}_hr.png")))
                    for i in range(2)])
    assert abs(res["lpips"] - want) <= 1e-5
    log = (_run_dir(tmp_path) / "logs" / "val.log").read_text()
    assert log.count(" lpips 0.") == 2


def test_val_skips_panels_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    res = sr_mfe.main(["-p", "val", "-c", _val_config(tmp_path, 16),
                       "--device", "cpu"])
    assert np.isfinite(res["psnr"])
    run = _run_dir(tmp_path)
    assert not list((run / "results").glob("*_panel.png"))
    assert (run / "logs" / "val.log").read_text().count(
        "panels ({idx}_panel.png) are skipped") == 1


@pytest.mark.parametrize("entry", ["train", "val", "infer"])
def test_enable_wandb_is_a_no_op_without_wandb(tmp_path, entry):
    write_pack(str(tmp_path / "pack"), 2, 12, 8, 16)
    cfg = _write(tmp_path, _config(tmp_path, "pack", n_iter=2, val_freq=2,
                                   save_checkpoint_freq=2))
    with pytest.warns(UserWarning, match="wandb unavailable"):
        if entry == "infer":
            out = infer.main(["-c", cfg, "--device", "cpu", "-enable_wandb",
                              "-log_infer"])
            assert out["images"] == 2
        else:
            out = sr_mfe.main(["-p", entry, "-c", cfg, "--device", "cpu",
                               "-enable_wandb", "-log_wandb_ckpt",
                               "-log_eval"])
            assert (out["step"] == 2 if entry == "train"
                    else np.isfinite(out["psnr"]))


def test_train_validation_runs_on_cudnn_heuristics(tmp_path, monkeypatch):
    """-p train times cuDNN's algorithms, switches to its heuristics for
    each validation inside the loop and back after it."""
    calls, at_val = [], []
    set_orig = port_device.set_cudnn_autotuning
    val_orig = sr_mfe.run_validation

    def record_set(on):
        calls.append(on)
        set_orig(on)

    def record_val(*a, **kw):
        at_val.append(torch.backends.cudnn.benchmark)
        return val_orig(*a, **kw)

    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(port_device, "set_cudnn_autotuning", record_set)
    monkeypatch.setattr(sr_mfe, "run_validation", record_val)
    write_pack(str(tmp_path / "pack"), 4, 13, 8, 16)
    cfg = _config(tmp_path, "pack", n_iter=4, val_freq=2)
    out = sr_mfe.main(["-p", "train", "-c", _write(tmp_path, cfg),
                       "--device", "cpu"])
    assert np.isfinite(out["last_validation"]["psnr"])
    assert calls == [True, False, True, False, True]
    assert at_val == [False, False]
    assert torch.backends.cudnn.benchmark


X8 = sorted(p.name for p in CONFIGS.glob("sr_*_32_256.json"))


def test_x8_configs_are_the_jax_packages():
    assert X8 == [f"sr_{v}_{k}_32_256.json" for v in
                  ("ddpm", "fastdiffsr", "gdp", "tesr")
                  for k in ("test", "train")]


@pytest.mark.parametrize("name", X8)
def test_x8_config_parses_to_scale_8(tmp_path, name):
    path = CONFIGS / name
    assert path.read_bytes() == (REPO_ROOT / "fastdiffsr_tpu" / "configs"
                                 / name).read_bytes()
    ours = parse(str(path), "val", root=str(tmp_path / "a"))
    theirs = jax_parse(str(path), "val", root=str(tmp_path / "b"))
    assert infer_scale(ours) == jax_infer_scale(theirs) == 8
    assert ours["datasets"] == theirs["datasets"]


def test_x8_debug_train_then_val(tmp_path):
    """-debug at 32->256 on a narrow UNet synthesizes the data, trains and
    validates; -p val from the checkpoint reports ERGAS at scale 8 (the
    mean over the saved images, rtol 1e-9)."""
    cfg = json.loads((CONFIGS / "sr_fastdiffsr_train_32_256.json")
                     .read_text())
    cfg["model"]["unet"].update(inner_channel=8, norm_groups=4,
                                channel_multiplier=[1, 2], res_blocks=1)
    for ds in cfg["datasets"].values():
        ds.update(dataroot=str(tmp_path / "absent_32_256"), num_workers=1)
    out = sr_mfe.main(["-p", "train", "-c", _write(tmp_path, cfg), "-debug",
                       "--device", "cpu"])
    assert out["steps"] == 8 and np.isfinite(out["l_pix"]).all()
    assert "scale x8" in (_run_dir(tmp_path) / "logs" / "train.log"
                          ).read_text()
    cfg["path"]["resume_state"] = out["checkpoint"]
    res = sr_mfe.main(["-p", "val", "-c", _write(tmp_path, cfg, "v.json"),
                       "-debug", "--device", "cpu"])
    results = _run_dir(tmp_path) / "results"
    pairs = [(M.load_img(str(results / f"{i}_sr.png")),
              M.load_img(str(results / f"{i}_hr.png"))) for i in range(3)]
    assert pairs[0][0].shape == (256, 256, 3)
    np.testing.assert_allclose(
        res["ergas"], np.mean([M.calculate_ergas(s, h, scale=8)
                               for s, h in pairs]), rtol=1e-9)


def test_infer_samples_in_float32_by_default(tmp_path, monkeypatch):
    """Without --dtype, infer builds and samples in float32: the same
    images as an explicit --dtype f32, and not bf16's."""
    dtypes = []
    build = infer.build_all

    def record(*a, **kw):
        dtypes.append(kw["dtype"])
        return build(*a, **kw)

    monkeypatch.setattr(infer, "build_all", record)
    write_pack(str(tmp_path / "pack"), 2, 14, 8, 16)
    cfg = _write(tmp_path, _config(tmp_path, "pack"))
    out = {}
    for flags in ([], ["--dtype", "f32"], ["--dtype", "bf16"]):
        s = infer.main(["-c", cfg, "--device", "cpu", *flags])
        out[" ".join(flags)] = [M.load_img(f"{s['results']}/{i}_sr.png")
                                for i in range(2)]
    assert dtypes == [torch.float32, torch.float32, torch.bfloat16]
    for a, b in zip(out[""], out["--dtype f32"]):
        np.testing.assert_array_equal(a, b)
    assert any((a != b).any() for a, b in zip(out[""], out["--dtype bf16"]))
