"""``sr_mfe -dist`` and ``infer -dist`` as 1 and 2 gloo ranks (separate
processes with torchrun's variables, ``tests/torch_dist_worker.py``) at
the tiny UNet of ``tests/test_torch_sr_mfe.py`` (dropout 0), on an 8-image
npy pack that divides into the global batch of 4.

- ``-p train -dist``: the per-step logged ``l_pix`` of 2 ranks equals
  that of 1 rank within rtol 2e-3 (the JAX package's bound in
  ``tests/test_multihost.py``), with and without
  ``datasets.train.device_cache``; rank 0 alone writes the checkpoints
  and the log, and the other rank returns no checkpoint.
- ``-p val -dist`` from that checkpoint splits each validation batch of 2
  over the ranks: each rank writes its images, and the metric means equal
  a one-process ``-p val`` within rtol 1e-4 (the fused forward's CPU
  K3/K2 versions sum in an order that follows the batch, ~1e-5 in the
  images; ``tests/test_torch_dist_train.py``).
- ``infer -dist`` on 2 ranks writes every image once, each within one
  uint8 level of the one-process image (the same rounding of ~1e-5)."""

import json
import logging

import numpy as np
import pytest
import torch

from fastdiffsr_tpu_torch.cli import infer, sr_mfe
from fastdiffsr_tpu_torch.data import write_pack
from fastdiffsr_tpu_torch.metrics import load_img
from tests import torch_dist_worker as W
from tests.test_torch_sr_mfe import _config

torch.set_num_threads(2)

L_PIX_RTOL = 2e-3
METRIC_RTOL = 1e-4


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    write_pack(str(root / "pack"), 8, 3, 8, 16)
    return root


def _train_cfg(root, name, **datasets_train):
    cfg = _config(root, dataroot="pack", n_iter=4, val_freq=2,
                  save_checkpoint_freq=2)
    cfg["name"] = name
    cfg["model"]["unet"]["dropout"] = 0.0
    cfg["datasets"]["train"]["batch_size"] = 4
    cfg["datasets"]["train"].update(datasets_train)
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _train(root, cfg, world, tag):
    cwd = root / tag
    cwd.mkdir()
    ranks = W.launch("sr_mfe", world, root / f"{tag}_out",
                     ["-p", "train", "-c", cfg, "-dist", "--device", "cpu",
                      "--seed", "4"], cwd=cwd)
    run = next((cwd / "experiments").iterdir())
    return [r for r, _ in ranks], run


@pytest.mark.parametrize("cache", [False, True])
def test_sr_mfe_train_two_ranks_equal_one(pack, cache):
    cfg = _train_cfg(pack, f"dist_{int(cache)}", device_cache=cache)
    one, run1 = _train(pack, cfg, 1, f"one_{int(cache)}")
    two, run2 = _train(pack, cfg, 2, f"two_{int(cache)}")
    assert len(one[0]["l_pix"]) == 4
    for res in two:
        np.testing.assert_allclose(res["l_pix"], one[0]["l_pix"],
                                   rtol=L_PIX_RTOL)
    assert two[0]["checkpoint"].endswith("I4_E2")
    assert two[1]["checkpoint"] is None
    for run in (run1, run2):
        assert sorted(p.name for p in (run / "checkpoint").iterdir()) == [
            "I2_E1", "I4_E2"]
        log = (run / "logs" / "train.log").read_text()
        assert log.count("training complete") == 1
        # the in-run validations (steps 2 and 4) ran once, on rank 0
        assert (run / "logs" / "val.log").read_text().count(
            "# Validation #") == 2


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_loggers():
    for name in ("base", "val"):
        lg = logging.getLogger(name)
        for h in list(lg.handlers):
            lg.removeHandler(h)
            h.close()


def _val_cfg(root, name, ckpt):
    cfg = _config(root, dataroot="pack")
    cfg["name"] = name
    cfg["model"]["unet"]["dropout"] = 0.0
    cfg["datasets"]["val"].update(batch_size=2, data_len=4)
    cfg["path"]["resume_state"] = ckpt
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_val_and_infer_split_images_over_ranks(pack, one_thread,
                                               monkeypatch):
    cfg = _train_cfg(pack, "dist_val_src")
    (res, _), = W.launch("sr_mfe", 1, pack / "src_out",
                         ["-p", "train", "-c", cfg, "-dist", "--device",
                          "cpu"], cwd=pack)
    ckpt = res["checkpoint"]
    vcfg = _val_cfg(pack, "dist_val", ckpt)
    monkeypatch.chdir(pack)
    want = sr_mfe.main(["-p", "val", "-c", vcfg, "--device", "cpu"])
    results = next(pack.glob("experiments/dist_val_src_*/results"))
    for png in results.glob("*.png"):
        png.unlink()
    two = W.launch("sr_mfe", 2, pack / "val_out",
                   ["-p", "val", "-c", vcfg, "-dist", "--device", "cpu"],
                   cwd=pack)
    for got, _ in two:
        for k in ("psnr", "ssim", "mse", "ergas"):
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                       err_msg=k)
    # rank 0 wrote images 0 and 2, rank 1 images 1 and 3
    assert sorted(p.name for p in results.glob("*_sr.png")) == [
        f"{i}_sr.png" for i in range(4)]

    paths = {}
    for tag in ("plain", "two"):        # run dirs of their own
        icfg = json.loads(open(vcfg).read())
        icfg["name"] = f"dist_infer_{tag}"
        icfg["path"]["resume_state"] = None
        paths[tag] = pack / f"dist_infer_{tag}.json"
        paths[tag].write_text(json.dumps(icfg))
    plain = infer.main(["-c", str(paths["plain"]), "--device", "cpu"])
    ranks = W.launch("infer", 2, pack / "infer_out",
                     ["-c", str(paths["two"]), "-dist", "--device", "cpu"],
                     cwd=pack)
    assert plain["images"] == 4 and all(r["images"] == 4 for r, _ in ranks)
    for i in range(4):
        a = load_img(f"{plain['results']}/{i}_sr.png").astype(int)
        b = load_img(f"{ranks[0][0]['results']}/{i}_sr.png").astype(int)
        assert np.abs(a - b).max() <= 1, i
