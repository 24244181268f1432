"""``ediffsr.train -launcher pytorch`` as 1 and 2 gloo ranks (separate
processes, ``tests/torch_dist_worker.py``) at a tiny NAFNet (width 16,
enc [1, 1], T=4) on eight 8->16 PNG pairs, and ``--test`` split over 2
ranks against one process.

Training draws each step's t and noise for the global batch of 4 and
keeps a rank's rows, and DDP averages the gradients, so the per-step
losses of 2 ranks equal 1 rank's within LOSS_RTOL (float32 sums in
another order). The crops are the whole 16x16 images and flips and
rotations are off: each rank draws its own rows' augmentations in its own
stream (``ediffsr.data``), which a 2-rank run does not share with a
1-rank run by design. Rank 0 alone validates and saves. ``--test``
(reverse SDE, batch 2) restores a rank's rows with the images' own
generators; its per-image metrics equal the one-process run's within
METRIC_RTOL, on one thread as the ranks run."""

import numpy as np
import pytest
import torch

from fastdiffsr_tpu_torch.ediffsr import train as ttrain
from fastdiffsr_tpu_torch.ediffsr.options import dump_yaml
from fastdiffsr_tpu_torch.metrics import save_img
from tests import torch_dist_worker as W

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
METRIC_RTOL = 1e-5


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_ediffsr")
    rng = np.random.default_rng(2)
    for sub, size in [("hr_16", 16), ("lr_8", 8)]:
        for i in range(8):
            save_img(rng.integers(0, 255, (size, size, 3), dtype=np.uint8),
                     str(root / "data" / sub / f"{i}.png"))
    data = {"dataroot_GT": str(root / "data" / "hr_16"),
            "dataroot_LQ": str(root / "data" / "lr_8")}
    opt = {
        "name": "dist_ediffsr", "model": "denoising", "distortion": "sr",
        "sde": {"max_sigma": 50, "T": 4, "schedule": "cosine",
                "eps": 0.005},
        "degradation": {"sigma": 25, "noise_type": "G", "scale": 2},
        "datasets": {
            "train": {"name": "T", "mode": "LQGT", **data,
                      "use_shuffle": True, "batch_size": 4, "GT_size": 16,
                      "LR_size": 8, "use_flip": False, "use_rot": False,
                      "n_workers": 1},
            "val": {"name": "V", "mode": "LQGT", **data, "data_len": 4}},
        "network_G": {"which_model_G": "ConditionalNAFNet",
                      "setting": {"width": 16, "enc_blk_nums": [1, 1],
                                  "middle_blk_num": 1,
                                  "dec_blk_nums": [1, 1]}},
        "path": {"pretrain_model_G": None, "strict_load": True,
                 "resume_state": None},
        "train": {"optimizer": "AdamW", "lr_G": 1e-3,
                  "lr_scheme": "TrueCosineAnnealingLR", "beta1": 0.9,
                  "beta2": 0.99, "niter": 4, "eta_min": 1e-7,
                  "loss_type": "l1", "weight": 1.0, "manual_seed": 0,
                  "val_freq": 2, "warmup_iter": 2},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 2},
    }
    return root, opt


def _launch(root, opt, world, tag, *flags):
    cwd = root / tag
    cwd.mkdir()
    yml = cwd / "opt.yml"
    yml.write_text(dump_yaml(opt))
    ranks = W.launch("ediffsr", world, cwd / "out",
                     ["-opt", str(yml), "-launcher", "pytorch", "--device",
                      "cpu", *flags], cwd=cwd)
    return [r for r, _ in ranks], cwd


def test_two_ranks_train_and_test_as_one(env, monkeypatch):
    root, opt = env
    one, cwd1 = _launch(root, opt, 1, "one", "--val_images", "2")
    two, cwd2 = _launch(root, opt, 2, "two", "--val_images", "2")
    assert len(one[0]["loss"]) == 4
    for res in two:
        np.testing.assert_allclose(res["loss"], one[0]["loss"],
                                   rtol=LOSS_RTOL)
    assert two[0]["checkpoint"].endswith("I4_E0")
    assert two[1]["checkpoint"] is None and two[1]["validations"] == []
    assert [v["step"] for v in two[0]["validations"]] == [2, 4]
    for cwd in (cwd1, cwd2):
        models = cwd / "experiments" / "dist_ediffsr" / "models"
        assert {"I2_E0", "I4_E0", "best.txt"} <= {
            p.name for p in models.iterdir()}
        log = (cwd / "experiments" / "dist_ediffsr" / "train.log")
        assert log.read_text().count("training done") == 1

    test_opt = {**opt, "name": "dist_ediffsr_test",
                "path": {**opt["path"],
                         "pretrain_model_G": str(cwd2 / two[0]["checkpoint"])},
                "datasets": {"test": {**opt["datasets"]["val"],
                                      "name": "test"}}}
    test_opt.pop("train")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yml = root / "test.yml"
        yml.write_text(dump_yaml(test_opt))
        monkeypatch.chdir(root)
        want = ttrain.main(["-opt", str(yml), "--test", "--device", "cpu",
                            "--batch", "2"])
    finally:
        torch.set_num_threads(n)
    got, _ = _launch(root, test_opt, 2, "test", "--test", "--batch", "2")
    for res in got:
        assert res["images"] == want["images"] == 4
        for k in ("psnr", "ssim", "ergas"):
            np.testing.assert_allclose(res[k], want[k], rtol=METRIC_RTOL,
                                       err_msg=k)
    pngs = sorted(p.name for p in (root / "test" / "results" /
                                   "dist_ediffsr_test").glob("?.png"))
    assert pngs == [f"{i}.png" for i in range(4)]
