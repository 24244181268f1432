"""The MSI trainers on 2 gloo ranks (separate processes,
``tests/torch_dist_worker.py``) against the same code in this process
without a process group: ``SupervisedSRTrainer`` on a tiny SwinIR with
drop-path on (the masks drawn for the global batch and sliced), one
epoch of 8 tiles at a global batch of 4 (2 steps), its epoch-end
validation and save on rank 0, then ``validate`` and
``validate_by_class`` with their eval batches split over the ranks; and
``GANTrainer`` (tiny DRRDBNet and the GroupNorm discriminator, each in
its own DDP wrapper, crop 32), 2 steps at a global batch of 4. Losses
within LOSS_RTOL, parameters within PARAM_ATOL (float32 sums in another
order: the gradient is the mean of two half-batch means; lr 1e-3), the
sharded metrics within METRIC_RTOL; the reference runs on one thread, as
the ranks do."""

import numpy as np
import pytest
import torch

from fastdiffsr_tpu_torch.metrics import save_img
from tests import torch_dist_worker as W

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
METRIC_RTOL = 1e-5


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_msi")
    rng = np.random.default_rng(5)
    for i in range(8):
        save_img(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
                 str(root / "train" / f"{i}.png"))
        save_img(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                 str(root / "train32" / f"{i}.png"))
    for cls in ("farm", "lake"):
        for i in range(3):
            save_img(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
                     str(root / "test" / cls / f"{i}.png"))
    return root


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_params(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_supervised_trainer_two_ranks_equal_one(data, tmp_path, one_thread):
    want, want_p = W.supervised_case(str(data), str(tmp_path / "one"))
    ranks = W.launch("supervised", 2, tmp_path / "out",
                     [data, tmp_path / "two"])
    for r, (res, params) in enumerate(ranks):
        np.testing.assert_allclose(res["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        _close_params(params, want_p)
        for k, v in want["validate"].items():
            np.testing.assert_allclose(res["validate"][k], v,
                                       rtol=METRIC_RTOL, err_msg=k)
        for cls, m in want["by_class"].items():
            for k, v in m.items():
                np.testing.assert_allclose(res["by_class"][cls][k], v,
                                           rtol=METRIC_RTOL,
                                           err_msg=f"{cls} {k}")
    rank0, rank1 = ranks[0][0], ranks[1][0]
    assert rank0["checkpoint"].endswith("I2_E1")
    assert rank1["checkpoint"] is None and rank1["validations"] == []
    np.testing.assert_allclose(rank0["validations"][0]["psnr"],
                               want["validations"][0]["psnr"],
                               rtol=METRIC_RTOL)
    log = (tmp_path / "two" / "logs" / "loss_log.txt").read_text()
    assert log.count("Training Losses") == 1
    # every rank wrote its rows of the validation images
    assert sorted(p.name for p in (tmp_path / "two" / "validate").iterdir()
                  ) == [f"{i}_sr.png" for i in range(6)]


def test_gan_trainer_two_ranks_equal_one(data, tmp_path, one_thread):
    want, want_p = W.gan_case(str(data))
    for res, params in W.launch("gan", 2, tmp_path / "out", [data]):
        for k, v in want.items():
            np.testing.assert_allclose(res[k], v, rtol=LOSS_RTOL, err_msg=k)
        _close_params(params, want_p)
