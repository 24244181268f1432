"""``python -m fastdiffsr_tpu_torch.msi.main --tiny --device cpu`` for the
five baselines, mirroring ``tests/test_msi_cli.py`` and
``tests/test_msi_trainer.py``: train two steps (with the epoch-end
validation and the save), ``--resume`` into validate, validateByClass
and test_single; the port's checkpoint reloads bit-equal, a JAX MSI
``state.pkl`` resumes, batched validation equals per-image validation,
and the run logs keep the reference's row format."""

import os
import types

import numpy as np
import pytest
import torch

from fastdiffsr_tpu_torch.metrics import load_img, save_img
from fastdiffsr_tpu_torch.msi import main as msi_main
from fastdiffsr_tpu_torch.msi.trainer import SupervisedSRTrainer

torch.set_num_threads(2)

MODELS = ["SwinIR", "HAT", "HSENet", "TransENet", "NDSRGAN"]


@pytest.fixture(scope="module")
def msi_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("msi_cli")
    rng = np.random.default_rng(0)
    for i in range(4):
        save_img(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8),
                 str(root / "train" / f"img_{i}.png"))
    for cls in ("forest", "river"):
        for i in range(3):
            save_img(rng.integers(0, 256, (36, 40, 3), dtype=np.uint8),
                     str(root / "test" / cls / f"{cls}{i}.png"))
    # odd sizes; TransENet's LR takes multiples of its 8x8 patches
    save_img(rng.integers(0, 256, (10, 13, 3), dtype=np.uint8),
             str(root / "single.png"))
    save_img(rng.integers(0, 256, (16, 8, 3), dtype=np.uint8),
             str(root / "single8.png"))
    return root


def _common(root, save):
    return ["--tiny", "--device", "cpu", "--scale_factor", "4",
            "--crop_size", "32", "--test_crop_size", "32",
            "--test_data_dir", str(root / "test"), "--save_dir", str(save)]


@pytest.mark.parametrize("model", MODELS)
def test_msi_main_modes(msi_data, model, tmp_path):
    root = msi_data
    common = ["--model_name", model, *_common(root, tmp_path)]
    summ = msi_main.main([*common, "--mode", "train", "--data_dir",
                          str(root / "train"), "--num_epochs", "1",
                          "--batch_size", "2", "--max_steps", "2",
                          "--log_freq", "1"])
    assert summ["steps"] == 2 and len(summ["loss"]) == 2
    assert np.isfinite(summ["loss"]).all()
    ckpt = summ["checkpoint"]
    assert os.path.basename(ckpt) == "I2_E1"
    assert np.isfinite(summ["validations"][0]["psnr"])

    # the checkpoint reloads bit-equal
    payload = torch.load(os.path.join(ckpt, "state.pt"), weights_only=True)
    args = msi_main.parse_args(common)
    args.save_dir = str(tmp_path / "reload")
    tr = SupervisedSRTrainer(msi_main.build_model(model, args), args,
                             device="cpu")
    tr.load(ckpt)
    assert tr.state.step == payload["step"] == 2
    for k, v in tr.net.state_dict().items():
        assert torch.equal(v, payload["params"][k]), k
    opt = tr.state.optimizer.state_dict()["state"]
    for i, s in payload["opt_state"]["state"].items():
        assert torch.equal(opt[i]["exp_avg_sq"], s["exp_avg_sq"])

    res = msi_main.main([*common, "--mode", "validate", "--resume", ckpt])
    assert res["psnr"] == pytest.approx(summ["validations"][0]["psnr"])
    rep = msi_main.main([*common, "--mode", "validateByClass", "--resume",
                         ckpt])
    assert set(rep) == {"forest", "river", "__overall__"}
    assert all(np.isfinite(rep[c]["psnr"]) for c in rep)

    single = root / ("single8.png" if model == "TransENet" else "single.png")
    out = tmp_path / "sr.png"
    msi_main.main([*common, "--mode", "test_single", "--resume", ckpt,
                   "--input", str(single), "--output", str(out)])
    h, w = load_img(str(single)).shape[:2]
    assert load_img(str(out)).shape == (4 * h, 4 * w, 3)

    logs = tmp_path / model / "logs"
    loss_log = (logs / "loss_log.txt").read_text()
    assert "Training Losses" in loss_log and "iter:" in loss_log
    assert f"dataset: {model} loss_G:" in loss_log
    val_log = (logs / "val_log.txt").read_text()
    assert "Validation Results" in val_log and "psnr:" in val_log


def test_device_defaults_to_cuda(msi_data, tmp_path):
    """No silent CPU: without --device the CLI asks for CUDA."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        msi_main.main(["--model_name", "HSENet", "--tiny", "--mode",
                       "test_single", "--input",
                       str(msi_data / "single.png"), "--save_dir",
                       str(tmp_path)])


def test_jax_state_pkl_resumes(msi_data, tmp_path):
    """A JAX MSI checkpoint (tiny HSENet after one step) resumes in the
    port: the converted params, Adam moments and step, then a further
    training step from there."""
    import jax

    from fastdiffsr_tpu.msi import main as jmain
    from fastdiffsr_tpu.msi.trainer import SupervisedSRTrainer as JaxTrainer
    from fastdiffsr_tpu_torch.models.convert import flax_converter

    args = types.SimpleNamespace(scale_factor=4, crop_size=32, lr=2e-4,
                                 b1=0.9, b2=0.999, log_freq=200, tiny=True,
                                 save_dir=str(tmp_path / "jax"))
    jtr = JaxTrainer(jmain.build_model("HSENet", args), args)
    rng = np.random.default_rng(1)
    jtr.state, _ = jtr._train_step(
        jtr.state, rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32),
        rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32),
        jax.random.PRNGKey(0))
    ckpt = jtr.save(1)
    assert os.path.isfile(os.path.join(ckpt, "state.pkl"))

    common = ["--model_name", "HSENet", *_common(msi_data, tmp_path)]
    args = msi_main.parse_args(common)
    args.save_dir = str(tmp_path / "port")
    tr = SupervisedSRTrainer(msi_main.build_model("HSENet", args), args,
                             device="cpu")
    tr.load(ckpt)
    assert tr.state.step == 1
    want = flax_converter("hsenet")(jax.tree_util.tree_map(
        np.asarray, jtr.state.params))
    for k, v in tr.net.state_dict().items():
        assert torch.equal(v, want[k]), k
    mu = flax_converter("hsenet")(jax.tree_util.tree_map(
        np.asarray, jtr.state.opt_state[0].mu))
    names = [n for n, _ in tr.net.named_parameters()]
    opt = tr.state.optimizer.state_dict()["state"]
    for i, n in enumerate(names):
        assert torch.equal(opt[i]["exp_avg"], mu[n]), n
        assert opt[i]["step"].item() == 1
    summ = msi_main.main([*common, "--mode", "train", "--resume", ckpt,
                          "--data_dir", str(msi_data / "train"),
                          "--batch_size", "2", "--max_steps", "2"])
    assert summ["steps"] == 1 and os.path.basename(
        summ["checkpoint"]) == "I2_E1"


def test_batched_validation_equals_per_image(msi_data, tmp_path):
    """eval batch 4 (a padded tail) and 8 (one padded batch) give the
    metrics of batch 1, in validate and validate_by_class."""
    def make(eval_batch):
        args = msi_main.parse_args(["--model_name", "SwinIR",
                                    *_common(msi_data, tmp_path),
                                    "--eval_batch_size", str(eval_batch)])
        return SupervisedSRTrainer(msi_main.build_model("SwinIR", args),
                                   args, device="cpu")
    test = [str(msi_data / "test")]
    res = {b: make(b).validate(test, save_images=False) for b in (1, 4, 8)}
    for b in (4, 8):
        for k in ("psnr", "ssim", "ergas", "mse"):
            assert res[b][k] == pytest.approx(res[1][k], rel=1e-6)
    rep1, rep8 = make(1).validate_by_class(test), make(8).validate_by_class(
        test)
    for cls in ("forest", "river"):
        assert rep8[cls]["psnr"] == pytest.approx(rep1[cls]["psnr"],
                                                  rel=1e-6)


def test_log_rows_match_jax(tmp_path):
    """loss_log.txt / val_log.txt rows are the JAX logger's, character
    for character."""
    from fastdiffsr_tpu.msi.logger import MSILogger as JaxLogger
    from fastdiffsr_tpu_torch.msi.logger import MSILogger

    ours, theirs = (MSILogger("SwinIR", str(tmp_path / "a")),
                    JaxLogger("SwinIR", str(tmp_path / "b")))
    for mode, row in (("train", {"epoch": 3, "iters": 12345, "time": 7.25,
                                 "model": "SwinIR", "lr": 2e-4,
                                 "loss_G": 0.0123}),
                      ("val", {"epoch": 0, "iters": 7, "time": 0.0,
                               "model": "SwinIR", "psnr": 27.123456,
                               "ssim": 0.81})):
        assert ours.print_format_results(mode, row) == \
            theirs.print_format_results(mode, row)
    for name in ("loss_log.txt", "val_log.txt"):
        a = (tmp_path / "a" / name).read_text().splitlines()
        b = (tmp_path / "b" / name).read_text().splitlines()
        assert a[2:] == b[2:] and len(a) == 3
