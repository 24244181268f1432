"""The port's train/val CLI (``fastdiffsr_tpu_torch.cli.sr_mfe``) on the
CPU at a tiny size (inner 8, groups 4, mults [1, 2], 1 res block,
8->16): -debug train -> I*_E* checkpoint -> val, resume, the device-cache
loop, a JAX checkpoint in the val phase, the infer CLI on trainer
checkpoints, and -dist without torchrun's variables."""

import json
import logging

import numpy as np
import pytest
import torch

from fastdiffsr_tpu_torch.cli import infer, sr_mfe
from fastdiffsr_tpu_torch.data import LRHRDataset, write_pack
from tests.conftest import REPO_ROOT

torch.set_num_threads(2)


def _config(tmp_path, dataroot="absent", **train):
    cfg = json.loads((REPO_ROOT / "fastdiffsr_tpu_torch" / "configs"
                      / "sr_fastdiffsr_train_64_256.json").read_text())
    cfg["name"] = "unit"
    for ds in cfg["datasets"].values():
        ds.update(dataroot=str(tmp_path / dataroot), l_resolution=8,
                  r_resolution=16, num_workers=1)
    if dataroot != "absent":
        for ds in cfg["datasets"].values():
            ds["datatype"] = "npy"
    cfg["datasets"]["train"]["batch_size"] = 2
    cfg["datasets"]["val"]["data_len"] = 2
    cfg["model"]["unet"].update(inner_channel=8, norm_groups=4,
                                channel_multiplier=[1, 2], res_blocks=1)
    for ph in ("train", "val"):
        cfg["model"]["beta_schedule"][ph]["n_timestep"] = 4
    cfg["train"].update(n_iter=4, val_freq=1000, print_freq=2,
                        save_checkpoint_freq=1000)
    cfg["train"]["ema_scheduler"].update(step_start_ema=0, ema_decay=0.5)
    cfg["train"].update(train)
    return cfg


def _write(tmp_path, cfg, name="cfg.json"):
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(autouse=True)
def _fresh_loggers(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    for name in ("base", "val"):
        lg = logging.getLogger(name)
        for h in list(lg.handlers):
            lg.removeHandler(h)
            h.close()


def _run_dir(tmp_path):
    return sorted((tmp_path / "experiments").iterdir())[-1]


@pytest.mark.parametrize("use_ema", [False, True])
def test_debug_train_then_val(tmp_path, monkeypatch, use_ema):
    """-debug synthesizes the data, trains 8 steps with validation every
    2 and saves I{iter}_E{epoch}; -p val then reads the checkpoint's
    params or EMA params. Both phases run float32 without TF32."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    cfg = _write(tmp_path, _config(tmp_path, n_iter=100))   # -debug: 8
    out = sr_mfe.main(["-p", "train", "-c", cfg, "-debug", "--device", "cpu",
                       "-gpu", "0"])
    run = _run_dir(tmp_path)
    assert out["steps"] == 8 and len(out["l_pix"]) == 8
    assert np.isfinite(out["l_pix"]).all()
    # 6 synthetic images at batch 2: 3 steps per epoch
    assert out["checkpoint"].endswith("I8_E3")
    assert {p.name for p in (run / "checkpoint").iterdir()} == {
        "I3_E1", "I6_E2", "I8_E3"}
    log = (run / "logs" / "train.log").read_text()
    assert "l_pix" in log and "(avg " in log
    assert "float32 without TF32" in log and "-gpu 0 accepted" in log
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert (run / "logs" / "val.log").read_text().count("# Validation #") == 4

    vcfg = json.loads(open(cfg).read())
    vcfg["path"]["resume_state"] = out["checkpoint"]
    res = sr_mfe.main(["-p", "val", "-c", _write(tmp_path, vcfg, "v.json"),
                       "-debug", "--device", "cpu"]
                      + (["-use_ema"] if use_ema else []))
    assert set(res) >= {"psnr", "ssim", "mse", "ergas"}
    assert np.isfinite([res["psnr"], res["ssim"]]).all()
    loaded = f"loaded {'EMA ' if use_ema else ''}params from"
    assert loaded in (run / "logs" / "train.log").read_text()


def test_resume_continues_the_run(tmp_path):
    write_pack(str(tmp_path / "pack"), 6, 1, 8, 16)
    cfg = _config(tmp_path, "pack")
    first = sr_mfe.main(["-p", "train", "-c", _write(tmp_path, cfg),
                         "--device", "cpu"])
    assert first["step"] == 4
    cfg["train"]["n_iter"] = 6
    cfg["path"]["resume_state"] = first["checkpoint"]
    out = sr_mfe.main(["-p", "train", "-c", _write(tmp_path, cfg, "r.json"),
                       "--device", "cpu"])
    assert out["steps"] == 2 and out["step"] == 6
    payload = torch.load(f"{out['checkpoint']}/state.pt", weights_only=True)
    assert payload["step"] == 6
    assert payload["opt_state"]["state"][0]["step"].item() == 6


def test_device_cache_loop(tmp_path):
    write_pack(str(tmp_path / "pack"), 6, 2, 8, 16)
    cfg = _config(tmp_path, "pack")
    cfg["datasets"]["train"]["device_cache"] = True
    out = sr_mfe.main(["-p", "train", "-c", _write(tmp_path, cfg),
                       "--device", "cpu"])
    assert out["step"] == 4 and np.isfinite(out["l_pix"]).all()
    assert "device-resident dataset: 6 tiles" in (
        _run_dir(tmp_path) / "logs" / "train.log").read_text()


def test_val_reads_a_jax_checkpoint(tmp_path):
    """-p val on a JAX ``save_state`` pickle gives the same metrics as on
    the port's own checkpoint of the same (converted) params."""
    import jax
    import jax.numpy as jnp

    from fastdiffsr_tpu.models.unet_fastdiffsr import FastDiffSRUNet
    from fastdiffsr_tpu.train import create_train_state as jax_state
    from fastdiffsr_tpu.train.checkpoint import save_state as jax_save
    from fastdiffsr_tpu.train.state import make_optimizer as jax_opt
    from fastdiffsr_tpu_torch.models.convert import flax_params_to_torch
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.train import create_train_state, make_optimizer
    from fastdiffsr_tpu_torch.train.checkpoint import save_state

    write_pack(str(tmp_path / "pack"), 2, 3, 8, 16)
    cfg = _config(tmp_path, "pack")
    flax_net = FastDiffSRUNet(inner_channel=8, norm_groups=4,
                              channel_mults=(1, 2), res_blocks=1)
    params = jax.jit(flax_net.init)(jax.random.PRNGKey(4),
                                    jnp.zeros((1, 16, 16, 6)),
                                    jnp.ones((1,)))["params"]
    jax_dir = jax_save(jax_state(params, jax_opt({})), str(tmp_path / "jck"),
                       epoch=0)
    net = unet_from_config(cfg["model"]["unet"], device="cpu")
    net.load_state_dict(flax_params_to_torch(
        jax.tree_util.tree_map(np.asarray, params)))
    torch_dir = save_state(create_train_state(
        net, make_optimizer(net.parameters())), str(tmp_path / "tck"))
    res = []
    for i, ck in enumerate((jax_dir, torch_dir)):
        cfg["path"]["resume_state"] = ck
        res.append(sr_mfe.main(["-p", "val", "-c",
                                _write(tmp_path, cfg, f"v{i}.json"),
                                "--device", "cpu"]))
    for k in ("psnr", "ssim", "mse"):
        np.testing.assert_allclose(res[0][k], res[1][k], rtol=1e-6)


def test_infer_reads_trainer_checkpoints(tmp_path, monkeypatch):
    """cli.infer takes an I{iter}_E{epoch} directory as resume_state: its
    params, or its EMA params with -use_ema (which differ after training
    with EMA decay 0.5), and runs float32 without TF32."""
    write_pack(str(tmp_path / "pack"), 6, 5, 8, 16)
    cfg = _config(tmp_path, "pack")
    ck = sr_mfe.main(["-p", "train", "-c", _write(tmp_path, cfg),
                      "--device", "cpu"])["checkpoint"]
    cfg["path"]["resume_state"] = ck
    icfg = _write(tmp_path, cfg, "infer.json")
    outs = {}
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    for flags in ([], ["-use_ema"]):
        s = infer.main(["-c", icfg, "--device", "cpu", "--dtype", "f32",
                        *flags])
        assert s["images"] == 2
        outs[bool(flags)] = [np.asarray(bytearray(open(
            f"{s['results']}/{i}_sr.png", "rb").read())) for i in range(2)]
    assert not torch.backends.cudnn.allow_tf32
    log = (_run_dir(tmp_path) / "logs" / "infer.log").read_text()
    assert f"loaded params from {ck}" in log
    assert f"loaded EMA params from {ck}" in log
    assert any(a.shape != b.shape or (a != b).any()
               for a, b in zip(outs[False], outs[True]))


TORCHRUN_ENV = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500"}


@pytest.mark.parametrize("missing", [tuple(TORCHRUN_ENV), ("MASTER_PORT",)])
def test_dist_without_torchrun_raises_naming_the_variables(
        tmp_path, monkeypatch, missing):
    """-dist never runs as one quiet process: without torchrun's
    variables it raises and names the missing ones."""
    for k, v in TORCHRUN_ENV.items():
        if k in missing:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="torchrun") as err:
        sr_mfe.main(["-c", _write(tmp_path, _config(tmp_path)), "-dist",
                     "--device", "cpu"])
    assert all(k in str(err.value) for k in missing)
    assert not any(k in str(err.value) for k in TORCHRUN_ENV
                   if k not in missing)


def test_train_cli_refuses_silent_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is honoured")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sr_mfe.main(["-c", _write(tmp_path, _config(tmp_path))])


def test_write_pack_is_seeded_and_readable(tmp_path):
    a = write_pack(str(tmp_path / "a"), 3, 7, 8, 16)
    b = write_pack(str(tmp_path / "b"), 3, 7, 8, 16)
    for name in ("hr_16.npy", "sr_8_16.npy"):
        x, y = np.load(f"{a}/{name}"), np.load(f"{b}/{name}")
        assert x.shape == (3, 16, 16, 3) and x.dtype == np.uint8
        np.testing.assert_array_equal(x, y)
    ds = LRHRDataset(a, datatype="npy", l_resolution=8, r_resolution=16)
    item = ds[2]
    assert len(ds) == 3 and item["HR"].shape == (16, 16, 3)
    assert -1.0 <= item["SR"].min() and item["SR"].max() <= 1.0


def test_val_seed_keys_the_validation_noise(tmp_path):
    """A config's val_seed seeds the validation generators in place of
    --seed (JAX cli/sr_mfe.py:183), on the same checkpoint."""
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.train import create_train_state, make_optimizer
    from fastdiffsr_tpu_torch.train.checkpoint import save_state

    write_pack(str(tmp_path / "pack"), 2, 3, 8, 16)
    cfg = _config(tmp_path, "pack")
    net = unet_from_config(cfg["model"]["unet"], device="cpu", seed=1)
    cfg["path"]["resume_state"] = save_state(
        create_train_state(net, make_optimizer(net.parameters())),
        str(tmp_path / "ck"))
    res = {}
    for name, val_seed, seed in (("keyed", 5, "0"), ("seeded", None, "5"),
                                 ("default", None, "0")):
        run = dict(cfg, val_seed=val_seed)
        res[name] = sr_mfe.main(["-p", "val", "-c",
                                 _write(tmp_path, run, f"{name}.json"),
                                 "--device", "cpu", "--seed", seed])
    for k in ("psnr", "ssim", "mse"):
        assert res["keyed"][k] == res["seeded"][k]
    assert res["keyed"]["mse"] != res["default"]["mse"]


def test_steps_per_call_above_one_raises(tmp_path):
    """train.steps_per_call (once refused) chains the device-cache loop:
    2 steps per call over 4 steps give the unchained run's losses and
    final checkpoint bit for bit."""
    write_pack(str(tmp_path / "pack"), 6, 2, 8, 16)
    out, states = {}, {}
    for chain in (1, 2):
        cfg = _config(tmp_path, "pack", steps_per_call=chain)
        cfg["name"] = f"chain{chain}"
        cfg["datasets"]["train"]["device_cache"] = True
        out[chain] = sr_mfe.main(["-p", "train", "-c",
                                  _write(tmp_path, cfg), "--device", "cpu"])
        states[chain] = torch.load(f"{out[chain]['checkpoint']}/state.pt",
                                   weights_only=True)
    log = (_run_dir(tmp_path) / "logs" / "train.log").read_text()
    assert "device-cache loop: 2 steps per call" in log
    assert out[2]["step"] == 4 and out[2]["l_pix"] == out[1]["l_pix"]
    for key in ("params", "ema_params"):
        for k, v in states[1][key].items():
            assert torch.equal(v, states[2][key][k]), (key, k)
