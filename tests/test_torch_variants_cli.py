"""The port's CLIs on the ddpm, tesr and gdp variants, on the CPU at a
tiny width (SR3: inner 8, groups 4, mults [1, 2], attention at 8x8;
guided: 32 channels, mults [1, 2]; 8->16): ``sr_mfe -p train`` then
``-p val`` on -debug data with DDIM and a 2-sample mean, the K-sample
mean's batch invariance, ``infer`` and ``load_state`` on JAX pickle
checkpoints of SR3 and guided trees, and ``--fused`` refused for them."""

import functools
import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdiffsr_tpu.models.unet_guided import GuidedUNet as FlaxGuided
from fastdiffsr_tpu.models.unet_sr3 import SR3UNet as FlaxSR3
from fastdiffsr_tpu.train import create_train_state as jax_state
from fastdiffsr_tpu.train.checkpoint import save_state as jax_save
from fastdiffsr_tpu.train.state import make_optimizer as jax_opt
from fastdiffsr_tpu_torch.cli import infer, sr_mfe
from fastdiffsr_tpu_torch.cli.infer import build_unet, resolve_fused
from fastdiffsr_tpu_torch.data import write_pack
from fastdiffsr_tpu_torch.models.convert import flax_converter
from fastdiffsr_tpu_torch.models.unet_guided import GuidedUNet
from fastdiffsr_tpu_torch.models.unet_sr3 import SR3UNet
from fastdiffsr_tpu_torch.train import create_train_state, make_optimizer
from fastdiffsr_tpu_torch.train.checkpoint import load_state, save_state
from tests.conftest import REPO_ROOT
from tests.test_torch_unet_variants import randomize

torch.set_num_threads(2)

UNETS = {"ddpm": dict(inner_channel=8, norm_groups=4,
                      channel_multiplier=[1, 2], res_blocks=1, attn_res=[8]),
         "gdp": dict(model_channels=32, inner_channel=8,
                     channel_multiplier=[1, 2], res_blocks=1)}
UNETS["tesr"] = UNETS["ddpm"]


def _config(tmp_path, variant, dataroot="absent", **diffusion):
    cfg = json.loads((REPO_ROOT / "fastdiffsr_tpu_torch" / "configs"
                      / f"sr_{variant}_train_64_256.json").read_text())
    cfg["name"] = f"unit_{variant}"
    for ds in cfg["datasets"].values():
        ds.update(dataroot=str(tmp_path / dataroot), l_resolution=8,
                  r_resolution=16, num_workers=1)
        if dataroot != "absent":
            ds["datatype"] = "npy"
    cfg["datasets"]["train"]["batch_size"] = 2
    cfg["datasets"]["val"]["data_len"] = 2
    cfg["model"]["unet"] = dict(UNETS[variant], dropout=0.1)
    cfg["model"]["diffusion"].update(image_size=16, **diffusion)
    for ph in ("train", "val"):
        cfg["model"]["beta_schedule"][ph]["n_timestep"] = 10
    cfg["train"].update(n_iter=4, val_freq=1000, print_freq=2,
                        save_checkpoint_freq=1000)
    cfg["train"]["ema_scheduler"].update(step_start_ema=0, ema_decay=0.5)
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


@pytest.mark.parametrize("variant", ["ddpm", "tesr", "gdp"])
def test_debug_train_then_val(tmp_path, variant):
    """-debug: 8 train steps with validation every 2 (DDIM, 3 steps, the
    mean of 2 samples per image), then -p val from the checkpoint on the
    plain forward."""
    cfg = _config(tmp_path, variant, sampler="ddim", ddim_steps=3,
                  n_samples=2)
    cfg["train"]["n_iter"] = 100                 # -debug caps it at 8
    out = sr_mfe.main(["-p", "train", "-c", _write(tmp_path, cfg), "-debug",
                       "--device", "cpu"])
    assert out["steps"] == 8 and np.isfinite(out["l_pix"]).all()
    run = sorted((tmp_path / "experiments").iterdir())[-1]
    log = (run / "logs" / "train.log").read_text()
    assert f"{variant}: device cpu" in log and "plain forward" in log
    vlog = (run / "logs" / "val.log").read_text()
    assert vlog.count("# Validation #") == 4
    assert "mean of 2 samples" in vlog and "per pass" in vlog
    vcfg = json.loads(json.dumps(cfg))
    vcfg["path"]["resume_state"] = out["checkpoint"]
    res = sr_mfe.main(["-p", "val", "-c", _write(tmp_path, vcfg, "v.json"),
                       "-debug", "--device", "cpu"])
    assert np.isfinite([res["psnr"], res["ssim"], res["avg_time"]]).all()


def test_sample_mean_is_batch_invariant(tmp_path):
    """n_samples 2 with DDIM eta > 0: the val set at batch 1 and at batch
    3 gives the same per-image means (each pass and image has its own
    generator), up to the last float32 bits of the UNet (PSNR within
    0.01 dB), and differs from a single sample."""
    write_pack(str(tmp_path / "pack"), 3, 4, 8, 16)
    res = {}
    for bs, k in ((1, 2), (3, 2), (3, 1)):
        cfg = _config(tmp_path, "ddpm", "pack", sampler="ddim", ddim_steps=4,
                      ddim_eta=0.8, n_samples=k)
        cfg["datasets"]["val"].update(batch_size=bs, data_len=3)
        res[bs, k] = sr_mfe.main(["-p", "val", "-c",
                                  _write(tmp_path, cfg, f"v{bs}{k}.json"),
                                  "--device", "cpu"])
    assert abs(res[1, 2]["psnr"] - res[3, 2]["psnr"]) < 1e-2
    assert abs(res[3, 2]["psnr"] - res[3, 1]["psnr"]) > 1e-3
    assert "avg_time_incl_setup" in res[3, 2] and "avg_time" in res[1, 2]


@functools.lru_cache(maxsize=None)
def _flax_init(variant):
    """The jitted init of a tiny Flax UNet of ``variant``, compiled once."""
    net = (FlaxGuided(image_size=16, model_channels=32, channel_mults=(1, 2),
                      res_blocks=1) if variant == "gdp"
           else FlaxSR3(inner_channel=8, norm_groups=4, channel_mults=(1, 2),
                        attn_res=(8,), res_blocks=1, image_size=16))
    return jax.jit(net.init)


def _flax_tree(variant, seed):
    params = _flax_init(variant)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 16, 16, 6)),
                                 jnp.ones((1,)))["params"]
    return randomize(jax.tree_util.tree_map(np.asarray, params), seed)


@pytest.mark.parametrize("variant", ["ddpm", "gdp"])
def test_infer_reads_a_jax_checkpoint(tmp_path, variant):
    """cli.infer on a JAX ``save_state`` pickle of an SR3 / guided tree
    (every leaf randomized) writes the same PNGs as on the port's own
    checkpoint of the converted params."""
    write_pack(str(tmp_path / "pack"), 2, 3, 8, 16)
    tree = _flax_tree(variant, 4)
    jax_dir = jax_save(jax_state(jax.tree_util.tree_map(jnp.asarray, tree),
                                 jax_opt({})), str(tmp_path / "jck"),
                       epoch=0)
    cfg = _config(tmp_path, variant, "pack", sampler="dpm", ddim_steps=3)
    net = build_unet(cfg["model"], device="cpu")
    net.load_state_dict(flax_converter(variant)(tree))
    torch_dir = save_state(create_train_state(
        net, make_optimizer(net.parameters())), str(tmp_path / "tck"))
    pngs = []
    for i, ck in enumerate((jax_dir, torch_dir)):
        cfg["path"]["resume_state"] = ck
        s = infer.main(["-c", _write(tmp_path, cfg, f"i{i}.json"),
                        "--device", "cpu", "--dtype", "f32"])
        assert s["images"] == 2
        pngs.append([open(f"{s['results']}/{j}_sr.png", "rb").read()
                     for j in range(2)])
    assert pngs[0] == pngs[1]


def test_load_state_converts_a_jax_guided_checkpoint(tmp_path):
    """Resuming from a JAX pickle of a gdp run: params, EMA params and
    Adam's moments go through the guided converter."""
    tree, mu, nu = (_flax_tree("gdp", s) for s in (5, 6, 7))
    st = jax_state(jax.tree_util.tree_map(jnp.asarray, tree), jax_opt({}))
    adam = st.opt_state[0]._replace(mu=mu, nu=nu, count=jnp.asarray(3))
    st = st.replace(opt_state=(adam,) + tuple(st.opt_state[1:]),
                    step=jnp.asarray(3))
    ck = jax_save(st, str(tmp_path), epoch=1)
    net = GuidedUNet(image_size=16, model_channels=32, channel_mults=(1, 2),
                     res_blocks=1)
    state = load_state(ck, create_train_state(
        net, make_optimizer(net.parameters())), "gdp")
    convert = flax_converter("gdp")
    want, want_mu = convert(tree), convert(mu)
    assert state.step == 3
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]) and torch.equal(
            state.ema_params[k], want[k]), k
    opt = state.optimizer.state_dict()["state"]
    names = [n for n, _ in net.named_parameters()]
    assert all(torch.equal(opt[i]["exp_avg"], want_mu[n])
               for i, n in enumerate(names))


@pytest.mark.parametrize("variant", ["ddpm", "tesr", "gdp"])
def test_fused_forward_is_fastdiffsr_only(tmp_path, variant):
    """The variants default to the plain forward; an explicit --fused
    raises instead of switching silently."""
    assert resolve_fused(variant, None) is False
    assert resolve_fused("fastdiffsr", None) is True
    with pytest.raises(ValueError, match="fastdiffsr' only"):
        resolve_fused(variant, True)
    cfg = _write(tmp_path, _config(tmp_path, variant))
    with pytest.raises(ValueError, match="--fused"):
        infer.main(["-c", cfg, "--device", "cpu", "--fused"])


def test_build_unet_dispatches_on_the_variant():
    for variant, cls in (("ddpm", SR3UNet), ("tesr", SR3UNet),
                         ("gdp", GuidedUNet)):
        model = {"which_model_G": variant, "unet": UNETS[variant],
                 "diffusion": {"image_size": 16}}
        assert type(build_unet(model, device="cpu")) is cls
    with pytest.raises(ValueError, match="which_model_G"):
        build_unet({"which_model_G": "sr4", "unet": {},
                    "diffusion": {"image_size": 16}}, device="cpu")


@pytest.mark.parametrize("cli,phase,autotune", [(infer, None, False),
                                               (sr_mfe, "val", False),
                                               (sr_mfe, "train", True)])
def test_clis_set_cudnn_autotuning_and_ieee_float32(tmp_path, monkeypatch,
                                                   cli, phase, autotune):
    """Before they read the config (a missing one, here) the CLIs turn
    TF32 off and set cuDNN's algorithm choice: timed for training,
    heuristics for evaluation."""
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", not autotune)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.chdir(tmp_path)
    argv = ["-c", str(tmp_path / "missing.json"), "--device", "cpu"]
    with pytest.raises(FileNotFoundError):
        cli.main(argv if phase is None else ["-p", phase, *argv])
    assert torch.backends.cudnn.benchmark is autotune
    assert not torch.backends.cudnn.allow_tf32
