"""The port's reference-compatible DDPM wrapper (``fastdiffsr_tpu_torch.
model_api``) on the CPU at the sizes of tests/test_model_api.py (16x16,
inner 8, mults [1, 2], train T=6, val T=4): the JAX tests' cases
(feed_data / optimize / test / schedule hot-swap / checkpoint round
trip, unconditional sample), the continous trajectory against JAX's
``engine.sample(return_trajectory=True)`` with the same weights and
injected noise, ``count_parameters`` against JAX's ``param_count``, and
``optimize_parameters`` against a direct ``make_train_step`` call."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdiffsr_tpu.diffusion import (DiffusionEngine as JaxEngine,
                                      DiffusionSpec as JaxSpec,
                                      ScheduleBuffers as JaxBuffers)
from fastdiffsr_tpu.models.unet_fastdiffsr import FastDiffSRUNet as FlaxUNet
from fastdiffsr_tpu.utils.profiling import param_count as jax_param_count
from fastdiffsr_tpu_torch.config import dict_to_nonedict
from fastdiffsr_tpu_torch.model_api import create_model, define_G
from fastdiffsr_tpu_torch.models.convert import flax_params_to_torch
from fastdiffsr_tpu_torch.serving import draw_noise
from fastdiffsr_tpu_torch.train import make_train_step, step_generator
from fastdiffsr_tpu_torch.train.steps import image_generator

torch.set_num_threads(2)

# the UNet trajectory against JAX's Flax UNet: the fused forward's
# one-pass GroupNorm statistics against Flax's two passes (see
# tests/test_torch_serving.py's UNET_JAX_ATOL, 1.6e-5 after T=4)
TRAJ_ATOL = 1e-4


def _opt(tmp_path):
    return dict_to_nonedict({
        "phase": "train",
        "path": {"checkpoint": str(tmp_path / "ckpt"),
                 "resume_state": None},
        "model": {
            "which_model_G": "fastdiffsr",
            "unet": {"in_channel": 6, "out_channel": 3,
                     "inner_channel": 8, "norm_groups": 4,
                     "channel_multiplier": [1, 2], "attn_res": [8],
                     "res_blocks": 1, "dropout": 0.0},
            "beta_schedule": {
                "train": {"schedule": "linear_cosine", "n_timestep": 6,
                          "linear_start": 1e-6, "linear_end": 1e-2},
                "val": {"schedule": "linear_cosine", "n_timestep": 4,
                        "linear_start": 1e-6, "linear_end": 1e-2}},
            "diffusion": {"image_size": 16, "channels": 3,
                          "conditional": True},
        },
        "train": {"optimizer": {"type": "adam", "lr": 1e-3},
                  "ema_scheduler": {"step_start_ema": 100,
                                    "ema_decay": 0.99}},
    })


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"HR": rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32),
            "SR": rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)}


def test_wrapper_roundtrip(tmp_path):
    m = create_model(_opt(tmp_path), device="cpu")
    assert m.count_parameters() > 0

    m.feed_data(_batch())
    m.optimize_parameters()
    m.optimize_parameters()
    assert np.isfinite(m.get_current_log()["l_pix"])
    assert m.state.step == 2

    # schedule hot-swap to val (T=4) then sample
    m.set_new_noise_schedule(schedule_phase="val")
    assert m.engine.buffers.num_timesteps == 4
    sr = m.test(continous=False)
    assert sr.shape == (2, 16, 16, 3)
    vis = m.get_current_visuals()
    assert set(vis) >= {"SR", "INF", "HR"}
    assert isinstance(vis["SR"], np.ndarray)

    traj = m.test(continous=True)
    assert traj is m.SR and traj.shape == (4, 2, 16, 16, 3)
    # the same per-image generators every call: the last frame is test()
    assert torch.equal(traj[-1], sr)

    # checkpoint round trip, in the I{iter}_E{epoch} layout of sr_mfe
    path = m.save_network(epoch=1, iter_step=2)
    assert path.endswith("I2_E1")
    opt2 = _opt(tmp_path)
    opt2["path"]["resume_state"] = path
    m2 = create_model(opt2, device="cpu")
    assert m2.begin_step == 2 and m2.begin_epoch == 1
    for k, v in m.state.net.state_dict().items():
        assert torch.equal(v, m2.state.net.state_dict()[k])
    for k, v in m.state.ema_params.items():
        assert torch.equal(v, m2.state.ema_params[k])


def test_unconditional_sample(tmp_path):
    """model.py:70-77 unconditional sample(): the reference's
    unconditional branch never applies res2img, so a residual-space spec
    with cond=None returns the raw sampled tensor."""
    opt = _opt(tmp_path)
    opt["model"]["unet"]["in_channel"] = 3
    opt["model"]["diffusion"]["conditional"] = False
    m = create_model(opt, device="cpu")
    m.set_new_noise_schedule(schedule_phase="val")
    out = m.sample(batch_size=2)
    assert out.shape == (2, 16, 16, 3)
    assert torch.isfinite(out).all()
    traj = m.sample(batch_size=2, continous=True)
    assert traj.shape == (4, 2, 16, 16, 3) and torch.equal(traj[-1], out)
    assert set(m.get_current_visuals(sample=True)) == {"SAM"}


@pytest.fixture(scope="module")
def flax_pair():
    net = FlaxUNet(inner_channel=8, norm_groups=4, channel_mults=(1, 2),
                   res_blocks=1, dropout=0.0)
    params = jax.jit(net.init)(jax.random.PRNGKey(3),
                               jnp.zeros((1, 16, 16, 6)),
                               jnp.ones((1,)))["params"]
    return net, params


def test_count_parameters_matches_jax(tmp_path, flax_pair):
    m = create_model(_opt(tmp_path), device="cpu")
    assert m.count_parameters() == jax_param_count(flax_pair[1])


def test_trajectory_matches_jax(tmp_path, flax_pair):
    """test(continous=True) on the JAX weights against JAX's
    engine.sample(return_trajectory=True) with the noise the wrapper's
    generators draw (image i: image_generator(seed, i), in the sampler's
    order)."""
    flax_net, params = flax_pair
    m = create_model(_opt(tmp_path), device="cpu")
    m.state.net.load_state_dict(flax_params_to_torch(
        jax.tree_util.tree_map(np.asarray, params)))
    m.set_new_noise_schedule(schedule_phase="val")
    batch = _batch(1)
    m.feed_data(batch)
    traj = m.test(continous=True)
    gens = [image_generator(m.sample_seed, i, "cpu") for i in range(2)]
    init, seq = draw_noise(gens, (16, 16, 3), 4, True, "cpu")
    jeng = JaxEngine(JaxSpec.for_variant("fastdiffsr"), JaxBuffers.create(
        _opt(tmp_path)["model"]["beta_schedule"]["val"]))

    def denoise(x_in, level):
        return flax_net.apply({"params": params}, x_in, level,
                              deterministic=True)

    final, jtraj = jeng.sample(denoise, jnp.asarray(batch["SR"]),
                               jax.random.PRNGKey(0),
                               return_trajectory=True,
                               init_noise=jnp.asarray(init.numpy()),
                               noise_seq=jnp.asarray(seq.numpy()))
    assert traj.shape == jtraj.shape == (4, 2, 16, 16, 3)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=0,
                               atol=TRAJ_ATOL)
    np.testing.assert_allclose(traj[-1].numpy(), np.asarray(final), rtol=0,
                               atol=TRAJ_ATOL)


def test_optimize_parameters_is_make_train_step(tmp_path):
    """A step of the wrapper is make_train_step with the step's generator
    (train.step_generator(seed, step)): the same loss bit for bit, the
    same parameters after it."""
    opt = _opt(tmp_path)
    opt["seed"] = 5
    m = create_model(opt, device="cpu")
    twin_state = copy.deepcopy(m.state)
    m.feed_data(_batch(2))
    m.optimize_parameters()
    step = make_train_step(m.engine, ema_decay=0.99,
                           ema_start=100)
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    _, metrics = step(twin_state, batch, step_generator(5, 0, "cpu"))
    assert float(metrics["l_pix"]) == m.get_current_log()["l_pix"]
    for k, v in m.state.net.state_dict().items():
        assert torch.equal(v, twin_state.net.state_dict()[k])


def test_define_G_and_device(tmp_path):
    spec, net = define_G(_opt(tmp_path), device="cpu")
    assert spec.target_space == "residual" and not net.training
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model(_opt(tmp_path))


@pytest.mark.parametrize("val_seed,want", [(None, 5), (0, 0), (7, 7)])
def test_val_seed_keys_the_sampling_noise(tmp_path, val_seed, want):
    """opt['val_seed'] seeds test()/sample()'s generators, 0 included (as
    cli/sr_mfe.py reads it); unset, the train seed does."""
    opt = _opt(tmp_path)
    opt["seed"], opt["val_seed"] = 5, val_seed
    assert create_model(opt, device="cpu").sample_seed == want
