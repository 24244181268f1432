"""The serving export of a plain-forward variant on the CPU: a tiny SR3
UNet (ddpm) sampled by DDIM, whose every GroupNorm -> Swish is K1
(``ops.groupnorm._GNSwish`` around the public wrapper). Through
``torch.export`` K1 enters the graph as ``fdsr::gn_swish`` (as many
nodes as an eager forward makes K1 calls, per eval); the artifact,
saved and loaded, is held against the in-process sampler with the same
per-image generators (abs 1e-5) and against the JAX package's
``sample_ddim`` on the same weights and initial noise (abs 1e-4: Flax's
GroupNorm takes two-pass statistics, K1's plain version one pass).
The same UNet's ancestral sampler in the serving export's scan form
(noise from seeds, K1 inside the scan's body) against the in-process
sampler and JAX's ``engine.sample`` fed the artifact's draws. Every Flax
leaf is seeded (``jax.eval_shape`` gives the tree; no init program is
compiled), then converted with the port's converter."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from fastdiffsr_tpu.diffusion import (DiffusionEngine as JaxEngine,
                                      DiffusionSpec as JaxSpec,
                                      ScheduleBuffers as JaxBuffers)
from fastdiffsr_tpu.models.unet_sr3 import SR3UNet as FlaxSR3
from fastdiffsr_tpu_torch import serving
from fastdiffsr_tpu_torch.cli.infer import make_denoiser
from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine, DiffusionSpec,
                                            ScheduleBuffers)
from fastdiffsr_tpu_torch.models.convert import flax_sr3_params_to_torch
from fastdiffsr_tpu_torch.models.unet_sr3 import SR3UNet
from fastdiffsr_tpu_torch.train import make_sample_fn, pad_batch_with_keys

torch.set_num_threads(2)

SIZE = 16
STEPS = 2
ATOL = 1e-5
JAX_ATOL = 1e-4
SR3_KW = dict(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
              attn_res=(8,), res_blocks=1, image_size=SIZE)
SCHED = {"schedule": "linear", "n_timestep": 50, "linear_start": 1e-4,
         "linear_end": 5e-2}


def _seeded_tree(shapes, seed):
    """Kernels N(0, 1/fan_in), norm scales 1 + 0.1 N, the rest 0.1 N."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, v in flat:
        z = rng.standard_normal(v.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            z = z / np.sqrt(np.prod(v.shape[:-1]))
        elif name == "scale":
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        out.append(z.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


class _CountK1(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += func is torch.ops.fdsr.gn_swish.default
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def sr3(tmp_path_factory):
    """(JAX engine, Flax net, params, port engine, port net, loaded
    artifact, program)."""
    flax_net = FlaxSR3(**SR3_KW)
    shapes = jax.eval_shape(flax_net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 6)), jnp.ones((1,)))
    params = _seeded_tree(shapes["params"], 0)
    net = SR3UNet(**SR3_KW, dropout=0.2).eval()
    net.load_state_dict(flax_sr3_params_to_torch(params), strict=True)
    eng = DiffusionEngine(DiffusionSpec.for_variant("ddpm"),
                          ScheduleBuffers.create(SCHED, device="cpu"))
    ep, meta = serving.build_sample_export(eng, net, SIZE, sampler="ddim",
                                           steps=STEPS, eta=0.0)
    path = str(tmp_path_factory.mktemp("serving_sr3") / "sampler_sr3.pt2")
    serving.save_exported(ep, meta, path)
    return (JaxEngine(JaxSpec.for_variant("ddpm"), JaxBuffers.create(SCHED)),
            flax_net, params, eng, net, serving.load_exported(path), ep)


def _inputs(b, seed=0):
    cond = np.random.default_rng(seed).uniform(
        -1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
    return cond, pad_batch_with_keys(cond, b, 11, 0, device="cpu")


def _params(net):
    return {k: v.detach() for k, v in net.state_dict().items()}


def test_sr3_export_runs_k1_as_its_operator(sr3):
    """The plain forward, traced: K1 as fdsr::gn_swish, once per eager K1
    call of each eval, and neither K3 nor K2."""
    *_, net, loaded, ep = sr3
    assert loaded.meta["fused"] is False and loaded.meta["evals"] == STEPS
    assert loaded.meta["step_draws"] == 0
    x = torch.zeros((1, SIZE, SIZE, 6))
    with torch.no_grad(), _CountK1() as mode:
        net(x, torch.ones((1,)))
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert mode.calls > 0
    assert targets.count(torch.ops.fdsr.gn_swish.default) == (
        mode.calls * STEPS)
    assert torch.ops.fdsr.fused_gn_swish_conv3x3.default not in targets
    assert torch.ops.fdsr.channel_stats.default not in targets


def test_sr3_artifact_matches_inprocess(sr3):
    """Batches 1 and 3 through the artifact traced at batch 2, against
    make_sample_fn on the plain forward with the same generators."""
    *_, eng, net, loaded, _ = sr3
    direct = make_sample_fn(eng, make_denoiser(net, False, torch.float32),
                            sampler="ddim", ddim_steps=STEPS)
    for b in (1, 3):
        cond, (cond_t, gens) = _inputs(b)
        got = loaded(_params(net), cond_t, gens)
        want = direct(cond_t, _inputs(b)[1][1])
        assert got.shape == (b, SIZE, SIZE, 3)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=ATOL)


def test_sr3_artifact_matches_jax_ddim(sr3):
    """The artifact fed the initial noise load_exported draws against
    JAX's sample_ddim on the Flax SR3 UNet with the same weights."""
    jeng, flax_net, params, _, net, loaded, _ = sr3
    cond, (cond_t, gens) = _inputs(2, seed=1)
    init, seq = loaded.noise(cond_t, gens)
    assert seq is None
    got = loaded.call(_params(net), cond_t, init)

    def denoise(x_in, level):
        return flax_net.apply({"params": params}, x_in, level,
                              deterministic=True)

    want = np.asarray(jeng.sample_ddim(
        denoise, jnp.asarray(cond), jax.random.PRNGKey(0), steps=STEPS,
        init_noise=jnp.asarray(init.numpy())))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_ATOL)


@pytest.fixture(scope="module")
def sr3_scan(sr3, tmp_path_factory):
    """The SR3 UNet's ancestral sampler (T=50, the schedule's own) in the
    scan form on the plain forward, saved and loaded, and its program."""
    *_, eng, net, _, _ = sr3
    ep, meta = serving.build_sample_export(eng, net, SIZE, loop=True)
    path = str(tmp_path_factory.mktemp("serving_sr3_scan") / "scan.pt2")
    serving.save_exported(ep, meta, path)
    return serving.load_exported(path), ep


def test_sr3_scan_runs_k1_in_its_body(sr3, sr3_scan):
    """The scan form of the plain forward: K1 as fdsr::gn_swish in the
    scan's body, once per eager K1 call of one eval, none outside it."""
    net = sr3[4]
    loaded, ep = sr3_scan
    assert (loaded.meta["loop"], loaded.meta["evals"]) == ("scan", 50)
    with torch.no_grad(), _CountK1() as mode:
        net(torch.zeros((1, SIZE, SIZE, 6)), torch.ones((1,)))
    body, = list(ep.graph_module.children())
    k1 = torch.ops.fdsr.gn_swish.default
    assert [n.target for n in ep.graph.nodes].count(k1) == 0
    assert [n.target for n in body.graph.nodes].count(k1) == mode.calls > 0


def test_sr3_scan_matches_inprocess_and_jax(sr3, sr3_scan):
    """All 50 ancestral steps of the scan artifact against the in-process
    sampler (ATOL) and JAX's engine.sample on the Flax SR3 UNet
    (JAX_ATOL), both fed the draws the artifact made from its seeds."""
    jeng, flax_net, params, eng, net, _, _ = sr3
    loaded = sr3_scan[0]
    cond, (cond_t, gens) = _inputs(2, seed=2)
    got = loaded(_params(net), cond_t, gens)
    init, seq = loaded.sampler_noise(cond_t, _inputs(2, seed=2)[1][1])
    want = make_sample_fn(eng, make_denoiser(net, False, torch.float32))(
        cond_t, init_noise=init, noise_seq=seq)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=ATOL)

    def denoise(x_in, level):
        return flax_net.apply({"params": params}, x_in, level,
                              deterministic=True)

    jwant = np.asarray(jeng.sample(
        denoise, jnp.asarray(cond), jax.random.PRNGKey(0),
        init_noise=jnp.asarray(init.numpy()),
        noise_seq=jnp.asarray(seq.numpy())))
    assert np.abs(jwant).max() > 0.1
    np.testing.assert_allclose(got.numpy(), jwant, rtol=0, atol=JAX_ATOL)
