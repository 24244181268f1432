"""The port's serving export (``fastdiffsr_tpu_torch.serving``) on the CPU
at the sizes of tests/test_serving.py (16x16 maps, inner 8, mults
(1, 2), T=4): the artifact, saved and loaded, against the in-process
sampler with the same per-image generators and against the JAX
package's sampler with the same injected noise; one symbolic-batch
artifact at batches it was not traced at; a static batch; a second set
of weights through the same artifact; the op registry a loading process
needs; the CLI with --selftest. The scan form (``loop=True``, noise
from seeds) of the fused UNet's sampler against the unrolled artifact,
the in-process and the JAX sampler, at other batches and weights; ddpm's
T=1000 sampler as one scan. Also ``make_sample_fn``'s trajectory output
and its refusal for DDIM and DPM-Solver++. Tolerance: float32, abs
1e-5, the JAX package's own round-trip bound."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdiffsr_tpu.diffusion import (DiffusionEngine as JaxEngine,
                                      DiffusionSpec as JaxSpec,
                                      ScheduleBuffers as JaxBuffers)
from fastdiffsr_tpu.models.unet_fastdiffsr import FastDiffSRUNet as FlaxUNet
from fastdiffsr_tpu_torch import serving
from fastdiffsr_tpu_torch.cli.infer import make_denoiser
from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine, DiffusionSpec,
                                            ScheduleBuffers)
from fastdiffsr_tpu_torch.models.convert import flax_params_to_torch
from fastdiffsr_tpu_torch.models.unet_fastdiffsr import FastDiffSRUNet
from fastdiffsr_tpu_torch.train import make_sample_fn, pad_batch_with_keys
from tests.conftest import REPO_ROOT

torch.set_num_threads(2)

SIZE = 16
ATOL = 1e-5
SCHED = {"schedule": "linear_cosine", "n_timestep": 4,
         "linear_start": 1e-6, "linear_end": 1e-2}
KW = dict(inner_channel=8, channel_mults=(1, 2), res_blocks=1,
          norm_groups=4, dropout=0.0)
CASES = [("ancestral", None), ("dpm", 3)]
W_MIX = np.random.default_rng(42).standard_normal((6, 3)).astype(
    np.float32) * 0.6
# the UNet artifact against JAX's Flax UNet: the fused forward's GroupNorm
# takes one-pass float32 statistics (E[x^2] - E[x]^2) where Flax takes two
# passes, 1.6e-5 apart after T=4 here (one forward: 5e-4,
# tests/test_torch_unet.py); the sampler program itself is held at ATOL
# with MixNet, the same function in both packages
UNET_JAX_ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    """(JAX engine, Flax net, Flax params, port engine, port net with the
    converted params)."""
    flax_net = FlaxUNet(**KW)
    params = jax.jit(flax_net.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, SIZE, SIZE, 6)),
                                    jnp.ones((1,)))["params"]
    net = FastDiffSRUNet(**KW).eval()
    net.load_state_dict(flax_params_to_torch(
        jax.tree_util.tree_map(np.asarray, params)))
    return (JaxEngine(JaxSpec.for_variant("fastdiffsr"),
                      JaxBuffers.create(SCHED)),
            flax_net, params,
            DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                            ScheduleBuffers.create(SCHED, device="cpu")),
            net)


class MixNet(torch.nn.Module):
    """A denoiser that is the same function as :func:`jax_mix` in JAX: a
    1x1 channel mix, tanh, a level-dependent gain."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(W_MIX))

    def forward(self, x_in, level):
        g = (0.5 + level).reshape(-1, 1, 1, 1)
        return torch.tanh(torch.einsum("bhwc,cd->bhwd", x_in,
                                       self.w[:x_in.shape[-1]])) * g


def jax_mix(x_in, level):
    g = (0.5 + level).reshape(-1, 1, 1, 1)
    return jnp.tanh(jnp.einsum("bhwc,cd->bhwd", x_in,
                               jnp.asarray(W_MIX[:x_in.shape[-1]]))) * g


@pytest.fixture(scope="module")
def artifacts(tiny, tmp_path_factory):
    """Symbolic-batch artifacts, saved and loaded, per sampler of CASES:
    the UNet on the fused forward (float32) and MixNet on its own
    forward."""
    _, _, _, eng, net = tiny
    root = tmp_path_factory.mktemp("serving")
    out = {}
    for sampler, steps in CASES:
        for name, den, fused in (("unet", net, True), ("mix", MixNet(),
                                                       False)):
            ep, meta = serving.build_sample_export(
                eng, den, SIZE, sampler=sampler, steps=steps, fused=fused)
            path = str(root / f"sampler_{name}_{sampler}.pt2")
            serving.save_exported(ep, meta, path)
            out[name, sampler] = (path, serving.load_exported(path))
    return out


def _inputs(b, seed=0):
    cond = np.random.default_rng(seed).uniform(
        -1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
    return cond, pad_batch_with_keys(cond, b, 7, 0, device="cpu")


def _params(net):
    return {k: v.detach() for k, v in net.state_dict().items()}


@pytest.mark.parametrize("sampler,steps", CASES)
def test_roundtrip_matches_inprocess(tiny, artifacts, sampler, steps):
    """Two batches through ONE symbolic-batch artifact traced at batch 2,
    one larger than anything traced, against make_sample_fn in process
    with the same per-image generators."""
    _, _, _, eng, net = tiny
    loaded = artifacts["unet", sampler][1]
    assert loaded.meta["batch"] is None and loaded.meta["evals"] == (
        steps or 4)
    direct = make_sample_fn(eng, make_denoiser(net, True, torch.float32),
                            sampler=sampler, ddim_steps=steps)
    for b in (2, 5):
        cond, (cond_t, gens) = _inputs(b)
        got = loaded(_params(net), cond_t, gens)
        want = direct(cond_t, _inputs(b)[1][1])
        assert got.shape == (b, SIZE, SIZE, 3)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("den", ["mix", "unet"])
@pytest.mark.parametrize("sampler,steps", CASES)
def test_artifact_matches_jax_sampler(tiny, artifacts, sampler, steps, den):
    """The artifact fed the noise load_exported draws against JAX's
    sample_dpm (as its make_sample_fn runs it) or engine.sample (whose
    per-step noise JAX takes as ``noise_seq``) on the same denoiser:
    MixNet at ATOL, the UNet on the same weights at UNET_JAX_ATOL."""
    jeng, flax_net, params, _, net = tiny
    path, loaded = artifacts[den, sampler]
    cond, (cond_t, gens) = _inputs(3, seed=1)
    init, seq = loaded.noise(cond_t, gens)
    assert (seq is None) == (sampler == "dpm")
    tnet = net if den == "unet" else MixNet()
    got = loaded.call(_params(tnet), cond_t, init, seq)

    def flax_unet(x_in, level):
        return flax_net.apply({"params": params}, x_in, level,
                              deterministic=True)

    denoise = flax_unet if den == "unet" else jax_mix
    key = jax.random.PRNGKey(0)
    if sampler == "dpm":
        want = jeng.sample_dpm(denoise, jnp.asarray(cond), key, steps=steps,
                               init_noise=jnp.asarray(init.numpy()))
    else:
        want = jeng.sample(denoise, jnp.asarray(cond), key,
                           init_noise=jnp.asarray(init.numpy()),
                           noise_seq=jnp.asarray(seq.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL if den == "mix" else UNET_JAX_ATOL)


def test_static_batch_rejects_another(tiny, tmp_path):
    """--batch 3 (MixNet: the batch is the program's, not the net's)."""
    eng = tiny[3]
    net = MixNet()
    ep, meta = serving.build_sample_export(eng, net, SIZE, batch=3,
                                           sampler="dpm", steps=1)
    path = str(tmp_path / "sampler_b3.pt2")
    serving.save_exported(ep, meta, path)
    loaded = serving.load_exported(path)
    assert loaded.meta["batch"] == 3
    out = loaded(_params(net), *_inputs(3)[1])
    assert out.shape == (3, SIZE, SIZE, 3) and torch.isfinite(out).all()
    with pytest.raises(Exception):
        loaded(_params(net), *_inputs(4)[1])


def test_second_weights_through_the_same_artifact(tiny, artifacts):
    """The artifact holds no weights: other params give the in-process
    sampler's output with those params."""
    _, _, _, eng, net = tiny
    other = FastDiffSRUNet(**KW).eval()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for k, v in other.state_dict().items():
            v.copy_(_params(net)[k]
                    + 0.05 * torch.randn(v.shape, generator=gen))
    cond, (cond_t, gens) = _inputs(2, seed=2)
    got = artifacts["unet", "ancestral"][1](_params(other), cond_t, gens)
    want = make_sample_fn(eng, make_denoiser(other, True, torch.float32))(
        cond_t, _inputs(2, seed=2)[1][1])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    first = artifacts["unet", "ancestral"][1](_params(net), cond_t,
                                      _inputs(2, seed=2)[1][1])
    assert (got - first).abs().max() > 1e-3


def test_loading_needs_the_op_registry(tmp_path):
    """A process with torch alone cannot resolve an artifact's
    torch.ops.fdsr.* operators; importing the registry
    (fastdiffsr_tpu_torch.ops) is all it needs, and loads nothing else of
    the port."""
    from fastdiffsr_tpu_torch.ops import channel_stats

    class Stats(torch.nn.Module):
        def forward(self, x):
            return channel_stats(x)

    path = str(tmp_path / "k2.pt2")
    torch.export.save(torch.export.export(
        Stats(), (torch.ones(1, 4, 4, 8),), strict=False), path)
    probe = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch\n"
         f"try:\n    torch.export.load({path!r})\n"
         "except Exception as e:\n    print('REFUSED', e)\n"
         "import fastdiffsr_tpu_torch.ops\n"
         f"ep = torch.export.load({path!r})\n"
         "print(ep.module()(torch.ones(1, 4, 4, 8)).shape)\n"
         "print(sorted(m for m in sys.modules "
         "if m.startswith('fastdiffsr_tpu')))"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert probe.returncode == 0, probe.stderr[-2000:]
    refused, shape, mods = probe.stdout.strip().splitlines()[-3:]
    assert refused.startswith("REFUSED")
    assert "torch.ops.fdsr.channel_stats" in probe.stderr
    assert shape == "torch.Size([1, 2, 8])"
    assert all(m == "fastdiffsr_tpu_torch" or m.startswith(
        "fastdiffsr_tpu_torch.ops") for m in eval(mods)), mods


def _tiny_config(tmp_path):
    cfg = json.loads((REPO_ROOT / "fastdiffsr_tpu_torch" / "configs"
                      / "sr_fastdiffsr_test_64_256.json").read_text())
    cfg["name"] = "serving_unit"
    for ds in cfg["datasets"].values():
        ds.update(l_resolution=4, r_resolution=SIZE)
    cfg["model"]["unet"].update(inner_channel=8, norm_groups=4,
                                channel_multiplier=[1, 2], res_blocks=1)
    cfg["model"]["beta_schedule"]["val"]["n_timestep"] = 3
    path = tmp_path / "serve.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_main_selftest(tmp_path, monkeypatch):
    """The CLI on a tiny config, traced on the CPU: writes the artifact,
    reloads it and holds it against the in-process sampler."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "art" / "sampler.pt2"
    res = serving.main(["-c", _tiny_config(tmp_path), "-o", str(out),
                        "--platforms", "cpu", "--sampler", "ddim",
                        "--steps", "2", "--eta", "0.5", "--selftest"])
    assert out.is_file() and res["paths"] == [str(out)]
    assert res["meta"]["evals"] == 2 and res["meta"]["step_draws"] == 2
    assert res["selftest_err"] <= ATOL


def test_refusals(tiny, tmp_path):
    _, _, _, eng, net = tiny
    with pytest.raises(ValueError, match="platform 'tpu'"):
        serving.export_sampler({}, str(tmp_path / "x.pt2"),
                               platforms=["tpu"])
    with pytest.raises(ValueError, match="sampler='euler'"):
        serving.build_sample_export(eng, net, SIZE, sampler="euler")


def _scan_nodes(ep):
    """Nodes of the program's graph and of its scan body."""
    return len(ep.graph.nodes) + sum(len(m.graph.nodes) for m in
                                     ep.graph_module.children())


def test_ddpm_t1000_exports_as_one_loop(tmp_path):
    """ddpm's own T=1000 ancestral sampler (above MAX_EXPORT_STEPS): one
    scan whose graph does not grow with T (the same nodes as at T=8), its
    noise from seeds; all 1000 steps of the loaded artifact against the
    in-process sampler fed the same draws (MixNet)."""
    def ddpm(t):
        return DiffusionEngine(DiffusionSpec.for_variant("ddpm"),
                               ScheduleBuffers.create(
                                   {"schedule": "linear", "n_timestep": t,
                                    "linear_start": 1e-4,
                                    "linear_end": 2e-2}, device="cpu"))
    long, net = ddpm(1000), MixNet()
    ep, meta = serving.build_sample_export(long, net, SIZE)
    assert (meta["loop"], meta["noise"], meta["evals"]) == (
        "scan", "counter", 1000)
    short, _ = serving.build_sample_export(ddpm(8), net, SIZE, loop=True)
    assert _scan_nodes(ep) == _scan_nodes(short)
    path = str(tmp_path / "ddpm_t1000.pt2")
    serving.save_exported(ep, meta, path)
    loaded = serving.load_exported(path)
    cond, (cond_t, gens) = _inputs(2, seed=4)
    got = loaded(_params(net), cond_t, gens)
    init, seq = loaded.sampler_noise(cond_t, _inputs(2, seed=4)[1][1])
    assert seq.shape == (1000, 2, SIZE, SIZE, 3)
    want = make_sample_fn(long, lambda x, lv: net(x, lv))(
        cond_t, init_noise=init, noise_seq=seq)
    assert torch.isfinite(got).all() and got.abs().max() > 0.1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def scan_unet(tiny, tmp_path_factory):
    """The tiny UNet's ancestral sampler in the scan form (fused forward,
    float32, symbolic batch traced at 2), saved and loaded."""
    _, _, _, eng, net = tiny
    ep, meta = serving.build_sample_export(eng, net, SIZE, fused=True,
                                           loop=True)
    path = str(tmp_path_factory.mktemp("serving_scan") / "scan_unet.pt2")
    serving.save_exported(ep, meta, path)
    return serving.load_exported(path)


def test_scan_unet_equals_unrolled_and_jax(tiny, artifacts, scan_unet):
    """The scan form of the fused UNet's sampler against the unrolled
    artifact fed the noise it drew (bit for bit), the in-process sampler
    fed it (ATOL) and JAX's engine.sample fed it (UNET_JAX_ATOL); K3 and
    K2 as their operators in the scan's body, one eval's worth, where
    the unrolled graph holds T of them."""
    jeng, flax_net, params, eng, net = tiny
    unrolled = artifacts["unet", "ancestral"][1]
    cond, (cond_t, gens) = _inputs(3, seed=6)
    got = scan_unet(_params(net), cond_t, gens)
    init, seq = scan_unet.sampler_noise(cond_t, _inputs(3, seed=6)[1][1])
    assert torch.equal(got, unrolled.call(_params(net), cond_t, init, seq))
    want = make_sample_fn(eng, make_denoiser(net, True, torch.float32))(
        cond_t, init_noise=init, noise_seq=seq)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    jwant = jeng.sample(
        lambda x_in, lv: flax_net.apply({"params": params}, x_in, lv,
                                        deterministic=True),
        jnp.asarray(cond), jax.random.PRNGKey(0),
        init_noise=jnp.asarray(init.numpy()),
        noise_seq=jnp.asarray(seq.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=0,
                               atol=UNET_JAX_ATOL)

    def count(gm, op):
        return sum(n.target == op for n in gm.graph.nodes)

    top = scan_unet.program.graph_module
    body, = list(top.children())
    for op in (torch.ops.fdsr.fused_gn_swish_conv3x3.default,
               torch.ops.fdsr.channel_stats.default):
        assert count(top, op) == 0 and count(body, op) > 0
        assert count(unrolled.program.graph_module, op) == 4 * count(body,
                                                                     op)


def test_scan_unet_batches_and_second_weights(tiny, scan_unet):
    """The scan artifact at batches 1 and 5 (traced at 2) and with other
    weights, against the in-process sampler fed its draws; image 3 of the
    batch of 5 alone gives its image (its draws follow its seed only)."""
    _, _, _, eng, net = tiny
    other = FastDiffSRUNet(**KW).eval()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for k, v in other.state_dict().items():
            v.copy_(_params(net)[k]
                    + 0.05 * torch.randn(v.shape, generator=gen))
    outs = {}
    for b, tnet in ((1, net), (5, net), (5, other)):
        cond, (cond_t, gens) = _inputs(b, seed=b)
        got = scan_unet(_params(tnet), cond_t, gens)
        init, seq = scan_unet.sampler_noise(cond_t,
                                            _inputs(b, seed=b)[1][1])
        want = make_sample_fn(eng, make_denoiser(tnet, True, torch.float32))(
            cond_t, init_noise=init, noise_seq=seq)
        assert got.shape == (b, SIZE, SIZE, 3)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=ATOL)
        outs[b, tnet is other] = (got, cond_t)
    got5, cond5 = outs[5, False]
    alone = scan_unet(_params(net), cond5[3:4], _inputs(5, seed=5)[1][1][3:4])
    np.testing.assert_allclose(alone.numpy(), got5[3:4].numpy(), rtol=0,
                               atol=ATOL)
    assert (outs[5, True][0] - got5).abs().max() > 1e-3


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_trajectory_is_ancestral_only(tiny, sampler):
    eng = tiny[3]
    with pytest.raises(ValueError, match="ancestral-only"):
        make_sample_fn(eng, None, sampler=sampler, return_trajectory=True)


@pytest.mark.parametrize("conditional", [True, False])
def test_trajectory_matches_jax(tiny, conditional):
    """engine.sample(return_trajectory=True): the (T,B,H,W,C) stack of
    every x_{t-1}, folded back through res2img when cond is given, raw
    when it is not, against JAX with the same injected noise; the last
    frame is the final image."""
    jeng, flax_net, params, eng, net = tiny
    rng = np.random.default_rng(5)
    cond = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    init = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    seq = rng.standard_normal((4, 2, SIZE, SIZE, 3)).astype(np.float32)
    w = np.random.default_rng(6).standard_normal((6, 3)).astype(np.float32)

    def jden(x_in, level):
        return jnp.tanh(jnp.einsum("bhwc,cd->bhwd", x_in,
                                   jnp.asarray(w[:x_in.shape[-1]])))

    def tden(x_in, level):
        return torch.tanh(torch.einsum("bhwc,cd->bhwd", x_in,
                                       torch.from_numpy(w[:x_in.shape[-1]])))

    shape = None if conditional else (2, SIZE, SIZE, 3)
    c_j = jnp.asarray(cond) if conditional else None
    c_t = torch.from_numpy(cond) if conditional else None
    jfin, jtraj = jeng.sample(jden, c_j, jax.random.PRNGKey(0), shape=shape,
                              return_trajectory=True,
                              init_noise=jnp.asarray(init),
                              noise_seq=jnp.asarray(seq))
    fin, traj = eng.sample(tden, c_t, shape=shape, return_trajectory=True,
                           init_noise=torch.from_numpy(init),
                           noise_seq=torch.from_numpy(seq))
    assert traj.shape == (4, 2, SIZE, SIZE, 3)
    assert torch.equal(traj[-1], fin)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), rtol=0,
                               atol=ATOL)
    plain = eng.sample(tden, c_t, shape=shape,
                       init_noise=torch.from_numpy(init),
                       noise_seq=torch.from_numpy(seq))
    assert torch.equal(plain, fin)
