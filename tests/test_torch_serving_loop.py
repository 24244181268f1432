"""The serving export's scan form on the CPU (``build_sample_export(...,
loop=True)``: ``DiffusionEngine.sample_scan`` traced by ``torch.export``,
its noise drawn inside by ``diffusion.counter_normal`` from one int64
seed per image), at T=8 and 16x16 maps, on the MixNet denoiser of
tests/test_torch_serving.py, which is the same function in both
packages (the UNets' scan forms: tests/test_torch_serving.py for the
fused FastDiffSR forward, tests/test_torch_serving_variants.py for SR3's
plain forward with K1).

Each scan artifact, saved and loaded, is held bit for bit against the
unrolled artifact of the same sampler fed the noise the scan drew
(``ExportedSampler.sampler_noise``), within 1e-5 against the in-process
sampler fed that noise, and within 1e-5 against JAX's ``engine.sample``
/ ``sample_dpm`` fed it. DDIM with eta > 0 is held against the unrolled
artifact and the in-process sampler only: JAX's ``sample_ddim`` takes
no per-step noise. Also a static batch, and the counter stream itself:
its moments, its independence of the seed, the index and the batch
around an image, and the 64-bit-safe integer arithmetic it rests on."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdiffsr_tpu.diffusion import (DiffusionEngine as JaxEngine,
                                      DiffusionSpec as JaxSpec,
                                      ScheduleBuffers as JaxBuffers)
from fastdiffsr_tpu_torch import serving
from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine, DiffusionSpec,
                                            ScheduleBuffers, counter_noise,
                                            counter_normal)
from fastdiffsr_tpu_torch.diffusion.engine import _mix32, _mul32
from fastdiffsr_tpu_torch.train import make_sample_fn, pad_batch_with_keys
from tests.test_torch_serving import MixNet, jax_mix

torch.set_num_threads(2)

SIZE = 16
T = 8
ATOL = 1e-5
SCHED = {"schedule": "linear_cosine", "n_timestep": T,
         "linear_start": 1e-6, "linear_end": 1e-2}
# (sampler, steps, eta)
CASES = [("ancestral", None, 0.0), ("ddim", 4, 0.5), ("dpm", 4, 0.0)]
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def engines():
    return (JaxEngine(JaxSpec.for_variant("fastdiffsr"),
                      JaxBuffers.create(SCHED)),
            DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                            ScheduleBuffers.create(SCHED, device="cpu")))


@pytest.fixture(scope="module")
def forms(engines, tmp_path_factory):
    """Per sampler of CASES, the (scan artifact, unrolled artifact) of
    MixNet, saved and loaded, both with a symbolic batch traced at 2."""
    root = tmp_path_factory.mktemp("serving_loop")
    out = {}
    for sampler, steps, eta in CASES:
        loaded = []
        for loop in (True, False):
            ep, meta = serving.build_sample_export(
                engines[1], MixNet(), SIZE, sampler=sampler, steps=steps,
                eta=eta, loop=loop)
            path = str(root / f"{sampler}_{loop}.pt2")
            serving.save_exported(ep, meta, path)
            loaded.append(serving.load_exported(path))
        out[sampler] = loaded
    return out


def _inputs(b, seed=0):
    cond = np.random.default_rng(seed).uniform(
        -1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
    return cond, pad_batch_with_keys(cond, b, 7, 0, device="cpu")


def _params(net):
    return {k: v.detach() for k, v in net.state_dict().items()}


@pytest.mark.parametrize("sampler,steps,eta", CASES, ids=IDS)
def test_scan_form_equals_unrolled(engines, forms, sampler, steps, eta):
    """The scan artifact against the unrolled one fed the noise the scan
    drew (bit for bit: the same operators in the same order) and the
    in-process sampler fed it, at batches 3 and 1 of one symbolic-batch
    artifact; the metadata names the forms."""
    scan, unrolled = forms[sampler]
    net = MixNet()
    assert (scan.meta["loop"], scan.meta["noise"]) == ("scan", "counter")
    assert (unrolled.meta["loop"], unrolled.meta["noise"]) == (
        "unrolled", "inputs")
    assert scan.meta["evals"] == unrolled.meta["evals"] == (steps or T)
    direct = make_sample_fn(engines[1], lambda x, lv: net(x, lv),
                            sampler=sampler, ddim_steps=steps, ddim_eta=eta)
    for b in (3, 1):
        cond, (cond_t, gens) = _inputs(b)
        seeds, = scan.noise(cond_t, gens)
        assert seeds.dtype == torch.int64 and seeds.shape == (b,)
        got = scan.call(_params(net), cond_t, seeds)
        init, seq = scan.sampler_noise(cond_t, _inputs(b)[1][1])
        assert (seq is None) == (sampler == "dpm")
        assert torch.equal(init, counter_normal(seeds, 0, (SIZE, SIZE, 3)))
        assert torch.equal(got, unrolled.call(_params(net), cond_t, init,
                                              seq))
        want = direct(cond_t, init_noise=init, noise_seq=seq)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=ATOL)
        # the generators' contract: the same images from fresh generators
        assert torch.equal(scan(_params(net), cond_t, _inputs(b)[1][1]),
                           got)


@pytest.mark.parametrize("sampler,steps", [("ancestral", None), ("dpm", 4)])
def test_scan_form_matches_jax(engines, forms, sampler, steps):
    """The scan artifact against JAX's engine.sample (noise_seq by
    timestep) or sample_dpm fed the same noise."""
    scan = forms[sampler][0]
    cond, (cond_t, gens) = _inputs(2, seed=1)
    got = scan(_params(MixNet()), cond_t, gens)
    init, seq = scan.sampler_noise(cond_t, _inputs(2, seed=1)[1][1])
    key = jax.random.PRNGKey(0)
    if sampler == "dpm":
        want = engines[0].sample_dpm(jax_mix, jnp.asarray(cond), key,
                                     steps=steps,
                                     init_noise=jnp.asarray(init.numpy()))
    else:
        want = engines[0].sample(jax_mix, jnp.asarray(cond), key,
                                 init_noise=jnp.asarray(init.numpy()),
                                 noise_seq=jnp.asarray(seq.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_static_batch_scan_rejects_another(engines, tmp_path):
    """--batch 3 in the scan form."""
    net = MixNet()
    ep, meta = serving.build_sample_export(engines[1], net, SIZE, batch=3,
                                           sampler="ddim", steps=2, eta=0.5,
                                           loop=True)
    path = str(tmp_path / "scan_b3.pt2")
    serving.save_exported(ep, meta, path)
    loaded = serving.load_exported(path)
    assert loaded.meta["batch"] == 3 and loaded.meta["loop"] == "scan"
    out = loaded(_params(net), *_inputs(3)[1])
    assert out.shape == (3, SIZE, SIZE, 3) and torch.isfinite(out).all()
    with pytest.raises(Exception):
        loaded(_params(net), *_inputs(4)[1])


def test_counter_normal_moments_and_independence():
    """1e5 draws: mean, variance, skew, kurtosis and the share beyond
    2 sigma of a standard normal; neighbouring elements, draw indices and
    seeds uncorrelated."""
    seeds = torch.arange(10, dtype=torch.int64) + 2 ** 40
    z = counter_normal(seeds, 3, (100, 100)).double()
    assert z.dtype == torch.float64 and z.shape == (10, 100, 100)
    v = z.reshape(-1)
    n = v.numel()
    assert n == 100_000
    assert abs(v.mean().item()) < 6 / n ** 0.5
    assert abs(v.var().item() - 1) < 6 * (2 / n) ** 0.5
    assert abs((v ** 3).mean().item()) < 6 * (15 / n) ** 0.5
    assert abs((v ** 4).mean().item() - 3) < 6 * (96 / n) ** 0.5
    assert abs((v.abs() > 2).double().mean().item() - 0.0455) < 0.004
    other = counter_normal(seeds, 4, (100, 100)).reshape(-1).double()
    nxt = counter_normal(seeds + 1, 3, (100, 100)).reshape(-1).double()
    for a, b in ((v[:-1], v[1:]), (v, other), (v, nxt)):
        r = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
        assert abs(r) < 6 / n ** 0.5


def test_counter_normal_keys_and_batch_invariance():
    """Another seed or index gives other draws; an image's draws do not
    depend on the batch around it; counter_noise lays the steps out in
    loop order, or by timestep."""
    seeds = torch.tensor([5, 2 ** 62 + 9, -3, 5], dtype=torch.int64)
    z = counter_normal(seeds, 7, (4, 4, 3))
    assert z.dtype == torch.float32 and z.shape == (4, 4, 4, 3)
    assert torch.equal(z[0], z[3])                    # the same seed
    assert not torch.equal(z[0], z[1])
    assert not torch.equal(z, counter_normal(seeds, 8, (4, 4, 3)))
    for i in range(4):
        assert torch.equal(counter_normal(seeds[i:i + 1], 7, (4, 4, 3)),
                           z[i:i + 1])
    assert torch.equal(counter_normal(seeds, torch.tensor(7), (4, 4, 3)), z)
    init, seq = counter_noise(seeds, 3, (4, 4, 3))
    init_t, seq_t = counter_noise(seeds, 3, (4, 4, 3), by_timestep=True)
    assert torch.equal(init, counter_normal(seeds, 0, (4, 4, 3)))
    assert torch.equal(init_t, init) and seq.shape == (3, 4, 4, 4, 3)
    for k in range(3):
        assert torch.equal(seq[k], counter_normal(seeds, k + 1, (4, 4, 3)))
        assert torch.equal(seq_t[2 - k], seq[k])
    assert counter_noise(seeds, 0, (4, 4, 3))[1] is None


def test_counter_hash_stays_below_2_to_63():
    """_mul32 is (x * c) mod 2^32 for every 32-bit x, with no product at
    or above 2^49 (so no signed overflow); _mix32 is a bijection on a
    sample of inputs (no two collide)."""
    rng = np.random.default_rng(0)
    xs = np.concatenate([[0, 1, 2 ** 16 - 1, 2 ** 16, 2 ** 31, 2 ** 32 - 1],
                         rng.integers(0, 2 ** 32, 5000)]).astype(np.int64)
    x = torch.from_numpy(xs)
    for c in (0x7FEB352D, 0x846CA68B, 0xFFFFFFFF):
        got = _mul32(x, c).numpy()
        want = [(int(v) * c) % 2 ** 32 for v in xs]
        assert got.tolist() == want
        assert int(x.max()) * max(c & 0xFFFF, c >> 16) < 2 ** 49
    h = _mix32(x).numpy()
    assert h.min() >= 0 and h.max() < 2 ** 32
    assert len(set(h.tolist())) == len(set(xs.tolist()))
