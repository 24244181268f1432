"""The port's fast samplers (``sample_ddim``, ``sample_dpm``) and
``interpolate`` against the JAX engine: the same schedule, the same
injected initial noise and per-step noise (JAX's own draws, reproduced
here from its keys), and a tiny denoiser that is the same function in
both packages (a seeded 1x1 channel mix, tanh, a level-dependent gain).
Tolerance: float32, abs 1e-5. Also the samplers' batch invariance, what
they draw, and ``make_sample_fn``'s wiring and rejection."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdiffsr_tpu.diffusion.engine import (DiffusionEngine as JaxEngine,
                                             DiffusionSpec as JaxSpec)
from fastdiffsr_tpu.diffusion.schedules import ScheduleBuffers as JaxBuffers
from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine, DiffusionSpec,
                                            ScheduleBuffers)
from fastdiffsr_tpu_torch.train import make_sample_fn, pad_batch_with_keys

torch.set_num_threads(2)

ATOL = 1e-5
SHAPE = (2, 8, 8, 3)
SCHED = {"fastdiffsr": {"schedule": "linear_cosine", "n_timestep": 20,
                        "linear_start": 1e-6, "linear_end": 1e-2},
         "linear": {"schedule": "linear", "n_timestep": 50,
                    "linear_start": 1e-4, "linear_end": 5e-2}}
# variant -> (schedule, spec overrides)
SPECS = {"fastdiffsr": ("fastdiffsr", {}), "ddpm": ("linear", {}),
         "gdp": ("linear", {}), "tesr": ("linear", {}),
         "ddpm_noclip": ("linear", {"clip_denoised": False})}
W_MIX = np.random.default_rng(42).standard_normal((6, 3)).astype(
    np.float32) * 0.6


def _gain(level, discrete):
    return 0.5 + (level / 50.0 if discrete else level)


def jax_denoise(discrete, w=W_MIX):
    def fn(x_in, level):
        g = _gain(level, discrete).reshape((-1, 1, 1, 1))
        return jnp.tanh(jnp.einsum("bhwc,cd->bhwd", x_in,
                                   jnp.asarray(w[:x_in.shape[-1]]))) * g
    return fn


def torch_denoise(discrete, w=W_MIX):
    wt = torch.from_numpy(w)

    def fn(x_in, level):
        g = _gain(level, discrete).reshape((-1, 1, 1, 1))
        return torch.tanh(torch.einsum("bhwc,cd->bhwd", x_in,
                                       wt[:x_in.shape[-1]])) * g
    return fn


def _engines(case):
    sched, over = SPECS[case]
    variant = case.split("_")[0]
    jspec = dataclasses.replace(JaxSpec.for_variant(variant), **over)
    spec = dataclasses.replace(DiffusionSpec.for_variant(variant), **over)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    return (JaxEngine(jspec, JaxBuffers.create(SCHED[sched])),
            DiffusionEngine(spec, ScheduleBuffers.create(SCHED[sched],
                                                         device="cpu")),
            spec.conditioning == "discrete_t")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    cond = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    init = rng.standard_normal(SHAPE).astype(np.float32)
    return cond, init


def _ts(T, steps):
    return np.unique(np.linspace(0, T - 1, steps or T).round()
                     .astype(np.int64))[::-1]


CASES = [(c, s) for c in ("fastdiffsr", "ddpm", "gdp", "ddpm_noclip")
         for s in (None, 7)]


@pytest.mark.parametrize("case,steps", CASES)
def test_ddim_eta0_matches_jax(case, steps):
    """Deterministic DDIM at steps = T (None) and at 7 steps."""
    jeng, eng, discrete = _engines(case)
    cond, init = _inputs(1)
    want = jeng.sample_ddim(jax_denoise(discrete), jnp.asarray(cond),
                            jax.random.PRNGKey(0), steps=steps,
                            init_noise=jnp.asarray(init))
    got = eng.sample_ddim(torch_denoise(discrete), torch.from_numpy(cond),
                          steps=steps, init_noise=torch.from_numpy(init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("case,steps", CASES)
def test_dpm_matches_jax(case, steps):
    """DPM-Solver++(2M) at steps = T and at 7 steps (2M weights, first
    order first and final steps)."""
    jeng, eng, discrete = _engines(case)
    cond, init = _inputs(2)
    want = jeng.sample_dpm(jax_denoise(discrete), jnp.asarray(cond),
                           jax.random.PRNGKey(0), steps=steps,
                           init_noise=jnp.asarray(init))
    got = eng.sample_dpm(torch_denoise(discrete), torch.from_numpy(cond),
                         steps=steps, init_noise=torch.from_numpy(init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["fastdiffsr", "ddpm", "gdp"])
def test_ddim_eta_positive_matches_jax(case):
    """eta = 0.5 at 7 steps: JAX draws step k's noise from
    fold_in(split(key)[1], t_k); the test computes those draws and feeds
    them to the port as ``noise_seq``."""
    jeng, eng, discrete = _engines(case)
    cond, init = _inputs(3)
    key = jax.random.PRNGKey(5)
    want = jeng.sample_ddim(jax_denoise(discrete), jnp.asarray(cond), key,
                            steps=7, eta=0.5, init_noise=jnp.asarray(init))
    rng_steps = jax.random.split(key)[1]
    seq = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(rng_steps, int(t)), SHAPE, jnp.float32))
        for t in _ts(eng.buffers.num_timesteps, 7)])
    got = eng.sample_ddim(torch_denoise(discrete), torch.from_numpy(cond),
                          steps=7, eta=0.5, init_noise=torch.from_numpy(init),
                          noise_seq=torch.from_numpy(seq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # the noise matters: without it the result moves
    det = eng.sample_ddim(torch_denoise(discrete), torch.from_numpy(cond),
                          steps=7, init_noise=torch.from_numpy(init))
    assert (det - got).abs().max() > 1e-3


@pytest.mark.parametrize("case,t", [("ddpm", None), ("gdp", 20),
                                    ("tesr", 30), ("ddpm_noclip", 30)])
def test_interpolate_matches_jax(case, t):
    """JAX splits its key in three: noise1, noise2, then step t_idx's
    noise from fold_in(third, t_idx). The test reproduces the draws and
    injects them into the port."""
    jeng, eng, discrete = _engines(case)
    rng = np.random.default_rng(4)
    x1, x2 = (rng.uniform(-1, 1, SHAPE).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(9)
    den_j, den_t = (jax_denoise(discrete, W_MIX[3:]),
                    torch_denoise(discrete, W_MIX[3:]))
    want = jeng.interpolate(den_j, jnp.asarray(x1), jnp.asarray(x2), key,
                            t=t, lam=0.3)
    k1, k2, k_steps = jax.random.split(key, 3)
    t_top = eng.buffers.num_timesteps - 1 if t is None else t
    n1, n2 = (np.array(jax.random.normal(k, SHAPE, jnp.float32))
              for k in (k1, k2))
    seq = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(k_steps, i), SHAPE, jnp.float32))
        for i in range(t_top)])
    got = eng.interpolate(den_t, torch.from_numpy(x1), torch.from_numpy(x2),
                          t=t, lam=0.3, noise1=torch.from_numpy(n1),
                          noise2=torch.from_numpy(n2),
                          noise_seq=torch.from_numpy(seq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_interpolate_draws_from_its_generator():
    _, eng, discrete = _engines("ddpm")
    x = torch.zeros(SHAPE)
    den = torch_denoise(discrete, W_MIX[3:])
    a, b = (eng.interpolate(den, x, x, torch.Generator().manual_seed(1), t=5)
            for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        eng.interpolate(den, x, x, t=5)


@pytest.mark.parametrize("sampler,eta", [("ddim", 0.0), ("ddim", 0.7),
                                         ("dpm", 0.0)])
def test_fast_samplers_are_batch_invariant(sampler, eta):
    """Images {0,1,2} as one batch and as {0,1} + {2}: each image draws
    from its own generator, so the results agree (atol 1e-6: the
    denoiser's per-image arithmetic is the same at every batch size)."""
    _, eng, discrete = _engines("ddpm")
    sample = make_sample_fn(eng, torch_denoise(discrete), sampler=sampler,
                            ddim_steps=6, ddim_eta=eta)
    cond = np.random.default_rng(6).uniform(-1, 1, (3, 8, 8, 3)).astype(
        np.float32)
    whole = sample(*pad_batch_with_keys(cond, 3, 11, 0, device="cpu"))
    head = sample(*pad_batch_with_keys(cond[:2], 2, 11, 0, device="cpu"))
    tail = sample(*pad_batch_with_keys(cond[2:], 2, 11, 2, device="cpu"))
    torch.testing.assert_close(torch.cat([head, tail[:1]]), whole, rtol=0,
                               atol=1e-6)
    assert not torch.equal(tail[0], tail[1])    # the pad lane's own noise


@pytest.mark.parametrize("sampler,eta,extra", [("ddim", 0.0, 0),
                                               ("dpm", 0.0, 0),
                                               ("ddim", 0.3, 6)])
def test_fast_samplers_draw_only_what_they_use(sampler, eta, extra):
    """DDIM with eta = 0 and DPM-Solver++ draw the initial noise and
    nothing else; DDIM with eta > 0 draws one more per step."""
    _, eng, discrete = _engines("gdp")
    cond, gens = pad_batch_with_keys(_inputs()[0], 2, 3, 0, device="cpu")
    twins = pad_batch_with_keys(_inputs()[0], 2, 3, 0, device="cpu")[1]
    make_sample_fn(eng, torch_denoise(discrete), sampler=sampler,
                   ddim_steps=6, ddim_eta=eta)(cond, gens)
    for g, twin in zip(gens, twins):
        for _ in range(1 + extra):
            torch.randn(SHAPE[1:], generator=twin)
        assert torch.equal(g.get_state(), twin.get_state())


def test_dpm_single_step_is_ddim():
    """With one step, DPM-Solver++ is its first-order (final) update,
    the DDIM eta=0 step."""
    _, eng, discrete = _engines("ddpm")
    cond, init = (torch.from_numpy(a) for a in _inputs(7))
    den = torch_denoise(discrete)
    torch.testing.assert_close(
        eng.sample_dpm(den, cond, steps=1, init_noise=init),
        eng.sample_ddim(den, cond, steps=1, init_noise=init),
        rtol=0, atol=1e-6)


def test_fast_samplers_need_one_generator_per_image():
    _, eng, discrete = _engines("ddpm")
    cond = torch.zeros(SHAPE)
    one = [torch.Generator()]
    for fn in (eng.sample_ddim, eng.sample_dpm):
        with pytest.raises(ValueError, match="one per image"):
            fn(torch_denoise(discrete), cond, one)
    with pytest.raises(ValueError, match="one per image"):
        eng.sample_ddim(torch_denoise(discrete), cond, one, eta=0.5,
                        init_noise=cond)


@pytest.mark.parametrize("sampler", ["ancestral", "ddim", "dpm"])
def test_make_sample_fn_wires_each_sampler(sampler, monkeypatch):
    _, eng, _ = _engines("ddpm")
    seen = {}
    for name in ("sample", "sample_ddim", "sample_dpm"):
        monkeypatch.setattr(eng, name, lambda *a, _n=name, **k:
                            seen.setdefault(_n, (a, k)))
    den = object()
    make_sample_fn(eng, den, sampler=sampler, ddim_steps=9,
                   ddim_eta=0.25)("cond", "gens")
    want = {"ancestral": ("sample", {}),
            "ddim": ("sample_ddim", {"steps": 9, "eta": 0.25}),
            "dpm": ("sample_dpm", {"steps": 9})}[sampler]
    assert list(seen) == [want[0]]
    assert seen[want[0]] == ((den, "cond", "gens"), want[1])


def test_make_sample_fn_rejects_unknown_sampler():
    _, eng, _ = _engines("ddpm")
    with pytest.raises(ValueError, match="want 'ancestral', 'ddim' or"):
        make_sample_fn(eng, None, sampler="euler")


def test_image_generators_differ_by_seed_and_index():
    """Every (seed, index) pair has its own stream on the CPU too, whose
    generator keeps only the low 32 bits of a seed (a seed of
    ``(seed << 32) + index`` gave every run seed the same noise there)."""
    from fastdiffsr_tpu_torch.train.steps import image_generator, pass_seed
    draws = {(s, i): torch.randn(4, generator=image_generator(s, i, "cpu"))
             for s in (0, 1, pass_seed(0, 1)) for i in (0, 1)}
    vals = list(draws.values())
    assert all(not torch.equal(a, b) for j, a in enumerate(vals)
               for b in vals[j + 1:])
    torch.testing.assert_close(
        torch.randn(4, generator=image_generator(1, 1, "cpu")),
        draws[1, 1], rtol=0, atol=0)
