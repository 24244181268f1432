"""The port's IR-SDE (``fastdiffsr_tpu_torch/diffusion/sde.py``) against
the JAX package's (``fastdiffsr_tpu/diffusion/sde.py``): buffers, the
matching loss with JAX's draws injected, the reverse SDE/ODE with one
noise sequence, the optimal reverse and the adaptive RK45 sampler, on
the same numpy inputs and a parameter-free denoiser written out on each
side. Tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiffsr_tpu.diffusion import sde as jsde
from fastdiffsr_tpu_torch.diffusion import sde as tsde

torch.set_num_threads(2)


def _pair(T=10, schedule="cosine", max_sigma=50):
    return (jsde.IRSDE(jsde.IRSDEBuffers.create(max_sigma, T, schedule,
                                                0.005)),
            tsde.IRSDE(tsde.IRSDEBuffers.create(max_sigma, T, schedule,
                                                0.005)))


def _noise_fns(sde_j, T):
    """The same t-dependent denoiser on both sides, scaled by sigma_bar(t)
    so the score stays O(1)."""
    def jfn(x, mu, t):
        sig = sde_j.b.sigma_bars[t.astype(jnp.int32)][:, None, None, None]
        return (0.5 * jnp.tanh(x - mu)
                * (1 + t[:, None, None, None] / T) * sig)

    bars = torch.from_numpy(np.array(sde_j.b.sigma_bars))

    def tfn(x, mu, t):
        sig = bars[t.long()][:, None, None, None]
        return 0.5 * torch.tanh(x - mu) * (1 + t[:, None, None, None] / T) \
            * sig
    return jfn, tfn


def _inputs(seed=0, shape=(2, 8, 8, 3)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_buffers_match_jax(schedule):
    """Each buffer within 1e-6 (both are float32 copies of the same
    float64 host arithmetic); dt and max_sigma equal."""
    j, t = _pair(100, schedule)
    for name in ("thetas", "sigmas", "thetas_cumsum", "sigma_bars"):
        np.testing.assert_allclose(getattr(t.b, name).numpy(),
                                   np.asarray(getattr(j.b, name)), atol=1e-6)
    assert t.b.dt == j.b.dt and t.b.max_sigma == j.b.max_sigma


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_matching_loss_matches_jax(loss_type):
    """JAX's t and noise draws (its generate_random_states split) injected
    into the port: the loss within 1e-5."""
    T = 10
    j, t = _pair(T)
    jfn, tfn = _noise_fns(j, T)
    x0, mu = _inputs(1)
    rng = jax.random.PRNGKey(3)
    want = float(j.matching_loss(jfn, jnp.asarray(x0), jnp.asarray(mu), rng,
                                 loss_type=loss_type))
    rng_t, rng_n = jax.random.split(rng)
    tt = np.asarray(jax.random.randint(rng_t, (2, 1, 1, 1), 1, T + 1))
    noise = np.asarray(jax.random.normal(rng_n, x0.shape, jnp.float32))
    got = float(t.matching_loss(tfn, torch.from_numpy(x0),
                                torch.from_numpy(mu), loss_type=loss_type,
                                t=torch.from_numpy(tt).long(),
                                noise=torch.from_numpy(noise)))
    assert abs(got - want) <= 1e-5, (got, want)


@pytest.mark.parametrize("ode", [False, True])
def test_reverse_sde_matches_jax(ode):
    """T=10 reverse SDE (one injected noise sequence) and Euler ODE:
    within 1e-4 * max|x|."""
    T = 10
    j, t = _pair(T)
    jfn, tfn = _noise_fns(j, T)
    xt, mu = _inputs(2)
    noise = np.random.default_rng(3).standard_normal(
        (T,) + xt.shape).astype(np.float32)
    want = np.asarray(j.reverse_sde(jfn, jnp.asarray(xt), jnp.asarray(mu),
                                    jax.random.PRNGKey(0), ode=ode,
                                    noise_seq=jnp.asarray(noise)))
    got = t.reverse_sde(tfn, torch.from_numpy(xt), torch.from_numpy(mu),
                        ode=ode, noise_seq=torch.from_numpy(noise)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_optimal_reverse_matches_jax():
    """The closed-form optimal reverse chain over T=10: within 1e-5."""
    j, t = _pair(10)
    xt, x0 = _inputs(4)
    mu = _inputs(5)[0]
    want = np.asarray(j.optimal_reverse(jnp.asarray(xt), jnp.asarray(x0),
                                        jnp.asarray(mu)))
    got = t.optimal_reverse(*(torch.from_numpy(a) for a in (xt, x0, mu)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _rk45_pair(T, tol, schedule, smooth, seed=0):
    """(JAX x, JAX accepted steps, port x, port accepted, port trials)."""
    j, t = _pair(T, schedule, max_sigma=10.0)
    xt, mu = _inputs(seed, (1, 4, 4, 3))
    if smooth:
        # noise proportional to sigma_bar(t): the score, and with a
        # constant theta the whole drift, no longer depend on t
        bars = torch.from_numpy(np.array(j.b.sigma_bars))

        def jfn(x, m, tt):
            return 0.5 * jnp.tanh(x - m) * j.b.sigma_bars[
                tt.astype(jnp.int32)][:, None, None, None]

        def tfn(x, m, tt):
            return 0.5 * torch.tanh(x - m) * bars[tt.long()][:, None, None,
                                                            None]
    else:
        def jfn(x, m, tt):
            return jnp.tanh(x - m) * 0.3

        def tfn(x, m, tt):
            return torch.tanh(x - m) * 0.3
    xj, nj = j.ode_sampler(jfn, jnp.asarray(xt), jnp.asarray(mu), rtol=tol,
                           atol=tol)
    xg, ng, trials = t.ode_sampler(tfn, torch.from_numpy(xt),
                                   torch.from_numpy(mu), rtol=tol, atol=tol)
    return np.asarray(xj), int(nj), xg.numpy(), ng, trials


@pytest.mark.parametrize("T,tol", [(10, 1e-3), (10, 1e-5), (100, 1e-3),
                                   (100, 1e-5)])
def test_ode_sampler_matches_jax(T, tol):
    """Adaptive RK45 (Dormand-Prince tableau, step control, FSAL, final
    clamp, termination) on a drift that is smooth in t (constant theta,
    noise proportional to sigma_bar): the same accepted-step count as the
    JAX while-loop and x within 1e-3 * max|x|."""
    xj, nj, xg, ng, trials = _rk45_pair(T, tol, "constant", smooth=True)
    assert ng == nj > 0 and trials >= ng
    assert np.abs(xg - xj).max() <= 1e-3 * np.abs(xj).max()


@pytest.mark.parametrize("T", [10, 20])
def test_ode_sampler_matches_jax_on_the_truncated_drift(T):
    """The published drift (cosine theta, t truncated to an integer
    schedule index) at rtol = atol = 1e-3: the same accepted-step count,
    x within 1e-3 * max|x|. The truncation makes the drift jump at every
    integer t; at tight tolerances a last-bit difference in one error
    estimate (it cancels to ~1e-5 of the stages) moves a later stage
    across a jump, and the count is no longer a function of the problem:
    the JAX sampler itself, jitted and run eagerly, then takes 64 and 66
    accepted steps (T=20, tol 1e-5, these inputs)."""
    xj, nj, xg, ng, _ = _rk45_pair(T, 1e-3, "cosine", smooth=False)
    assert ng == nj > 0
    assert np.abs(xg - xj).max() <= 1e-3 * np.abs(xj).max()


def test_ode_sampler_survives_nan_drift():
    """A NaN from the denoiser rejects and shrinks the step until the
    solver stops, as in the JAX sampler (tests/test_ediffsr.py::
    test_ode_sampler_survives_nan_drift): nothing accepted on either side,
    x_T returned untouched, far fewer trials than max_steps."""
    j, t = _pair(10, max_sigma=10.0)
    xt = np.asarray(j.noise_state(jnp.zeros((1, 4, 4, 3)),
                                  jax.random.PRNGKey(0)))
    mu = np.zeros_like(xt)
    xj, nj = j.ode_sampler(lambda x, m, tt: x * jnp.nan, jnp.asarray(xt),
                           jnp.asarray(mu), max_steps=500)
    x, n, trials = t.ode_sampler(lambda x, m, tt: x * float("nan"),
                                 torch.from_numpy(xt), torch.from_numpy(mu),
                                 max_steps=500)
    assert n == int(nj) == 0 and trials < 500
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(x.numpy(), xt)


def test_reverse_sde_draws_per_image():
    """The SDE's noise comes from each image's own generator: an image's
    restore is the same alone and in a batch (the batched-restore
    contract)."""
    _, t = _pair(5)
    _, tfn = _noise_fns(_pair(5)[0], 5)
    xt, mu = (torch.from_numpy(a) for a in _inputs(7, (3, 4, 4, 3)))

    def gens(idx):
        return [torch.Generator().manual_seed(100 + i) for i in idx]
    whole = t.reverse_sde(tfn, xt, mu, gens(range(3)))
    one = t.reverse_sde(tfn, xt[1:2], mu[1:2], gens([1]))
    torch.testing.assert_close(whole[1:2], one, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="one generator per image"):
        t.reverse_sde(tfn, xt, mu, gens([0]))
