"""IR-SDE: the mean-reverting SDE of EDiffSR.

Counterpart of ``fastdiffsr_tpu/diffusion/sde.py`` (reference
EDiffSR/codes/utils/sde_utils.py, class IRSDE:80-321):
dx = theta_t (mu - x) dt + sigma_t dW, whose stationary mean mu is the
upscaled LQ image.

- :func:`make_theta_schedule`: theta_t for t = 0..T (cosine, linear,
  constant), float64 on the host; :meth:`IRSDEBuffers.create` derives
  sigma_t, the theta cumsum, sigma_bar and dt there and keeps float32
  copies on the device, as the JAX package does;
- the step algebra, :meth:`IRSDE.matching_loss` (maximum-likelihood
  matching against the closed-form optimal reverse step),
  :meth:`IRSDE.reverse_sde` (the T-step reverse SDE or Euler
  probability-flow ODE), :meth:`IRSDE.optimal_reverse`;
- :meth:`IRSDE.ode_sampler`: the adaptive Dormand-Prince RK45 of the
  probability-flow ODE. Its step control runs on the host in float32
  (t, h and the step-size factor are ``numpy.float32``, as the JAX
  while-loop keeps them), so the drift truncates t to the same integer
  schedule index and accepts the same steps. Each trial step costs six
  denoiser evaluations and one host sync for the accept test.

State is NHWC. The denoiser is a closure ``noise_fn(x, mu, t)`` with
``t`` a (B,) float tensor. Random draws come from explicit
``torch.Generator`` objects: one per image for the reverse SDE (so a
batched restore equals the per-image one), one per batch for the
training states. Tests inject ``t``/``noise``/``noise_seq`` instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

NoiseFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def make_theta_schedule(schedule: str, T: int) -> np.ndarray:
    """theta_t for t = 0..T (index 0 present but unused), float64."""
    if schedule == "constant":
        return np.ones(T + 1, dtype=np.float64)
    if schedule == "linear":
        n = T + 1
        scale = 1000.0 / n
        return np.linspace(scale * 1e-4, scale * 2e-2, n, dtype=np.float64)
    if schedule == "cosine":
        s = 0.008
        timesteps = T + 2
        steps = timesteps + 1
        x = np.linspace(0, timesteps, steps, dtype=np.float64)
        ac = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
        ac = ac / ac[0]
        return 1 - ac[1:-1]                           # length T+1
    raise NotImplementedError(schedule)


@dataclasses.dataclass
class IRSDEBuffers:
    thetas: torch.Tensor          # (T+1,) float32
    sigmas: torch.Tensor
    thetas_cumsum: torch.Tensor   # starts at 0
    sigma_bars: torch.Tensor
    dt: float
    max_sigma: float
    T: int

    @classmethod
    def create(cls, max_sigma: float, T: int = 100, schedule: str = "cosine",
               eps: float = 0.005, device="cpu") -> "IRSDEBuffers":
        max_sigma = max_sigma / 255.0 if max_sigma >= 1 else max_sigma
        thetas = make_theta_schedule(schedule, T)
        sigmas = np.sqrt(max_sigma ** 2 * 2 * thetas)
        thetas_cumsum = np.cumsum(thetas) - thetas[0]
        dt = float(-1.0 / thetas_cumsum[-1] * math.log(eps))
        sigma_bars = np.sqrt(
            max_sigma ** 2 * (1 - np.exp(-2 * thetas_cumsum * dt)))

        def f32(a):
            return torch.tensor(a, dtype=torch.float32, device=device)

        return cls(thetas=f32(thetas), sigmas=f32(sigmas),
                   thetas_cumsum=f32(thetas_cumsum),
                   sigma_bars=f32(sigma_bars), dt=dt,
                   max_sigma=float(max_sigma), T=int(T))


# Dormand-Prince 5(4), scipy's RK45 pair, rounded to float32 as the JAX
# sampler holds it
_DP_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], np.float32)
_DP_A = np.array([
    [0, 0, 0, 0, 0, 0],
    [1 / 5, 0, 0, 0, 0, 0],
    [3 / 40, 9 / 40, 0, 0, 0, 0],
    [44 / 45, -56 / 15, 32 / 9, 0, 0, 0],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0],
], np.float32)
_DP_B5 = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784,
                   11 / 84, 0.0], np.float32)
# error weights b5 - b4 (the last couples the FSAL stage)
_DP_E = np.array([71 / 57600, 0, -71 / 16695, 71 / 1920, -17253 / 339200,
                  22 / 525, -1 / 40], np.float32)


def _wsum(coefs, ks) -> torch.Tensor:
    """sum_j coefs[j] * ks[j] in the JAX sampler's order (zero
    coefficients included, so a NaN stage stays NaN)."""
    out = 0
    for c, k in zip(coefs, ks):
        out = out + float(c) * k
    return out


class IRSDE:
    """Pure-functional IR-SDE: mu (the upscaled LQ batch) is passed
    explicitly. ``t`` is a python int, a 0-d or a (B,1,1,1) long tensor."""

    def __init__(self, buffers: IRSDEBuffers):
        self.b = buffers

    # forward / marginal quantities

    def mu_bar(self, x0, mu, t):
        return mu + (x0 - mu) * torch.exp(-self.b.thetas_cumsum[t]
                                          * self.b.dt)

    def sigma_bar(self, t):
        return self.b.sigma_bars[t]

    def generate_random_states(self, x0, mu, generator=None, *, t=None,
                               noise=None):
        """(t (B,1,1,1) long, x_t = mu_bar + sigma_bar(t) * noise)
        (sde_utils.py:305-321): t ~ U{1..T}, then the noise, both from
        ``generator`` unless injected."""
        bsz = x0.shape[0]
        if t is None:
            t = torch.randint(1, self.b.T + 1, (bsz, 1, 1, 1),
                              generator=generator, device=x0.device)
        mean = self.mu_bar(x0, mu, t)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=x0.device, dtype=torch.float32)
        return t, mean + noise * self.sigma_bar(t)

    def noise_state(self, tensor: torch.Tensor,
                    generators: Sequence[torch.Generator]) -> torch.Tensor:
        """x_T = mu + max_sigma * eps with eps drawn per image from its
        own generator (sde_utils.py:323), so an image's x_T does not
        depend on the batch it is in."""
        eps = _per_image_normal(generators, tensor.shape, tensor.device)
        return tensor + eps * self.b.max_sigma

    # reverse dynamics

    def get_score_from_noise(self, noise, t):
        return -noise / self.sigma_bar(t)

    def sde_reverse_drift(self, x, mu, score, t):
        return (self.b.thetas[t] * (mu - x)
                - self.b.sigmas[t] ** 2 * score) * self.b.dt

    def ode_reverse_drift(self, x, mu, score, t):
        return (self.b.thetas[t] * (mu - x)
                - 0.5 * self.b.sigmas[t] ** 2 * score) * self.b.dt

    def reverse_sde_step_mean(self, x, mu, score, t):
        return x - self.sde_reverse_drift(x, mu, score, t)

    def reverse_sde_step(self, x, mu, score, t, noise):
        return (x - self.sde_reverse_drift(x, mu, score, t)
                - self.b.sigmas[t] * math.sqrt(self.b.dt) * noise)

    def reverse_optimum_step(self, xt, x0, mu, t):
        """Closed-form optimal x_{t-1} (sde_utils.py:197-205)."""
        b = self.b
        A = torch.exp(-b.thetas[t] * b.dt)
        B = torch.exp(-b.thetas_cumsum[t] * b.dt)
        C = torch.exp(-b.thetas_cumsum[t - 1] * b.dt)
        term1 = A * (1 - C ** 2) / (1 - B ** 2)
        term2 = C * (1 - A ** 2) / (1 - B ** 2)
        return term1 * (xt - mu) + term2 * (x0 - mu) + mu

    def weights(self, t):
        return torch.exp(-self.b.thetas_cumsum[t] * self.b.dt)

    # training loss

    def matching_loss(self, noise_fn: NoiseFn, x0, mu, generator=None,
                      loss_type: str = "l1", *, t=None, noise=None):
        """Mean over the batch of the per-image mean |E[x_{t-1}] -
        x*_{t-1}| (l1) or its square (l2) (denoising_model.py:127-148)."""
        t, state = self.generate_random_states(x0, mu, generator, t=t,
                                               noise=noise)
        pred = noise_fn(state, mu, t[:, 0, 0, 0].to(torch.float32))
        score = self.get_score_from_noise(pred, t)
        diff = (self.reverse_sde_step_mean(state, mu, score, t)
                - self.reverse_optimum_step(state, x0, mu, t))
        if loss_type == "l1":
            per = torch.mean(torch.abs(diff), dim=(1, 2, 3))
        else:
            per = torch.mean(diff ** 2, dim=(1, 2, 3))
        return torch.mean(per)

    # sampling over t = T..1

    @torch.no_grad()
    def reverse_sde(self, noise_fn: NoiseFn, xt, mu,
                    generators: Optional[Sequence[torch.Generator]] = None,
                    ode: bool = False,
                    noise_seq: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """The T-step reverse SDE (or, with ``ode``, the Euler
        probability-flow ODE). The SDE's noise at step t is
        ``noise_seq[t - 1]`` when given, else one draw per image from
        ``generators``."""
        bsz = xt.shape[0]
        x = xt
        for t in range(self.b.T, 0, -1):
            pred = noise_fn(x, mu, torch.full((bsz,), float(t),
                                              device=x.device))
            score = self.get_score_from_noise(pred.float(), t)
            if ode:
                x = x - self.ode_reverse_drift(x, mu, score, t)
                continue
            if noise_seq is not None:
                eps = noise_seq[t - 1]
            else:
                eps = _per_image_normal(generators, x.shape, x.device)
            x = self.reverse_sde_step(x, mu, score, t, eps)
        return x

    @torch.no_grad()
    def optimal_reverse(self, xt, x0, mu):
        x = xt
        for t in range(self.b.T, 0, -1):
            x = self.reverse_optimum_step(x, x0, mu, t)
        return x

    @torch.no_grad()
    def ode_sampler(self, noise_fn: NoiseFn, xt, mu, rtol: float = 1e-5,
                    atol: float = 1e-5, eps: float = 1e-3,
                    max_steps: int = 10_000):
        """Probability-flow ODE with adaptive Dormand-Prince RK45 from
        t = T to ``eps`` (reference ode_sampler, sde_utils.py:264-288,
        scipy's solve_ivp with ``t = int(t)`` in the drift). The error
        norm is the RMS over the whole batch. Returns (x, accepted steps,
        trial steps)."""
        b = self.b
        bsz = xt.shape[0]
        f32 = np.float32

        def drift(x, t_cont):
            t_idx = min(max(int(t_cont), 1), b.T)   # truncates, as JAX
            pred = noise_fn(x, mu, torch.full((bsz,), float(t_idx),
                                              device=x.device))
            score = self.get_score_from_noise(pred.float(), t_idx)
            return self.ode_reverse_drift(x, mu, score, t_idx)

        t = f32(b.T)
        h = f32(-(b.T - eps) / 50.0)                 # first trial step
        x = xt
        k1 = drift(x, t)
        n_acc = n_trial = 0
        while n_trial < max_steps:
            h = max(h, f32(eps) - t)          # clamp the final step
            hf = float(h)
            ks = [k1]
            for i in range(1, 7):
                coefs = _DP_A[i, :i] if i < 6 else _DP_B5[:6]
                ks.append(drift(x + hf * _wsum(coefs, ks),
                                t + _DP_C[i] * h))
            x5 = x + hf * _wsum(_DP_B5[:6], ks)
            err = hf * _wsum(_DP_E, ks)
            scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
            err_norm = f32(torch.sqrt(torch.mean((err / scale) ** 2)).item())
            # a NaN stage must reject and shrink, not poison the control
            if np.isnan(err_norm):
                err_norm = f32(np.inf)
            accept = bool(err_norm <= 1.0)
            factor = np.clip(f32(0.9) * (f32(1.0) / max(err_norm, f32(1e-10)))
                             ** f32(0.2), f32(0.2), f32(10.0))
            h_new = f32(h * factor)
            n_trial += 1
            if accept:
                x, t, k1 = x5, f32(t + h), ks[6]   # FSAL: k7 = next k1
                n_acc += 1
            h = h_new
            # done on reaching eps, or on collapse (|h| underflow after
            # repeated NaN/reject shrinks; scipy aborts there too)
            if (accept and t <= eps + 1e-6) or abs(h_new) < 1e-6:
                break
        return x, n_acc, n_trial


def _per_image_normal(generators, shape, device) -> torch.Tensor:
    """(B, ...) standard normals, row i drawn from ``generators[i]``."""
    if generators is None or len(generators) != shape[0]:
        raise ValueError(f"need one generator per image ({shape[0]}), got "
                         f"{None if generators is None else len(generators)}")
    return torch.stack([torch.randn(tuple(shape[1:]), generator=g,
                                    device=device, dtype=torch.float32)
                        for g in generators])
