"""Gaussian-diffusion engine: the ancestral reverse process.

Counterpart of ``fastdiffsr_tpu/diffusion/engine.py``: the same
:class:`DiffusionSpec` table for the four variants of the reference

===========  ==========  ===============  ============  =======  ====
variant      prediction  conditioning     target_space  loss     T
===========  ==========  ===============  ============  =======  ====
fastdiffsr   noise       continuous_gamma residual      l1       20
ddpm         noise       discrete_t       hr            l1       1000
tesr         noise       continuous_gamma hr            charb.   2000
gdp          x0          discrete_t       hr            l2       1000
===========  ==========  ===============  ============  =======  ====

the training loss (:meth:`DiffusionEngine.training_loss`, with the
optional image-space SSIM term) and the ancestral sampler. PyTorch runs
eagerly, so the T steps are a Python loop around the denoiser instead of
one ``lax.scan`` program. Each sampler is one step update of (carry,
denoiser output, the step's constants, its noise) and its constants
stacked in loop order, as JAX's ``consts`` are; the loop calls it, and
so does :meth:`DiffusionEngine.sample_scan`, the one-scan form that the
serving export traces for a long sampler, with its noise drawn inside by
:func:`counter_normal` from one int64 seed per image.

Noise: JAX keys become ``torch.Generator``s. The sampler takes one
generator per image and draws that image's initial noise and then one
draw per step from it, in a fixed order, so an image's result depends on
its own generator only and not on how images are batched (the contract
of ``rng_is_batched`` there). Tests inject ``init_noise`` / ``noise_seq``
to feed both packages the same draws. The training loss draws its noise
and noise level from one generator; tests inject ``noise`` and
``gamma``/``t`` instead.

The fast samplers are here too: :meth:`DiffusionEngine.sample_ddim`
(DDIM on a timestep subsequence), :meth:`DiffusionEngine.sample_dpm`
(DPM-Solver++(2M)) and :meth:`DiffusionEngine.interpolate`. As in JAX,
their per-step constants are computed on the host in float64 numpy from
the float32 schedule and cast to float32 once. DDIM draws its per-step
noise (``eta > 0`` only) and DPM-Solver++ nothing after the initial noise,
both from the per-image generators, in loop order.

Layout is NHWC throughout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.dssim import ssim
from .schedules import ScheduleBuffers

# denoise_fn(x_in: (B,H,W,Cin), level: (B,)) -> (B,H,W,Cout)
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DiffusionSpec:
    """Static configuration selecting a diffusion variant."""

    prediction: str = "noise"             # 'noise' | 'x0'
    conditioning: str = "continuous_gamma"  # 'continuous_gamma' | 'discrete_t'
    target_space: str = "residual"        # 'residual' | 'hr'
    loss: str = "l1"                      # 'l1' | 'l2' | 'charbonnier'
    cond_order: str = "cond_first"        # 'cond_first' | 'x_first' (gdp)
    conditional: bool = True
    clip_denoised: bool = True
    charbonnier_eps: float = 1e-3

    @classmethod
    def for_variant(cls, name: str) -> "DiffusionSpec":
        if name == "fastdiffsr":
            return cls(prediction="noise", conditioning="continuous_gamma",
                       target_space="residual", loss="l1")
        if name == "ddpm":
            return cls(prediction="noise", conditioning="discrete_t",
                       target_space="hr", loss="l1")
        if name == "tesr":
            return cls(prediction="noise", conditioning="continuous_gamma",
                       target_space="hr", loss="charbonnier")
        if name == "gdp":
            return cls(prediction="x0", conditioning="discrete_t",
                       target_space="hr", loss="l2", cond_order="x_first")
        raise ValueError(f"unknown diffusion variant: {name}")


def img2res(x_hr: torch.Tensor, img_lr_up: torch.Tensor,
            clip: bool = True) -> torch.Tensor:
    """HR image -> residual space: (HR - bicubic)*2, clamped to [-1, 1]."""
    x = (x_hr - img_lr_up) * 2.0
    return torch.clamp(x, -1.0, 1.0) if clip else x


def res2img(res: torch.Tensor, img_lr_up: torch.Tensor,
            clip: bool = True) -> torch.Tensor:
    """Residual -> HR image: clamp(res)/2 + bicubic."""
    if clip:
        res = torch.clamp(res, -1.0, 1.0)
    return res / 2.0 + img_lr_up


def normal_per_generator(generators: Sequence[torch.Generator], shape,
                         device) -> torch.Tensor:
    """(B, *shape) standard normal draws, row i from generators[i]."""
    return torch.stack([torch.randn(tuple(shape), generator=g, device=device,
                                    dtype=torch.float32)
                        for g in generators])


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 of int64 ``x`` in [0, 2^32) and a 32-bit constant,
    by the 16-bit halves of ``c``: no product reaches 2^49, so nothing
    relies on the wraparound of a signed overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijection of [0, 2^32) whose every output bit depends on every
    input bit (C. Wellons' ``lowbias32`` integer hash)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_normal(seeds: torch.Tensor, index, shape) -> torch.Tensor:
    """(B, *shape) float32 standard normal draws, row i a function of
    (``seeds[i]``, ``index``, element) alone: a counter-based stream of
    integer tensor ops that a traced program computes as the eager code
    does. Each element hashes (seed, index, 2 * element + j) for j = 0, 1
    into two 32-bit uniforms in (0, 1), which Box-Muller maps to a normal
    (in float64). ``seeds`` are int64 (all 64 bits count); ``index`` an
    int or a 0-d int64 tensor in [0, 2^32). The stream is neither
    ``torch.Generator``'s nor JAX's threefry."""
    n = math.prod(shape)
    s = seeds.to(torch.int64)
    key = _mix32(_mix32(_mix32(s & _M32) ^ ((s >> 32) & _M32))
                 ^ (index & _M32))
    e = torch.arange(2 * n, device=s.device, dtype=torch.int64)
    h = _mix32(_mix32(key[:, None] ^ e) ^ 0x9E3779B9)
    u = ((h.double() + 0.5) / 2.0 ** 32).reshape(s.shape[0], n, 2)
    z = torch.sqrt(-2.0 * torch.log(u[..., 0])) * torch.cos(
        2.0 * math.pi * u[..., 1])
    return z.float().reshape(s.shape[0], *shape)


def counter_noise(seeds: torch.Tensor, steps: int, shape,
                  by_timestep: bool = False):
    """What :meth:`DiffusionEngine.sample_scan` draws from ``seeds``, as
    the Python loops take it: (init_noise (B,*shape) at index 0,
    noise_seq (steps,B,*shape) or None), step k's draw at index k + 1 in
    loop order; ``by_timestep`` lays an ancestral sequence out by
    timestep (step k at T-1-k)."""
    init = counter_normal(seeds, 0, shape)
    if not steps:
        return init, None
    seq = [counter_normal(seeds, k + 1, shape) for k in range(steps)]
    if by_timestep:
        seq.reverse()
    return init, torch.stack(seq)


class DiffusionEngine:
    """Training and sampling math for one (spec, schedule)."""

    def __init__(self, spec: DiffusionSpec, buffers: ScheduleBuffers,
                 aux_ssim_weight: float = 0.0,
                 aux_ssim_gamma_pow: float = 0.0):
        self.spec = spec
        self.buffers = buffers
        # the optional image-space training term
        # w * mean_i(gamma_i^p * (1 - SSIM_i(decode(x0_hat), HR)))
        # (model.diffusion.aux_ssim_weight / aux_ssim_gamma_pow); only the
        # noise-prediction, continuous-gamma variants decode x0_hat in
        # closed form from the training draw. p > 0 puts the SSIM signal
        # on low-noise draws, where x0_hat carries image structure.
        self.aux_ssim_weight = float(aux_ssim_weight)
        self.aux_ssim_gamma_pow = float(aux_ssim_gamma_pow)
        if self.aux_ssim_weight and (spec.prediction != "noise" or
                                     spec.conditioning != "continuous_gamma"):
            raise NotImplementedError(
                "aux_ssim_weight needs noise-pred + continuous-gamma "
                f"(got {spec.prediction}/{spec.conditioning})")
        # the fast samplers' host-side constants start from this copy (a
        # traced sampler cannot read a tensor back to the host)
        self._alphas_cumprod_host = (buffers.alphas_cumprod.cpu().numpy()
                                     .astype(np.float64))

    # forward process and training loss

    def q_sample(self, x_start: torch.Tensor, gamma: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """x_t = gamma * x0 + sqrt(1 - gamma^2) * eps, one gamma per
        sample (reference diffusion.py:233-240)."""
        gamma = gamma.reshape((-1,) + (1,) * (x_start.dim() - 1))
        return gamma * x_start + torch.sqrt(1.0 - gamma ** 2) * noise

    def sample_gammas(self, generator: torch.Generator, batch: int):
        """Training noise levels: one t ~ U{1..T} per call, then one
        gamma per sample ~ U[sqrt_acp_prev[t-1], sqrt_acp_prev[t]]
        (reference diffusion.py:248-257). Returns (gamma (B,), t (1,))."""
        b = self.buffers
        dev = b.betas.device
        t = torch.randint(1, b.num_timesteps + 1, (1,), generator=generator,
                          device=dev)
        lo = b.sqrt_alphas_cumprod_prev[t - 1]
        hi = b.sqrt_alphas_cumprod_prev[t]
        u = torch.rand((batch,), generator=generator, device=dev)
        return lo + (hi - lo) * u, t

    def training_draws(self, generator: Optional[torch.Generator], shape,
                       device) -> dict:
        """What :meth:`training_loss` draws for a batch of ``shape``
        (B,H,W,C), in its order: ``noise``, then ``gamma`` (B,)
        (continuous-gamma conditioning) or ``t`` (B,) (discrete-t). A rank
        of a process group draws them for the global batch and keeps its
        rows."""
        noise = torch.randn(tuple(shape), generator=generator, device=device)
        if self.spec.conditioning == "continuous_gamma":
            return {"noise": noise,
                    "gamma": self.sample_gammas(generator, shape[0])[0]}
        return {"noise": noise,
                "t": torch.randint(0, self.buffers.num_timesteps,
                                   (shape[0],), generator=generator,
                                   device=device)}

    def training_loss(self, denoise_fn: DenoiseFn, batch: dict,
                      generator: Optional[torch.Generator] = None, *,
                      noise: Optional[torch.Tensor] = None,
                      gamma: Optional[torch.Tensor] = None,
                      t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean loss of one batch {'HR': (B,H,W,C), 'SR': (B,H,W,C)}
        (reference model/model.py:47-52 + diffusion.py:269: the sum over
        b*c*h*w divided by that count).

        ``noise`` and then the noise level (``gamma`` for continuous-gamma
        conditioning, ``t`` (B,) for discrete-t) are drawn from
        ``generator`` unless given."""
        spec = self.spec
        x_hr, img_lr_up = batch["HR"], batch["SR"]
        x_start = (img2res(x_hr, img_lr_up) if spec.target_space == "residual"
                   else x_hr)
        bsz = x_start.shape[0]
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                device=x_start.device)
        if spec.conditioning == "continuous_gamma":
            if gamma is None:
                gamma, _ = self.sample_gammas(generator, bsz)
            x_noisy = self.q_sample(x_start, gamma, noise)
            level = gamma
        else:   # discrete_t: per-sample t ~ U{0..T-1}
            b = self.buffers
            if t is None:
                t = torch.randint(0, b.num_timesteps, (bsz,),
                                  generator=generator, device=x_start.device)
            shape1 = (-1,) + (1,) * (x_start.dim() - 1)
            x_noisy = (b.sqrt_alphas_cumprod[t].reshape(shape1) * x_start
                       + b.sqrt_one_minus_alphas_cumprod[t].reshape(shape1)
                       * noise)
            level = t.float()
        pred = denoise_fn(self._pack(x_noisy, img_lr_up), level)
        target = x_start if spec.prediction == "x0" else noise
        loss = self._loss(target, pred)
        if self.aux_ssim_weight:
            # Under -dist a rank holds an equal block of the global batch's
            # rows: the mean over its rows, averaged over the ranks by DDP's
            # gradient all-reduce, is the global batch's mean, as the L1
            # term's is.
            loss = loss + self.aux_ssim_weight * self._aux_ssim(
                x_noisy, pred, gamma, x_hr, img_lr_up)
        return loss

    def _aux_ssim(self, x_noisy, pred, gamma, x_hr, img_lr_up):
        """mean_i(w_i * (1 - SSIM_i)) of the closed-form x0_hat at the drawn
        gamma, clamped as the sampler clamps it and decoded to image
        space; w_i = gamma_i^p (ones where p is 0)."""
        g = gamma.reshape((-1,) + (1,) * (x_noisy.dim() - 1)).float()
        # divide, then clamp: no epsilon, as in JAX
        x0_hat = torch.clamp((x_noisy.float()
                              - torch.sqrt(1.0 - g ** 2) * pred.float()) / g,
                             -1.0, 1.0)
        sr_hat = (res2img(x0_hat, img_lr_up, clip=False)
                  if self.spec.target_space == "residual" else x0_hat)
        s_i = ssim((sr_hat + 1.0) * 127.5, (x_hr.float() + 1.0) * 127.5,
                   per_image=True)
        w_i = (gamma.float() ** self.aux_ssim_gamma_pow
               if self.aux_ssim_gamma_pow else torch.ones_like(s_i))
        return (w_i * (1.0 - s_i)).mean()

    def _loss(self, target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        diff = target.float() - pred.float()
        if self.spec.loss == "l1":
            return diff.abs().mean()
        if self.spec.loss == "l2":
            return (diff ** 2).mean()
        if self.spec.loss == "charbonnier":
            return torch.sqrt(diff ** 2
                              + self.spec.charbonnier_eps ** 2).mean()
        raise NotImplementedError(self.spec.loss)

    # reverse process

    def _pack(self, x: torch.Tensor,
              cond: Optional[torch.Tensor]) -> torch.Tensor:
        if not self.spec.conditional or cond is None:
            return x
        if self.spec.cond_order == "cond_first":
            return torch.cat([cond, x], dim=-1)
        return torch.cat([x, cond], dim=-1)

    def _start(self, cond, shape, generators, init_noise,
               need_generators: bool):
        """(x_T, shape, device) of a reverse process: ``init_noise`` or
        one draw from each image's generator."""
        if shape is None:
            if cond is None:
                raise ValueError("unconditional sampling needs a shape")
            shape = tuple(cond.shape)
        device = self.buffers.betas.device
        bsz = shape[0]
        if need_generators and (generators is None
                                or len(generators) != bsz):
            raise ValueError(f"need {bsz} generators, one per image")
        x = (init_noise.to(device, torch.float32) if init_noise is not None
             else normal_per_generator(generators, shape[1:], device))
        return x, shape, device

    def _finish(self, x, cond):
        # the unconditional path returns the raw (residual-space) tensor,
        # as the reference does
        if self.spec.target_space == "residual" and cond is not None:
            return res2img(x, cond)
        return x

    def _start_estimate(self, x, model_out, sqrt_a, sqrt_1m_a):
        """x0 from the denoiser's output (noise or x0 prediction),
        clipped to [-1, 1] where the spec says so."""
        if self.spec.prediction == "x0":
            x0 = model_out
        else:
            x0 = (x - sqrt_1m_a * model_out) / sqrt_a
        if self.spec.clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        return x0

    # one step of each sampler: update(carry, model_out, c, noise) -> carry,
    # where the carry is (x,) ((x, x0 of the step before) for DPM-Solver++),
    # c one step's constants and noise its draw (None where it draws none)

    def _ancestral_update(self, carry, model_out, c, noise):
        """The posterior q(x_{t-1} | x_t, x0): x0 from the output (clipped
        where the spec says so), then the posterior mean plus ``noise`` at
        the posterior's scale (none at t = 0)."""
        x, = carry
        if self.spec.prediction == "x0":
            x_recon = model_out
        else:
            x_recon = c["recip"] * x - c["recipm1"] * model_out
        if self.spec.clip_denoised:
            x_recon = torch.clamp(x_recon, -1.0, 1.0)
        mean = c["coef1"] * x_recon + c["coef2"] * x
        return (mean + c["nonzero"] * noise * torch.exp(0.5 * c["log_var"]),)

    def _ddim_update(self, carry, model_out, c, noise):
        x, = carry
        x0 = self._start_estimate(x, model_out, c["sqrt_a_t"],
                                  c["sqrt_1m_a_t"])
        # eps re-derived from the (possibly clipped) x0
        eps = (x - c["sqrt_a_t"] * x0) / c["sqrt_1m_a_t_safe"]
        x = c["sqrt_a_prev"] * x0 + c["dir_coef"] * eps
        if noise is not None:   # the deterministic path draws no noise
            x = x + c["sigma"] * noise
        return (x,)

    def _dpm_update(self, carry, model_out, c, noise):
        x, x0_prev = carry
        x0 = self._start_estimate(x, model_out, c["sqrt_a_t"],
                                  c["sqrt_1m_a_t"])
        d = c["w_cur"] * x0 + c["w_prev"] * x0_prev
        return (c["coef_x"] * x + c["coef_D"] * d, x0)

    def _levels(self, ts, noise_level: torch.Tensor) -> torch.Tensor:
        """The denoiser's level at each step: the timestep (discrete-t
        conditioning) or ``noise_level``."""
        if self.spec.conditioning == "discrete_t":
            return torch.as_tensor(np.asarray(ts, np.float32),
                                   device=noise_level.device)
        return noise_level

    def _ancestral_consts(self, ts) -> dict:
        """The ancestral steps' constants at the timesteps ``ts``, stacked
        in loop order (JAX's ``consts``)."""
        b = self.buffers
        t = torch.as_tensor(np.asarray(ts, np.int64), device=b.betas.device)
        return {"level": self._levels(ts, b.sqrt_alphas_cumprod_prev[t + 1]),
                "recip": b.sqrt_recip_alphas_cumprod[t],
                "recipm1": b.sqrt_recipm1_alphas_cumprod[t],
                "coef1": b.posterior_mean_coef1[t],
                "coef2": b.posterior_mean_coef2[t],
                "log_var": b.posterior_log_variance_clipped[t],
                "nonzero": (t > 0).float()}

    def _subsequence(self, steps: Optional[int]):
        """JAX's timestep subsequence: descending ``ts`` of ``steps`` (T
        when None) values rounded from linspace(0, T-1), ``t_prev`` the
        next one (-1 after the last), and alpha-bar at both in float64
        (1 at t = -1), computed from the float32 schedule."""
        T = self.buffers.num_timesteps
        ts = np.unique(np.linspace(0, T - 1, int(steps or T)).round()
                       .astype(np.int64))[::-1]
        t_prev = np.append(ts[1:], -1)
        ac = self._alphas_cumprod_host
        a_prev = np.where(t_prev >= 0, ac[np.maximum(t_prev, 0)], 1.0)
        return ts, t_prev, ac[ts], a_prev

    def _consts(self, **arrays) -> dict:
        """float64 per-step constants -> float32 tensors on the device
        (one copy per sampler call)."""
        dev = self.buffers.betas.device
        return {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                for k, v in arrays.items()}

    def _ddim_consts(self, steps: Optional[int], eta: float) -> dict:
        ts, _, a_t, a_prev = self._subsequence(steps)
        sigma = (eta * np.sqrt((1 - a_prev) / (1 - a_t))
                 * np.sqrt(1 - a_t / a_prev))
        c = self._consts(
            sqrt_a_t=np.sqrt(a_t), sqrt_1m_a_t=np.sqrt(1 - a_t),
            sqrt_a_prev=np.sqrt(a_prev),
            dir_coef=np.sqrt(np.maximum(1 - a_prev - sigma ** 2, 0.0)),
            sigma=sigma)
        c["sqrt_1m_a_t_safe"] = torch.clamp(c["sqrt_1m_a_t"], min=1e-8)
        c["level"] = self._levels(ts, c["sqrt_a_t"])
        return c

    def _dpm_consts(self, steps: Optional[int]) -> dict:
        ts, t_prev, a_cur, a_prev = self._subsequence(steps)
        al_cur, sg_cur = np.sqrt(a_cur), np.sqrt(1.0 - a_cur)
        al_prev, sg_prev = np.sqrt(a_prev), np.sqrt(1.0 - a_prev)
        # x_i = (sg_i/sg_{i-1}) x_{i-1} - al_i (e^{-h_i} - 1) D, which is
        # coef_x x + coef_D D with these, finite at the final step
        # (sg_prev = 0 -> coef_D = 1)
        coef_x = sg_prev / sg_cur
        coef_D = al_prev - al_cur * coef_x
        # log-SNR steps h for the 2M weights; the final h is +inf, and that
        # step is forced first order before any float32 sees it
        with np.errstate(divide="ignore"):
            lam_cur = np.log(al_cur) - np.log(sg_cur)
            lam_prev = np.where(
                t_prev >= 0,
                np.log(al_prev) - np.log(np.maximum(sg_prev, 1e-300)),
                np.inf)
        h = lam_prev - lam_cur
        w_cur, w_prev = np.ones(len(ts)), np.zeros(len(ts))
        for k in range(1, len(ts)):
            if not np.isfinite(h[k]):       # lower-order final step
                continue
            r = h[k - 1] / h[k]
            w_cur[k] = 1.0 + 1.0 / (2.0 * r)
            w_prev[k] = -1.0 / (2.0 * r)
        c = self._consts(sqrt_a_t=al_cur, sqrt_1m_a_t=sg_cur, coef_x=coef_x,
                         coef_D=coef_D, w_cur=w_cur, w_prev=w_prev)
        c["level"] = self._levels(ts, c["sqrt_a_t"])
        return c

    def _program(self, sampler: str, steps: Optional[int] = None,
                 eta: float = 0.0):
        """(constants stacked in loop order, step update, whether a step
        draws noise, whether the carry holds DPM's x0 history) of a
        sampler: what its Python loop and :meth:`sample_scan` run."""
        if sampler == "ancestral":
            T = self.buffers.num_timesteps
            return (self._ancestral_consts(range(T - 1, -1, -1)),
                    self._ancestral_update, True, False)
        if sampler == "ddim":
            return (self._ddim_consts(steps, eta), self._ddim_update,
                    eta != 0.0, False)
        if sampler == "dpm":
            return self._dpm_consts(steps), self._dpm_update, False, True
        raise ValueError(f"sampler={sampler!r} (want 'ancestral', 'ddim' "
                         "or 'dpm')")

    def _loop(self, program, denoise_fn, cond, x, noise_at, on_step=None):
        """A sampler's reverse loop from ``x``: one denoiser call and one
        update per step, step k's noise from ``noise_at(k)`` (called
        after the denoiser, only where the sampler draws)."""
        consts, update, noisy, history = program
        carry = (x, torch.zeros_like(x)) if history else (x,)
        for k in range(len(consts["level"])):
            c = {name: v[k] for name, v in consts.items()}
            x = carry[0]
            model_out = denoise_fn(self._pack(x, cond),
                                   c["level"].expand(x.shape[0])).float()
            carry = update(carry, model_out, c, noise_at(k) if noisy
                           else None)
            if on_step is not None:
                on_step(carry[0])
        return carry[0]

    @torch.no_grad()
    def sample(self,
               denoise_fn: DenoiseFn,
               cond: Optional[torch.Tensor],
               generators: Optional[Sequence[torch.Generator]] = None,
               shape: Optional[tuple] = None,
               init_noise: Optional[torch.Tensor] = None,
               noise_seq: Optional[torch.Tensor] = None,
               return_trajectory: bool = False):
        """Ancestral reverse diffusion over t = T-1 ... 0.

        ``cond`` is the bicubic-upsampled LR batch (B,H,W,C) in [-1, 1]
        (None plus ``shape`` for unconditional sampling). ``generators``
        holds one generator per image; ``init_noise`` (B,H,W,C) and
        ``noise_seq`` (T,B,H,W,C, indexed by timestep t) override the
        draws. Returns the final image, folded back through
        :func:`res2img` when the target space is the residual and
        ``cond`` is given; with ``return_trajectory``, (final, trajectory):
        the (T,B,H,W,C) stack of every x_{t-1} in sampling order (t = T-1
        ... 0), each folded back the same way, so its last frame is the
        final image.
        """
        T = self.buffers.num_timesteps
        x, shape, device = self._start(
            cond, shape, generators, init_noise,
            init_noise is None or noise_seq is None)

        def noise_at(k):
            if noise_seq is not None:
                return noise_seq[T - 1 - k].to(device, torch.float32)
            return normal_per_generator(generators, shape[1:], device)

        frames = []
        x = self._loop(self._program("ancestral"), denoise_fn, cond, x,
                       noise_at, (lambda x: frames.append(
                           self._finish(x, cond)))
                       if return_trajectory else None)
        if return_trajectory:
            return frames[-1], torch.stack(frames)
        return self._finish(x, cond)

    @torch.no_grad()
    def sample_ddim(self,
                    denoise_fn: DenoiseFn,
                    cond: Optional[torch.Tensor],
                    generators: Optional[Sequence[torch.Generator]] = None,
                    steps: Optional[int] = None,
                    eta: float = 0.0,
                    shape: Optional[tuple] = None,
                    init_noise: Optional[torch.Tensor] = None,
                    noise_seq: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """DDIM (Song et al., ICLR 2021) on the timestep subsequence of
        :meth:`_subsequence`: ``steps`` UNet evals (T when None),
        deterministic when ``eta == 0``. With ``eta > 0`` each step adds
        ``sigma_k`` times a fresh draw from each image's generator, or
        ``noise_seq[k]`` ((steps,B,H,W,C), indexed by step in loop
        order). ``init_noise`` overrides the initial draw."""
        x, shape, device = self._start(
            cond, shape, generators, init_noise,
            init_noise is None or (eta != 0.0 and noise_seq is None))

        def noise_at(k):
            if noise_seq is not None:
                return noise_seq[k].to(device, torch.float32)
            return normal_per_generator(generators, shape[1:], device)

        return self._finish(self._loop(self._program("ddim", steps, eta),
                                       denoise_fn, cond, x, noise_at), cond)

    @torch.no_grad()
    def sample_dpm(self,
                   denoise_fn: DenoiseFn,
                   cond: Optional[torch.Tensor],
                   generators: Optional[Sequence[torch.Generator]] = None,
                   steps: Optional[int] = None,
                   shape: Optional[tuple] = None,
                   init_noise: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """DPM-Solver++(2M) (Lu et al. 2022, arXiv:2211.01095, Algorithm
        2): the deterministic multistep second-order solver of the
        probability-flow ODE in data prediction, on the same timestep
        subsequence as :meth:`sample_ddim`. The first step (no history)
        and the final one (t_prev = -1, h = inf) are first order, i.e.
        the DDIM eta=0 update. The generators draw only the initial
        noise."""
        x, shape, device = self._start(cond, shape, generators, init_noise,
                                       init_noise is None)
        return self._finish(self._loop(self._program("dpm", steps),
                                       denoise_fn, cond, x, None), cond)

    def sample_scan(self, denoise_fn: DenoiseFn, cond: torch.Tensor,
                    seeds: torch.Tensor, sampler: str = "ancestral",
                    steps: Optional[int] = None,
                    eta: float = 0.0) -> torch.Tensor:
        """The sampler as one ``torch._higher_order_ops.scan`` over its
        stacked per-step constants and the step's draw index, the form the
        serving export traces for a long sampler (one UNet eval in the
        graph, whatever T). The scan carries only the map (and DPM's x0
        history) and emits nothing per step. The noise is drawn inside:
        :func:`counter_normal` of ``seeds`` (B,) int64, index 0 the
        initial map and k + 1 step k's draw, which :func:`counter_noise`
        lays out as the Python loops take it. For tracing (eager calls
        take the loops)."""
        from torch._higher_order_ops.scan import scan
        consts, update, noisy, history = self._program(sampler, steps, eta)
        shape = tuple(cond.shape[1:])
        x = counter_normal(seeds, 0, shape)
        xs = dict(consts, index=torch.arange(
            1, len(consts["level"]) + 1, device=x.device))

        def body(carry, c):
            x = carry[0]
            model_out = denoise_fn(self._pack(x, cond),
                                   c["level"].expand(x.shape[0])).float()
            noise = counter_normal(seeds, c["index"], shape) if noisy else None
            return update(carry, model_out, c, noise), ()

        carry, _ = scan(body, (x, torch.zeros_like(x)) if history else (x,),
                        xs)
        return self._finish(carry[0], cond)

    @torch.no_grad()
    def interpolate(self, denoise_fn: DenoiseFn, x1: torch.Tensor,
                    x2: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    t: Optional[int] = None, lam: float = 0.5, *,
                    noise1: Optional[torch.Tensor] = None,
                    noise2: Optional[torch.Tensor] = None,
                    noise_seq: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """Diffuse two image batches to step ``t`` (T-1 when None), mix
        them ``(1-lam)*x1 + lam*x2`` and denoise back over t-1 ... 0
        (reference ddpm_modules/diffusion.py:242-258). Unconditional.
        ``generator`` draws noise1, noise2, then one batch per step;
        ``noise1``/``noise2`` and ``noise_seq`` ((t,B,H,W,C), indexed by
        timestep) override them."""
        b = self.buffers
        t = b.num_timesteps - 1 if t is None else int(t)
        device = b.betas.device

        def draw(given, shape):
            if given is not None:
                return given.to(device, torch.float32)
            if generator is None:
                raise ValueError("interpolate draws its noise from "
                                 "generator=")
            return torch.randn(tuple(shape), generator=generator,
                               device=device)

        x1, x2 = (v.to(device, torch.float32) for v in (x1, x2))
        n1, n2 = draw(noise1, x1.shape), draw(noise2, x2.shape)
        sa, s1m = b.sqrt_alphas_cumprod[t], b.sqrt_one_minus_alphas_cumprod[t]
        x = (1 - lam) * (sa * x1 + s1m * n1) + lam * (sa * x2 + s1m * n2)
        program = (self._ancestral_consts(range(t - 1, -1, -1)),
                   self._ancestral_update, True, False)
        return self._loop(program, denoise_fn, None, x, lambda k: draw(
            None if noise_seq is None else noise_seq[t - 1 - k], x.shape))
