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
one ``lax.scan`` program.

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

    def predict_start_from_noise(self, x_t, t_idx: int, noise):
        b = self.buffers
        return (b.sqrt_recip_alphas_cumprod[t_idx] * x_t
                - b.sqrt_recipm1_alphas_cumprod[t_idx] * noise)

    def q_posterior(self, x_start, x_t, t_idx: int):
        b = self.buffers
        mean = (b.posterior_mean_coef1[t_idx] * x_start
                + b.posterior_mean_coef2[t_idx] * x_t)
        return mean, b.posterior_log_variance_clipped[t_idx]

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

    def _ancestral_step(self, x, model_out, t: int, noise):
        """One reverse step of the posterior q(x_{t-1} | x_t, x0): x0 from
        the output (clipped where the spec says so), then the posterior
        mean plus ``noise`` at the posterior's scale (none at t = 0)."""
        if self.spec.prediction == "x0":
            x_recon = model_out
        else:
            x_recon = self.predict_start_from_noise(x, t, model_out)
        if self.spec.clip_denoised:
            x_recon = torch.clamp(x_recon, -1.0, 1.0)
        mean, log_var = self.q_posterior(x_recon, x, t)
        nonzero = 1.0 if t > 0 else 0.0
        return mean + nonzero * noise * torch.exp(0.5 * log_var)

    def _level(self, t: int, noise_level: torch.Tensor, bsz: int, device):
        if self.spec.conditioning == "discrete_t":
            return torch.full((bsz,), float(t), device=device)
        return noise_level.expand(bsz)

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
        b = self.buffers
        x, shape, device = self._start(
            cond, shape, generators, init_noise,
            init_noise is None or noise_seq is None)
        bsz = shape[0]
        frames = []
        for t in range(b.num_timesteps - 1, -1, -1):
            level = self._level(t, b.sqrt_alphas_cumprod_prev[t + 1], bsz,
                                device)
            model_out = denoise_fn(self._pack(x, cond), level).float()
            if noise_seq is not None:
                noise = noise_seq[t].to(device, torch.float32)
            else:
                noise = normal_per_generator(generators, shape[1:], device)
            x = self._ancestral_step(x, model_out, t, noise)
            if return_trajectory:
                frames.append(self._finish(x, cond))
        if return_trajectory:
            return frames[-1], torch.stack(frames)
        return self._finish(x, cond)

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
        ts, _, a_t, a_prev = self._subsequence(steps)
        sigma = (eta * np.sqrt((1 - a_prev) / (1 - a_t))
                 * np.sqrt(1 - a_t / a_prev))
        c = self._consts(
            sqrt_a_t=np.sqrt(a_t), sqrt_1m_a_t=np.sqrt(1 - a_t),
            sqrt_a_prev=np.sqrt(a_prev),
            dir_coef=np.sqrt(np.maximum(1 - a_prev - sigma ** 2, 0.0)),
            sigma=sigma)
        c["sqrt_1m_a_t_safe"] = torch.clamp(c["sqrt_1m_a_t"], min=1e-8)
        noisy = eta != 0.0
        x, shape, device = self._start(
            cond, shape, generators, init_noise,
            init_noise is None or (noisy and noise_seq is None))
        bsz = shape[0]
        for k, t in enumerate(ts):
            level = self._level(t, c["sqrt_a_t"][k], bsz, device)
            model_out = denoise_fn(self._pack(x, cond), level).float()
            x0 = self._start_estimate(x, model_out, c["sqrt_a_t"][k],
                                      c["sqrt_1m_a_t"][k])
            # eps re-derived from the (possibly clipped) x0
            eps = (x - c["sqrt_a_t"][k] * x0) / c["sqrt_1m_a_t_safe"][k]
            x = c["sqrt_a_prev"][k] * x0 + c["dir_coef"][k] * eps
            if noisy:   # the deterministic path draws no noise
                noise = (noise_seq[k].to(device, torch.float32)
                         if noise_seq is not None
                         else normal_per_generator(generators, shape[1:],
                                                   device))
                x = x + c["sigma"][k] * noise
        return self._finish(x, cond)

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
        x, shape, device = self._start(cond, shape, generators, init_noise,
                                       init_noise is None)
        bsz = shape[0]
        x0_prev = torch.zeros_like(x)
        for k, t in enumerate(ts):
            level = self._level(t, c["sqrt_a_t"][k], bsz, device)
            model_out = denoise_fn(self._pack(x, cond), level).float()
            x0 = self._start_estimate(x, model_out, c["sqrt_a_t"][k],
                                      c["sqrt_1m_a_t"][k])
            d = c["w_cur"][k] * x0 + c["w_prev"][k] * x0_prev
            x = c["coef_x"][k] * x + c["coef_D"][k] * d
            x0_prev = x0
        return self._finish(x, cond)

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
        bsz = x1.shape[0]
        for t_idx in range(t - 1, -1, -1):
            level = self._level(t_idx, b.sqrt_alphas_cumprod_prev[t_idx + 1],
                                bsz, device)
            model_out = denoise_fn(x, level).float()
            noise = draw(None if noise_seq is None else noise_seq[t_idx],
                         x.shape)
            x = self._ancestral_step(x, model_out, t_idx, noise)
        return x
