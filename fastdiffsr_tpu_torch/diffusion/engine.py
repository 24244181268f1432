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

the training loss (:meth:`DiffusionEngine.training_loss`) and the
ancestral sampler. PyTorch runs eagerly, so the T steps are a Python loop
around the denoiser instead of one ``lax.scan`` program.

Noise: JAX keys become ``torch.Generator``s. The sampler takes one
generator per image and draws that image's initial noise and then one
draw per step from it, in a fixed order, so an image's result depends on
its own generator only and not on how images are batched (the contract
of ``rng_is_batched`` there). Tests inject ``init_noise`` / ``noise_seq``
to feed both packages the same draws. The training loss draws its noise
and noise level from one generator; tests inject ``noise`` and
``gamma``/``t`` instead.

DDIM, DPM-Solver++, ``interpolate`` and the auxiliary SSIM loss are not
ported yet. Layout is NHWC throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

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
                 aux_ssim_weight: float = 0.0):
        if aux_ssim_weight:
            raise NotImplementedError(
                "model.diffusion.aux_ssim_weight needs ops/dssim.py, which "
                "is not ported yet (ROADMAP.md queue 5, opt-in ops)")
        self.spec = spec
        self.buffers = buffers

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
        return self._loss(target, pred)

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

    @torch.no_grad()
    def sample(self,
               denoise_fn: DenoiseFn,
               cond: Optional[torch.Tensor],
               generators: Optional[Sequence[torch.Generator]] = None,
               shape: Optional[tuple] = None,
               init_noise: Optional[torch.Tensor] = None,
               noise_seq: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Ancestral reverse diffusion over t = T-1 ... 0.

        ``cond`` is the bicubic-upsampled LR batch (B,H,W,C) in [-1, 1]
        (None plus ``shape`` for unconditional sampling). ``generators``
        holds one generator per image; ``init_noise`` (B,H,W,C) and
        ``noise_seq`` (T,B,H,W,C, indexed by timestep t) override the
        draws. Returns the final image, folded back through
        :func:`res2img` when the target space is the residual.
        """
        spec = self.spec
        b = self.buffers
        T = b.num_timesteps
        if shape is None:
            if cond is None:
                raise ValueError("unconditional sampling needs a shape")
            shape = tuple(cond.shape)
        device = b.betas.device
        bsz = shape[0]
        if (init_noise is None or noise_seq is None) and (
                generators is None or len(generators) != bsz):
            raise ValueError(f"need {bsz} generators, one per image")

        x = (init_noise.to(device, torch.float32) if init_noise is not None
             else normal_per_generator(generators, shape[1:], device))
        for t in range(T - 1, -1, -1):
            if spec.conditioning == "discrete_t":
                level = torch.full((bsz,), float(t), device=device)
            else:
                level = b.sqrt_alphas_cumprod_prev[t + 1].expand(bsz)
            model_out = denoise_fn(self._pack(x, cond), level).float()
            if spec.prediction == "x0":
                x_recon = model_out
            else:
                x_recon = self.predict_start_from_noise(x, t, model_out)
            if spec.clip_denoised:
                x_recon = torch.clamp(x_recon, -1.0, 1.0)
            mean, log_var = self.q_posterior(x_recon, x, t)
            if noise_seq is not None:
                noise = noise_seq[t].to(device, torch.float32)
            else:
                noise = normal_per_generator(generators, shape[1:], device)
            nonzero = 1.0 if t > 0 else 0.0
            x = mean + nonzero * noise * torch.exp(0.5 * log_var)

        # the unconditional path returns the raw (residual-space) tensor,
        # as the reference does
        if spec.target_space == "residual" and cond is not None:
            return res2img(x, cond)
        return x
