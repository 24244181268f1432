"""Plain copies of the diffusion arithmetic the benchmark checks.

- the two beta schedules its configurations use: ``linear`` (SR3's
  ``ddpm``, T=1000) and ``linear_cosine`` (FastDiffSR, T=20: the linear
  betas plus twice the cosine schedule's, clipped to [0, 0.999]), and the
  posterior tables derived from them in float64, stored as float32;
- the ancestral reverse step q(x_{t-1} | x_t, x0) of a noise-predicting
  net, x0 clipped to [-1, 1], and FastDiffSR's residual finish
  (SR = clamp(res)/2 + bicubic);
- the training loss (L1 between the drawn noise and the prediction) with
  its draws: FastDiffSR one t ~ U{1..T} per batch, then gamma ~
  U[sqrt(acp_prev[t-1]), sqrt(acp_prev[t])] per image, the noisy
  residual gamma*x0 + sqrt(1-gamma^2)*eps; ddpm one t ~ U{0..T-1} per
  image and the noisy HR image;
- Adam (b1 0.9, b2 0.999, eps 1e-8) and the EMA of the parameters.

The random draws are made in the order and with the calls that the
served and trained program is specified to make them (the initial noise
and one draw per step from each image's generator; the step's noise, its
level, then the dropout masks from the step's generator), so that the
reference and the program see the same numbers. The seeds of those
generators are worked out here from the run's seed.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# which_model_G -> (what the net is told of the noise, whether the
# sampler works on the residual SR - bicubic)
VARIANTS = {"fastdiffsr": ("continuous_gamma", True),
            "ddpm": ("discrete_t", False)}


def image_seed(seed: int, index: int) -> int:
    """The seed of image ``index``'s sampling generator."""
    return int(np.random.SeedSequence([int(seed), 0, int(index)])
               .generate_state(1, np.uint64)[0])


def step_seed(seed: int, step: int) -> int:
    """The seed of train step ``step``'s generator."""
    return int(np.random.SeedSequence([int(seed), 1, int(step)])
               .generate_state(1, np.uint64)[0])


def betas(schedule: dict) -> np.ndarray:
    n = int(schedule["n_timestep"])
    lo, hi = float(schedule["linear_start"]), float(schedule["linear_end"])
    lin = np.linspace(lo, hi, n, dtype=np.float64)
    if schedule["schedule"] == "linear":
        return lin
    if schedule["schedule"] == "linear_cosine":
        s = 8e-3
        steps = n + 1
        x = np.linspace(0, steps, steps)
        acp = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
        acp = acp / acp[0]
        cos = np.clip(1 - acp[1:] / acp[:-1], 0, 0.999)
        return np.clip(lin + 2.0 * cos, 0, 0.999)
    raise ValueError(f"no reference for schedule {schedule['schedule']!r}")


def tables(schedule: dict, device) -> Dict[str, torch.Tensor]:
    """The schedule's tables as float32 tensors on ``device``."""
    b = betas(schedule)
    acp = np.cumprod(1.0 - b)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = b * (1.0 - acp_prev) / (1.0 - acp)
    t = {"sqrt_acp": np.sqrt(acp),
         "sqrt_1m_acp": np.sqrt(1.0 - acp),
         "sqrt_acp_prev": np.sqrt(np.append(1.0, acp)),     # length T+1
         "recip": np.sqrt(1.0 / acp),
         "recipm1": np.sqrt(1.0 / acp - 1.0),
         "log_var": np.log(np.maximum(post_var, 1e-20)),
         "coef1": b * np.sqrt(acp_prev) / (1.0 - acp),
         "coef2": (1.0 - acp_prev) * np.sqrt(1.0 - b) / (1.0 - acp)}
    out = {k: torch.from_numpy(v.astype(np.float32)).to(device)
           for k, v in t.items()}
    out["T"] = len(b)
    return out


def per_image_normal(gens: Sequence[torch.Generator], shape, device):
    return torch.stack([torch.randn(tuple(shape), generator=g, device=device)
                        for g in gens])


@torch.no_grad()
def sample_ancestral(net: Callable, tab: dict, cond: torch.Tensor,
                     gens: Sequence[torch.Generator], conditioning: str,
                     residual: bool) -> torch.Tensor:
    """T ancestral steps from each image's generator's draws; ``cond`` the
    bicubic-upsampled LR batch (B,H,W,C). ``conditioning`` is
    ``continuous_gamma`` (the net gets sqrt(acp_prev[t+1])) or
    ``discrete_t`` (it gets t)."""
    dev = cond.device
    shape = cond.shape[1:]
    bsz = cond.shape[0]
    x = per_image_normal(gens, shape, dev)
    for t in range(tab["T"] - 1, -1, -1):
        level = (tab["sqrt_acp_prev"][t + 1] if conditioning ==
                 "continuous_gamma" else torch.tensor(float(t), device=dev))
        eps = net(torch.cat([cond, x], dim=-1),
                  level.expand(bsz)).float()
        x0 = torch.clamp(tab["recip"][t] * x - tab["recipm1"][t] * eps,
                         -1.0, 1.0)
        mean = tab["coef1"][t] * x0 + tab["coef2"][t] * x
        noise = per_image_normal(gens, shape, dev)
        x = mean + (1.0 if t > 0 else 0.0) * noise * torch.exp(
            0.5 * tab["log_var"][t])
    return torch.clamp(x, -1.0, 1.0) / 2.0 + cond if residual else x


def training_loss(net, tab: dict, hr: torch.Tensor, sr: torch.Tensor,
                  gen: torch.Generator, variant: str) -> torch.Tensor:
    """One batch's loss, its draws from ``gen`` (the dropout masks
    after the step's noise and level)."""
    dev = hr.device
    bsz = hr.shape[0]
    if variant == "fastdiffsr":
        x0 = torch.clamp((hr - sr) * 2.0, -1.0, 1.0)
        noise = torch.randn(x0.shape, generator=gen, device=dev)
        t = torch.randint(1, tab["T"] + 1, (1,), generator=gen, device=dev)
        lo, hi = tab["sqrt_acp_prev"][t - 1], tab["sqrt_acp_prev"][t]
        u = torch.rand((bsz,), generator=gen, device=dev)
        gamma = lo + (hi - lo) * u
        g = gamma.reshape(-1, 1, 1, 1)
        x_noisy = g * x0 + torch.sqrt(1.0 - g ** 2) * noise
        level = gamma
    elif variant == "ddpm":
        x0 = hr
        noise = torch.randn(x0.shape, generator=gen, device=dev)
        t = torch.randint(0, tab["T"], (bsz,), generator=gen, device=dev)
        x_noisy = (tab["sqrt_acp"][t].reshape(-1, 1, 1, 1) * x0
                   + tab["sqrt_1m_acp"][t].reshape(-1, 1, 1, 1) * noise)
        level = t.float()
    else:
        raise ValueError(f"no reference loss for {variant!r}")
    pred = net(torch.cat([sr, x_noisy], dim=-1), level, generator=gen)
    return (noise - pred.float()).abs().mean()


class Adam:
    """Adam with bias correction, as one update per ``step``."""

    def __init__(self, params: List[torch.Tensor], lr: float):
        self.params, self.lr, self.t = params, float(lr), 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - ADAM_B1 ** self.t
        c2 = 1.0 - ADAM_B2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS))


def ema_decay(decay: float, start: int, step: int) -> float:
    """The EMA's decay at train step ``step``: 0 (a copy) before ``start``."""
    return decay if step >= start else 0.0


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor],
               decay: float) -> None:
    """ema + (1 - decay) * (p - ema): the weights of ema and p sum to one
    exactly, so a decay of 0.9999 moves the EMA by its share of p - ema
    and not by the rounding of 0.9999 and 1 - 0.9999 apart."""
    for e, p in zip(ema, params):
        e.add_((p - e) * (1.0 - decay))
