"""The weights and the image tiles of a run, made on the device from the
run's seed.

Weights are made by parameter name, from the reference UNet's list of
names and shapes: one ``randn`` over all of them, then each leaf scaled
as a trained net's leaves roughly are (convolution and linear weights
N(0, 1/fan_in), GroupNorm scales 1 + N(0, 0.1^2), every bias and
GroupNorm shift N(0, 0.1^2)). The same dict loads into the program's
net and into the reference.

Tiles: high-resolution images in [-1, 1] with detail at three scales,
their bicubic (antialiased) 4x reduction and its bicubic upsampling back
to full size clamped to [-1, 1], the conditioning the nets take. NHWC
float32. Two seeds give different tiles of the same sizes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..reference.unets import build_unet

WEIGHTS, TILES, ORDER = 11, 12, 13     # streams derived from a run's seed


def derived_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([int(seed), 7, stream])
               .generate_state(1, np.uint64)[0])


def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    net = build_unet(model, device="meta")
    norms = {f"{m_name}.{p}" for m_name, m in net.named_modules()
             if isinstance(m, nn.GroupNorm) for p in ("weight", "bias")}
    named = list(net.named_parameters())
    total = sum(p.numel() for _, p in named)
    g = torch.Generator(device=device).manual_seed(
        derived_seed(seed, WEIGHTS))
    z = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, p in named:
        leaf = z[at:at + p.numel()].view(p.shape)
        at += p.numel()
        if name in norms and name.endswith("weight"):
            leaf = 1.0 + 0.1 * leaf
        elif p.dim() >= 2:
            leaf = leaf * (p[0].numel() ** -0.5)
        else:
            leaf = 0.1 * leaf
        out[name] = leaf
    return out


def make_tiles(seed: int, n: int, size: int, scale: int, device,
               chunk: int = 64):
    """(HR, SR) of ``n`` tiles of ``size``^2: (n, size, size, 3) float32."""
    g = torch.Generator(device=device).manual_seed(derived_seed(seed, TILES))
    hrs, srs = [], []
    for at in range(0, n, chunk):
        b = min(chunk, n - at)
        x = torch.zeros((b, 3, size, size), device=device)
        for cells, amp in ((size // 16, 1.0), (size // 4, 0.5),
                           (size, 0.15)):
            z = torch.randn((b, 3, cells, cells), generator=g, device=device)
            x += amp * F.interpolate(z, size=(size, size), mode="bicubic",
                                     align_corners=False)
        hr = torch.tanh(x)
        lr = F.interpolate(hr, size=(size // scale, size // scale),
                           mode="bicubic", align_corners=False,
                           antialias=True)
        sr = torch.clamp(F.interpolate(lr, size=(size, size), mode="bicubic",
                                       align_corners=False), -1.0, 1.0)
        hrs.append(hr.permute(0, 2, 3, 1).contiguous())
        srs.append(sr.permute(0, 2, 3, 1).contiguous())
    return torch.cat(hrs), torch.cat(srs)


def order(seed: int, n_draws: int, per_draw: int, pool: int) -> np.ndarray:
    """(n_draws, per_draw) tile indices, distinct within a draw."""
    rng = np.random.default_rng(derived_seed(seed, ORDER))
    return np.stack([rng.choice(pool, per_draw, replace=False)
                     for _ in range(n_draws)])
