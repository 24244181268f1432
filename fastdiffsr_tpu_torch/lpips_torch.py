"""LPIPS (AlexNet backbone) in PyTorch.

Counterpart of ``fastdiffsr_tpu/lpips_jax.py``, the metric of the
reference's core/metrics.py:154-164 (its vendored PerceptualSimilarity
package): the AlexNet feature taps after each of the five ReLUs (max-pools
after the first two), LPIPS's shift/scale input layer, unit-normalised
channels, the squared difference weighted by one linear head per tap,
and the spatial mean, summed over the taps.

The backbone weights come from torchvision's model zoo, which the port
does not fetch, so LPIPS is optional: ``LPIPS.load_default`` reads the
``.npz`` weight pack that ``LPIPSJax.load_default`` reads (``conv{i}_w``
HWIO, ``conv{i}_b``, ``lin{i}``), from ``FASTDIFFSR_TPU_LPIPS`` or else
``fastdiffsr_tpu_torch/assets/lpips_alex.npz``, and raises
FileNotFoundError when there is none (``metrics.calculate_lpips`` then
returns None). One pack serves both packages.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# AlexNet feature slices used by LPIPS: (out_channels, kernel, stride,
# padding), torchvision order
ALEX_CFG = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
            (256, 3, 1, 1), (256, 3, 1, 1)]
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def lpips_params_from_pack(pack) -> Dict[str, torch.Tensor]:
    """The module's tensors from a weight pack's arrays: conv kernels HWIO
    -> OIHW, biases and the (C,) linear heads as they are."""
    out = {}
    for i in range(len(ALEX_CFG)):
        out[f"conv{i}_w"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(pack[f"conv{i}_w"], np.float32).transpose(3, 2, 0, 1)))
        out[f"conv{i}_b"] = torch.from_numpy(
            np.asarray(pack[f"conv{i}_b"], np.float32))
        out[f"lin{i}"] = torch.from_numpy(
            np.asarray(pack[f"lin{i}"], np.float32).reshape(-1))
    return out


def random_pack(seed: int) -> Dict[str, np.ndarray]:
    """A seeded weight pack in the pack's layout, for checks where the
    real weights are absent: kernels N(0, 1/fan_in), biases 0.1 N, heads
    U(0, 0.2)."""
    rng = np.random.default_rng(seed)
    pack, cin = {}, 3
    for i, (co, k, _, _) in enumerate(ALEX_CFG):
        pack[f"conv{i}_w"] = (rng.standard_normal((k, k, cin, co))
                              / np.sqrt(k * k * cin)).astype(np.float32)
        pack[f"conv{i}_b"] = (0.1 * rng.standard_normal(co)).astype(
            np.float32)
        pack[f"lin{i}"] = rng.uniform(0, 0.2, co).astype(np.float32)
        cin = co
    return pack


def default_pack_path() -> str:
    return os.environ.get(
        "FASTDIFFSR_TPU_LPIPS",
        os.path.join(os.path.dirname(__file__), "assets", "lpips_alex.npz"))


class LPIPS(nn.Module):
    """LPIPS-alex distance on an explicit device, in float32."""

    def __init__(self, params: Dict[str, torch.Tensor], device="cpu"):
        super().__init__()
        for k, v in params.items():
            self.register_buffer(k, v.to(device=device, dtype=torch.float32))
        self.register_buffer("shift", torch.tensor(
            SHIFT, device=device).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(
            SCALE, device=device).view(1, 3, 1, 1))

    @classmethod
    def load_default(cls, device="cpu") -> "LPIPS":
        path = default_pack_path()
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"LPIPS weight pack not found at {path}; set "
                "FASTDIFFSR_TPU_LPIPS to a pack that the JAX package's "
                "lpips_jax --export wrote")
        with np.load(path) as pack:
            return cls(lpips_params_from_pack(pack), device=device)

    def features(self, x: torch.Tensor):
        """x: (B,3,H,W) after the shift/scale layer -> the five taps."""
        feats = []
        for i, (_, _, s, p) in enumerate(ALEX_CFG):
            x = F.relu(F.conv2d(x, getattr(self, f"conv{i}_w"),
                                getattr(self, f"conv{i}_b"), stride=s,
                                padding=p))
            feats.append(x)
            if i < 2:
                x = F.max_pool2d(x, 3, 2)
        return feats

    @torch.no_grad()
    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(B,) distances of two (B,H,W,3) batches in [-1, 1]."""
        def prep(x):
            return (x.permute(0, 3, 1, 2) - self.shift) / self.scale

        total = 0.0
        for i, (fa, fb) in enumerate(zip(self.features(prep(a)),
                                         self.features(prep(b)))):
            na = fa / (fa.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
            nb = fb / (fb.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
            d = ((na - nb) ** 2 * getattr(self, f"lin{i}").view(1, -1, 1, 1)
                 ).sum(1)
            total = total + d.mean(dim=(1, 2))
        return total

    def distance(self, img1_u8: np.ndarray, img2_u8: np.ndarray) -> float:
        """LPIPS distance of two uint8 HWC images."""
        dev = self.shift.device

        def prep(img):
            x = img.astype(np.float32) / 255.0 * 2.0 - 1.0
            return torch.from_numpy(x[None]).to(dev)

        return float(self(prep(img1_u8), prep(img2_u8))[0])
