"""Differentiable SSIM matching the eval metric's formula.

Counterpart of ``fastdiffsr_tpu/ops/dssim.py`` (MATLAB-style SSIM,
reference core/metrics.py:104-125): an 11-tap Gaussian window with sigma
1.5 per channel, C1 = (0.01*255)^2, C2 = (0.03*255)^2, statistics over
the VALID region (``metrics._ssim_single`` crops the bordered filter
output to [5:-5], which equals a VALID convolution), channels averaged
as ``metrics.calculate_ssim`` does.

The window is separable: one depthwise VALID pass along H, then one
along W, as two ``F.conv2d(..., groups=C)``, the order of the JAX
package's two ``conv_general_dilated``. It is an XLA convolution there,
not a Pallas kernel, so this plain PyTorch form is its port.

Used by the optional image-space training loss of
``diffusion/engine.py`` (``model.diffusion.aux_ssim_weight``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

C1 = (0.01 * 255) ** 2
C2 = (0.03 * 255) ** 2


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel(11, 1.5): normalised in float64, stored as
    float32."""
    half = (size - 1) / 2.0
    x = np.arange(size, dtype=np.float64) - half
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window_on(device: torch.device) -> torch.Tensor:
    """The window as a tensor on ``device``, copied there once: a copy per
    call would wait for the device's queue to drain at every training
    step. Made outside inference mode, so autograd may save it."""
    with torch.inference_mode(False):
        return torch.from_numpy(_gaussian_window()).to(device)


def _depthwise_sep_filter(x: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable VALID depthwise filter of an NCHW map, along H then W."""
    c, n = x.shape[1], k1d.numel()
    x = F.conv2d(x, k1d.reshape(1, 1, n, 1).expand(c, 1, n, 1), groups=c)
    return F.conv2d(x, k1d.reshape(1, 1, 1, n).expand(c, 1, 1, n), groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         per_image: bool = False) -> torch.Tensor:
    """Mean SSIM over the batch, or per-image (B,) means with
    ``per_image=True``. Inputs (B,H,W,C) on the 0..255 scale (map [-1, 1]
    activations with ``(x + 1) * 127.5`` first), H and W at least 11;
    computed in float32. Differentiable."""
    k = _window_on(img1.device)
    a = img1.float().permute(0, 3, 1, 2)
    b = img2.float().permute(0, 3, 1, 2)
    mu1 = _depthwise_sep_filter(a, k)
    mu2 = _depthwise_sep_filter(b, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _depthwise_sep_filter(a ** 2, k) - mu1_sq
    sigma2_sq = _depthwise_sep_filter(b ** 2, k) - mu2_sq
    sigma12 = _depthwise_sep_filter(a * b, k) - mu1_mu2
    ssim_map = (((2 * mu1_mu2 + C1) * (2 * sigma12 + C2))
                / ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)))
    if per_image:
        return ssim_map.mean(dim=(1, 2, 3))
    return ssim_map.mean()
