"""EDiffSR degradations: counterpart of ``fastdiffsr_tpu/ediffsr/deg.py``
(reference EDiffSR/codes/utils/deg_utils.py).

- :func:`upscale` (:38): the bicubic conditioning upsample mu of every
  train step and restore. The JAX package computes it with
  ``jax.image.resize(..., "bicubic")``: Keys' cubic with a = -0.5, the
  weights of each output pixel renormalised to sum 1 (which matters at
  the borders), antialiased when downscaling
  (``jax._src.image.scale.compute_weight_mat``). ``F.interpolate``'s
  bicubic uses a = -0.75 and clamps at the borders, a different function
  (up to ~9 % of the range apart on noise). So the weight matrix of each
  axis is built here as JAX builds it, in float64 on the host, cached per
  (in, out) size, and applied as two small matmuls on the device.
- :func:`add_noise` (:13): x + N(0,1) * sigma, sigma > 1 meaning /255.
- :func:`mask_to` (:19): keep-masks from ``{mask_root}/{id:06d}.png``,
  nearest-resized as ``jax.image.resize(..., "nearest")`` does, holes
  filled with 1.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float64 bicubic resampling matrix of one axis, as
    ``jax.image.resize`` computes it (scale out/in, no translation,
    antialias on)."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]
               ) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0)


def _weights_on(in_size, out_size, device) -> torch.Tensor:
    return torch.from_numpy(resize_weights(in_size, out_size)).to(
        device=device, dtype=torch.float32)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B,H,W,C) -> (B,out_h,out_w,C), ``jax.image.resize`` bicubic."""
    b, h, w, c = x.shape
    x = x.float()
    if out_h != h:
        x = torch.einsum("bhwc,ho->bowc", x, _weights_on(h, out_h, x.device))
    if out_w != w:
        x = torch.einsum("bhwc,wo->bhoc", x, _weights_on(w, out_w, x.device))
    return x


def upscale(x: torch.Tensor, scale: int = 4,
            mode: str = "bicubic") -> torch.Tensor:
    """(B,H,W,C) -> (B,H*s,W*s,C) (deg_utils.py:38-40)."""
    if mode != "bicubic":
        raise NotImplementedError(f"upscale mode {mode!r} (want bicubic)")
    _, h, w, _ = x.shape
    return resize_bicubic(x, h * scale, w * scale)


def add_noise(x: torch.Tensor, sigma: float,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x + N(0,1)*sigma; sigma given in [0,255] units is rescaled
    (deg_utils.py:13-15)."""
    sigma = sigma / 255.0 if sigma > 1 else sigma
    return x + torch.randn(x.shape, generator=generator, device=x.device,
                           dtype=x.dtype) * sigma


def _load_mask(path: str) -> np.ndarray:
    from ..metrics import load_img
    return load_img(path).astype(np.float32) / 255.0


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """``jax.image.resize`` nearest: floor((i + 0.5) * in / out)."""
    offsets = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
               * np.float32(in_size) / np.float32(out_size))
    return np.floor(offsets).astype(np.int64)


def mask_to(x: torch.Tensor, mask_root: str, mask_id: int = -1,
            n: int = 100,
            rng: Optional[np.random.Generator] = None) -> torch.Tensor:
    """Apply keep-masks from ``mask_root/{id:06d}.png``: masked regions
    (mask == 0) become 1.0 (deg_utils.py:19-34). ``mask_id < 0`` draws one
    random mask per batch element."""
    b, h, w, c = x.shape
    if mask_id < 0:
        rng = rng or np.random.default_rng()
        ids = rng.integers(0, n, b)
        masks = np.stack([
            _load_mask(os.path.join(mask_root, f"{int(i):06d}.png"))
            for i in ids])
    else:
        masks = _load_mask(os.path.join(mask_root, f"{mask_id:06d}.png"))[None]
        masks = np.broadcast_to(masks, (b,) + masks.shape[1:])
    masks = masks[:, _nearest_index(masks.shape[1], h)][
        :, :, _nearest_index(masks.shape[2], w)]
    m = torch.from_numpy(np.ascontiguousarray(masks)).to(x.device)
    if m.shape[-1] != c:
        m = m[..., :1].repeat(1, 1, 1, c)
    return m * x + (1.0 - m)
