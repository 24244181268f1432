"""Host-side image utilities of the EDiffSR data pipeline (numpy only).

A copy of ``fastdiffsr_tpu/ediffsr/imgproc.py`` (reference
EDiffSR/codes/data/util.py):
- ``imresize`` (:305) — MATLAB-compatible bicubic resize with antialiasing
  (the on-the-fly LR degradation when no LQ folder is given,
  LQGT_dataset.py:128): align-centres coordinate mapping, width-4 cubic
  kernel widened by 1/scale when downscaling, symmetric edge padding,
  row-normalized weights.
- ``rgb2ycbcr`` / ``bgr2ycbcr`` / ``ycbcr2rgb`` (:153,177,201) — MATLAB
  colorspace conversions (Y-only metric evaluation).
- ``modcrop`` (:221) — crop H,W to multiples of scale (val/test phase).
- ``channel_convert`` (:139) — BGR/gray/y conversion dispatch.
- ``augment`` (:84) — train-time flip/rot: three independent p=0.5 draws
  (hflip, vflip, rot90-by-transpose) applied consistently to every image
  in the list.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np


def cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic convolution kernel, a = -0.5 (data/util.py:239-248)."""
    absx = np.abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    return ((1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1)
            + (-0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2)
            * ((absx > 1) & (absx <= 2)))


def _weights_indices(in_length: int, out_length: int, scale: float,
                     kernel_width: float, antialiasing: bool):
    """Per-output-pixel contribution weights + source indices
    (data/util.py:251-303). Returns (weights (out,P), indices (out,P) into
    the symmetrically-padded axis, pad_start, pad_end)."""
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    P = int(math.ceil(kernel_width)) + 2

    indices = left[:, None] + np.arange(P, dtype=np.float64)[None, :]
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * cubic(dist * scale)
    else:
        weights = cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)

    # drop an all-zero first/last column
    zero_cols = np.sum(weights == 0, axis=0)
    if not math.isclose(zero_cols[0], 0, rel_tol=1e-6):
        indices = indices[:, 1:P - 1]
        weights = weights[:, 1:P - 1]
    if not math.isclose(zero_cols[-1], 0, rel_tol=1e-6):
        indices = indices[:, 0:P - 2]
        weights = weights[:, 0:P - 2]

    pad_s = int(-indices.min() + 1)
    pad_e = int(indices.max() - in_length)
    indices = (indices + pad_s - 1).astype(np.int64)
    return weights, indices, pad_s, pad_e


def _sym_pad(arr: np.ndarray, pad_s: int, pad_e: int) -> np.ndarray:
    """Symmetric (reflect-with-repeat) padding along axis 0."""
    parts = []
    if pad_s > 0:
        parts.append(arr[pad_s - 1::-1])
    parts.append(arr)
    if pad_e > 0:
        parts.append(arr[:len(arr) - pad_e - 1:-1])
    return np.concatenate(parts, axis=0) if len(parts) > 1 else arr


def imresize(img: np.ndarray, scale: float,
             antialiasing: bool = True) -> np.ndarray:
    """MATLAB-compatible bicubic resize of an HWC (or HW) float image
    (data/util.py:305-420; the reference works on CHW torch tensors — this
    is the same separable algorithm on HWC numpy). No rounding/clipping;
    output H,W = ceil(in * scale)."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    in_H, in_W, C = img.shape
    out_H = int(math.ceil(in_H * scale))
    out_W = int(math.ceil(in_W * scale))

    w_H, idx_H, pad_Hs, pad_He = _weights_indices(in_H, out_H, scale, 4,
                                                  antialiasing)
    w_W, idx_W, pad_Ws, pad_We = _weights_indices(in_W, out_W, scale, 4,
                                                  antialiasing)

    work = img.astype(np.float64, copy=False)
    # H pass: (in_H+pad, W, C) gathered to (out_H, P, W, C) -> weighted sum
    work = _sym_pad(work, pad_Hs, pad_He)
    work = np.einsum("op,opwc->owc", w_H, work[idx_H])
    # W pass on the transposed view
    work = np.transpose(work, (1, 0, 2))           # (W, out_H, C)
    work = _sym_pad(work, pad_Ws, pad_We)
    work = np.einsum("op,ophc->ohc", w_W, work[idx_W])
    out = np.transpose(work, (1, 0, 2)).astype(img.dtype, copy=False)
    return out[:, :, 0] if squeeze else out


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H, W down to multiples of scale (data/util.py:221-234)."""
    if img.ndim == 2:
        h, w = img.shape
        return img[:h - h % scale, :w - w % scale]
    if img.ndim == 3:
        h, w, _ = img.shape
        return img[:h - h % scale, :w - w % scale, :]
    raise ValueError(f"Wrong img ndim: [{img.ndim}].")


def _colorspace(img: np.ndarray, mat, offset) -> np.ndarray:
    in_type = img.dtype
    x = img.astype(np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    out = x @ np.asarray(mat, np.float64) / 255.0 + np.asarray(offset)
    if in_type == np.uint8:
        out = out.round()
    else:
        out = out / 255.0
    return out.astype(in_type)


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """MATLAB rgb2ycbcr; uint8 [0,255] or float [0,1]
    (data/util.py:153-174)."""
    if only_y:
        return _colorspace(img, np.array([65.481, 128.553, 24.966])[:, None],
                           16.0)[..., 0]
    return _colorspace(img, [[65.481, -37.797, 112.0],
                             [128.553, -74.203, -93.786],
                             [24.966, 112.0, -18.214]], [16, 128, 128])


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """BGR variant (data/util.py:177-198)."""
    if only_y:
        return _colorspace(img, np.array([24.966, 128.553, 65.481])[:, None],
                           16.0)[..., 0]
    return _colorspace(img, [[24.966, 112.0, -18.214],
                             [128.553, -74.203, -93.786],
                             [65.481, -37.797, 112.0]], [16, 128, 128])


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """MATLAB ycbcr2rgb (data/util.py:201-218)."""
    in_type = img.dtype
    x = img.astype(np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    mat = np.array([[0.00456621, 0.00456621, 0.00456621],
                    [0, -0.00153632, 0.00791071],
                    [0.00625893, -0.00318811, 0]])
    out = x @ mat * 255.0 + np.array([-222.921, 135.576, -276.836])
    if in_type == np.uint8:
        out = out.round()
    else:
        out = out / 255.0
    return out.astype(in_type)


def channel_convert(in_c: int, tar_type: Optional[str],
                    img_list: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Gray/Y conversion dispatch (data/util.py:139-150). The reference
    operates on BGR cv2 images; our pipeline is RGB, so 'y' uses
    rgb2ycbcr."""
    if in_c == 3 and tar_type == "gray":
        gray = [(0.299 * im[..., 0] + 0.587 * im[..., 1]
                 + 0.114 * im[..., 2]).astype(im.dtype) for im in img_list]
        return [g[..., None] for g in gray]
    if in_c == 3 and tar_type == "y":
        return [rgb2ycbcr(im, only_y=True)[..., None] for im in img_list]
    if in_c == 1 and tar_type == "RGB":
        return [np.repeat(im, 3, axis=2) for im in img_list]
    return list(img_list)


def augment(imgs: List[np.ndarray], hflip: bool = True, rot: bool = True,
            rng: Optional[np.random.Generator] = None) -> List[np.ndarray]:
    """Train-time flip/rot with the reference's draw structure
    (data/util.py:84-103): one hflip draw, one vflip draw, one rot90 draw
    (each p=0.5, vflip/rot90 gated on ``rot``), the same decisions applied
    to every image so LQ/GT stay aligned."""
    rng = rng or np.random.default_rng()
    do_h = hflip and rng.random() < 0.5
    do_v = rot and rng.random() < 0.5
    do_r = rot and rng.random() < 0.5

    def _a(img):
        if do_h:
            img = img[:, ::-1, :]
        if do_v:
            img = img[::-1, :, :]
        if do_r:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    return [_a(im) for im in imgs]
