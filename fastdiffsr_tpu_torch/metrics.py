"""Image metrics (MSE / PSNR / SSIM / ERGAS / LPIPS), image IO and the
validation panel.

Counterpart of ``fastdiffsr_tpu/metrics.py`` (reference core/metrics.py)
without OpenCV: ``save_img`` writes PNG with a small encoder on the
standard library's ``zlib`` (``load_img`` reads it back without an image
library), and the MATLAB-style SSIM filters with ``scipy.ndimage`` using
the same 11x11, sigma 1.5 Gaussian window and the same valid-region crop
as the ``cv2.filter2D`` version. ``calculate_lpips`` runs
``lpips_torch.LPIPS`` once built per device, and returns None (with one
warning) when no LPIPS weight pack is found. ``plot_img`` imports
matplotlib when it is called.
"""

from __future__ import annotations

import math
import os
import struct
import warnings
import zlib

import numpy as np


def tensor2img(arr, min_max=(-1, 1)) -> np.ndarray:
    """float array (H,W,C) or (B,H,W,C) in min_max -> uint8 HWC image.
    A batch dim of size >1 is tiled into a grid row."""
    arr = np.asarray(arr, dtype=np.float32)
    arr = (arr - min_max[0]) / (min_max[1] - min_max[0])
    arr = np.clip(arr, 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0] if arr.shape[0] == 1 else np.concatenate(list(arr),
                                                              axis=1)
    return (arr * 255.0).round().astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """8-bit grayscale (H,W) / (H,W,1) or RGB (H,W,3) -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png wants uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png: unsupported shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    # filter type 0 (None) in front of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def decode_png(data: bytes):
    """uint8 (H,W,3) RGB of a PNG that uses only what ``encode_png`` and
    most encoders write: 8-bit grey, RGB or RGBA (alpha dropped), not
    interlaced, scanline filters None / Sub / Up. None for any other
    PNG (``load_img`` hands those to PIL)."""
    pos, chunks = 8, []
    ihdr = None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            chunks.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, color, _, _, interlace = ihdr
    chans = {0: 1, 2: 3, 6: 4}.get(color)
    if depth != 8 or interlace or chans is None:
        return None
    rows = np.frombuffer(zlib.decompress(b"".join(chunks)), np.uint8)
    rows = rows.reshape(h, 1 + w * chans)
    if (rows[:, 0] > 2).any():
        return None
    out = np.empty((h, w * chans), np.uint8)
    prev = np.zeros(w * chans, np.uint8)
    for y in range(h):
        line = rows[y, 1:]
        if rows[y, 0] == 1:        # Sub: running sum per channel
            line = np.cumsum(line.reshape(w, chans), axis=0,
                             dtype=np.uint64).astype(np.uint8).reshape(-1)
        elif rows[y, 0] == 2:      # Up
            line = line + prev
        out[y] = prev = line
    img = out.reshape(h, w, chans)
    if chans == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def load_img(path: str) -> np.ndarray:
    """uint8 (H,W,3) RGB of an image file: PNGs that ``decode_png``
    reads without an image library, anything else through PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        img = decode_png(data)
        if img is not None:
            return img
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def save_img(img: np.ndarray, img_path: str):
    """Write a uint8 RGB (or grayscale) image as PNG."""
    os.makedirs(os.path.dirname(img_path) or ".", exist_ok=True)
    with open(img_path, "wb") as f:
        f.write(encode_png(img))


def calculate_mse(img1: np.ndarray, img2: np.ndarray) -> float:
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    return float(np.mean((img1 - img2) ** 2))


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    mse = calculate_mse(img1, img2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel(size, sigma) outer-producted with itself."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-x ** 2 / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    """MATLAB-style SSIM on one channel (reference core/metrics.py:104-125):
    11x11 Gaussian window sigma 1.5, C1=(0.01*255)^2, C2=(0.03*255)^2,
    valid region only."""
    from scipy.ndimage import correlate

    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _gaussian_window()

    def filt(a):
        return correlate(a, window, mode="reflect")[5:-5, 5:-5]

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = filt(img1 ** 2) - mu1_sq
    sigma2_sq = filt(img2 ** 2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu1_mu2
    ssim_map = (((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) /
                ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)))
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """Multi-channel mean of per-channel MATLAB SSIM
    (reference core/metrics.py:127-145)."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return _ssim_single(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            return float(np.mean([_ssim_single(img1[..., i], img2[..., i])
                                  for i in range(3)]))
        if img1.shape[2] == 1:
            return _ssim_single(img1[..., 0], img2[..., 0])
    raise ValueError("Wrong input image dimensions.")


def ssim_skimage(img1: np.ndarray, img2: np.ndarray) -> float:
    """skimage.measure.compare_ssim(multichannel=True) equivalent: 7x7
    uniform filter, per channel, averaged; the train-loop SSIM of the
    reference (sr_mfe.py:167)."""
    from scipy.ndimage import uniform_filter

    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    if img1.ndim == 2:
        img1, img2 = img1[..., None], img2[..., None]
    win, pad = 7, 3
    C1, C2 = (0.01 * 255.0) ** 2, (0.03 * 255.0) ** 2
    cov_norm = win ** 2 / (win ** 2 - 1)
    vals = []
    for c in range(img1.shape[2]):
        x, y = img1[..., c], img2[..., c]
        ux, uy = uniform_filter(x, win), uniform_filter(y, win)
        uxx = uniform_filter(x * x, win)
        uyy = uniform_filter(y * y, win)
        uxy = uniform_filter(x * y, win)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        S = ((2 * ux * uy + C1) * (2 * vxy + C2)
             / ((ux ** 2 + uy ** 2 + C1) * (vx + vy + C2)))
        vals.append(S[pad:-pad, pad:-pad].mean())
    return float(np.mean(vals))


def calculate_ergas(img_fake: np.ndarray, img_real: np.ndarray,
                    scale: int = 4) -> float:
    """ERGAS = 100/scale * sqrt(mean_c(MSE_c / mean_ref_c^2))
    (reference core/metrics.py:147-152)."""
    img_fake = img_fake.astype(np.float64)
    img_real = img_real.astype(np.float64)
    if img_fake.ndim == 2:
        img_fake, img_real = img_fake[..., None], img_real[..., None]
    nb = img_fake.shape[2]
    means_real = img_real.reshape(-1, nb).mean(axis=0)
    mses = ((img_fake - img_real) ** 2).reshape(-1, nb).mean(axis=0)
    return float(100 / scale * np.sqrt((mses / (means_real ** 2 + 1e-12))
                                       .mean()))


_LPIPS = {}            # device -> LPIPS module, or None without a pack
_LPIPS_WARNED = False


def calculate_lpips(img1_u8: np.ndarray, img2_u8: np.ndarray,
                    device="cpu"):
    """LPIPS-alex distance of two uint8 HWC images on ``device``, or None
    when no LPIPS weight pack is found (one warning per process). The
    module is built once per device (the reference builds one per
    call)."""
    global _LPIPS_WARNED
    key = str(device)
    if key not in _LPIPS:
        from .lpips_torch import LPIPS
        try:
            _LPIPS[key] = LPIPS.load_default(device=device)
        except FileNotFoundError as e:
            if not _LPIPS_WARNED:
                warnings.warn(f"LPIPS unavailable: {e}")
                _LPIPS_WARNED = True
            _LPIPS[key] = None
    if _LPIPS[key] is None:
        return None
    return _LPIPS[key].distance(img1_u8, img2_u8)


def plot_img(path: str, bicubic, sr, hr, psnr, ssim, ergas, lpips,
             psnr2=None, ssim2=None, ergas2=None, lpips2=None):
    """Comparison panel HR | Bicubic | SR, the last two titled with their
    metrics (reference core/metrics.py:51-88). Imports matplotlib, which
    raises ImportError where it is not installed."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def title(name, p, s, e, lp):
        return "{}\nPSNR {:.2f} SSIM {:.4f}\nERGAS {:.3f}{}".format(
            name, p or 0, s or 0, e or 0,
            f" LPIPS {lp:.4f}" if lp is not None else "")

    fig, axes = plt.subplots(1, 3, figsize=(12, 4.5))
    for ax, (img, name) in zip(axes, [
            (hr, "HR"),
            (bicubic, title("Bicubic", psnr2, ssim2, ergas2, lpips2)),
            (sr, title("SR", psnr, ssim, ergas, lpips))]):
        ax.imshow(img)
        ax.set_title(name, fontsize=9)
        ax.axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
