"""MSI_SR_model data pipeline, [0, 1] NHWC float32: counterpart of
``fastdiffsr_tpu/msi/data.py`` (reference MSI_SR_model/data/dataset.py,
RGB_TrainDatasetFromFolder :586-679 and the test datasets).

Each image gives (LR, HR, Bicubic): HR is the image (centre-cropped to
``crop_size``, cut to a multiple of the scale), LR its bicubic
downscale, Bicubic the LR's bicubic upscale, both as PIL's
``Image.resize(..., BICUBIC)`` computes them on uint8 RGB.
:func:`pil_bicubic_resize` is that computation in numpy, bit for bit
(Pillow's ``Resample.c``): Keys' cubic with a = -0.5 over a support of 2
× the downscale factor, weights normalised in float64 and then rounded
half away from zero to 22-bit fixed point, an accumulator that starts at
``1 << 21``, shifted right by 22 and clamped to 0..255, the horizontal
pass first into uint8, then the vertical one. The card's machine has no
PIL: PNGs are decoded by ``metrics.decode_png``, other formats (the UCM
set is TIFF) through PIL where it imports, and an error naming the format
where it does not.

The class of an image is its parent folder's name. ``MSIDataLoader``
draws one horizontal flip per training batch from
``default_rng(seed + epoch)``, as JAX does.
"""

from __future__ import annotations

import functools
import os
from typing import List, Sequence

import numpy as np

from ..data.dataset import DataLoader, is_image_file
from ..metrics import decode_png

PRECISION_BITS = 32 - 8 - 2


def load_rgb(path: str) -> np.ndarray:
    """uint8 (H,W,3) of an image file: PNGs without an image library,
    other formats through PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        img = decode_png(data)
        if img is not None:
            return img
    try:
        from PIL import Image
    except ImportError:
        fmt = os.path.splitext(path)[1] or "this format"
        raise RuntimeError(
            f"{path}: reading {fmt} images needs PIL, which does not import "
            "here (PNGs are read without it)") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter (a = -0.5) of x."""
    x = np.abs(x)
    a = -0.5
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


@functools.lru_cache(maxsize=32)
def pil_coefficients(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float64 matrix of Pillow's 8-bit fixed-point
    bicubic coefficients for one axis (``precompute_coeffs`` then
    ``normalize_coeffs_8bpc``, box = the whole axis)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    mat = np.zeros((in_size, out_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        x = np.arange(xmin, xmax)
        w = _bicubic((x - center + 0.5) * (1.0 / filterscale))
        total = w.sum()
        if total != 0.0:
            w = w / total
        w = w * (1 << PRECISION_BITS)
        mat[xmin:xmax, xx] = np.trunc(np.where(w < 0, w - 0.5, w + 0.5))
    return mat


def _clip8(acc: np.ndarray) -> np.ndarray:
    out = np.right_shift(acc.astype(np.int64), PRECISION_BITS)
    return np.clip(out, 0, 255).astype(np.uint8)


def pil_bicubic_resize(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """uint8 (H,W,C) -> (out_h, out_w, C), bit-equal to PIL's
    ``Image.resize((out_w, out_h), Image.BICUBIC)``. The fixed-point sums
    are exact in float64 (|sum| < 2^31), so the products run as float64
    matrix products."""
    h, w = img.shape[:2]
    out = img
    half = float(1 << (PRECISION_BITS - 1))
    if out_w != w:
        acc = out.transpose(0, 2, 1).astype(np.float64) @ pil_coefficients(
            w, out_w)
        out = _clip8(acc + half).transpose(0, 2, 1)
    if out_h != h:
        acc = pil_coefficients(h, out_h).T @ out.reshape(h, -1).astype(
            np.float64)
        out = _clip8(acc + half).reshape(out_h, out.shape[1], -1)
    return np.ascontiguousarray(out)


def lr_hr_bicubic(img: np.ndarray, scale: int, crop_size=None, noise=None,
                  noise_rng=None):
    """(lr, hr, bicubic) float32 [0,1] HWC arrays from one uint8 image
    (JAX ``_triple_from_pil``). ``noise=(type, value)`` adds Gaussian
    ('Gaussain', the reference's spelling) or salt-and-pepper ('Poisson',
    ditto) noise to the LR image before the bicubic upscale, as the
    reference test datasets do (data/dataset.py:186-207)."""
    if crop_size:
        h, w = img.shape[:2]
        crop = min(crop_size, w, h)
        crop -= crop % scale
        left, top = (w - crop) // 2, (h - crop) // 2
        img = img[top:top + crop, left:left + crop]
    h, w = img.shape[:2]
    img = img[:h - h % scale, :w - w % scale]
    h, w = img.shape[:2]
    lr = pil_bicubic_resize(img, w // scale, h // scale)
    if noise is not None:
        from .degradation import add_gaussian_noise, add_salt_pepper_noise
        noise_type, noise_value = noise
        if noise_type == "Gaussain":  # reference spelling
            lr = add_gaussian_noise(lr, amplitude=noise_value, rng=noise_rng)
        elif noise_type == "Poisson":  # the reference's salt&pepper
            lr = add_salt_pepper_noise(lr, density=noise_value,
                                       rng=noise_rng)
        else:
            raise ValueError(f"unknown noise type {noise_type!r}")
    bc = pil_bicubic_resize(lr, w, h)

    def to_f(a):
        return a.astype(np.float32) / 255.0
    return to_f(lr), to_f(np.ascontiguousarray(img)), to_f(bc)


def list_images(dirs: Sequence[str]) -> List[str]:
    """Image files of each folder and of its direct subfolders, sorted."""
    files = []
    for d in dirs:
        for name in sorted(os.listdir(d)):
            p = os.path.join(d, name)
            if os.path.isfile(p) and is_image_file(name):
                files.append(p)
            elif os.path.isdir(p):
                files.extend(os.path.join(p, f)
                             for f in sorted(os.listdir(p))
                             if is_image_file(f))
    return files


class RGBSRDataset:
    """{LR, HR, Bicubic, Index, path, class} samples; ``crop_size``
    centre-crops like the reference's pre-tiled training data."""

    def __init__(self, image_dirs: Sequence[str], crop_size, scale_factor: int,
                 split: str = "train", data_len: int = -1, noise=None,
                 seed: int = 0):
        if isinstance(image_dirs, str):
            image_dirs = [image_dirs]
        self.files = list_images(image_dirs)
        if not self.files:
            raise FileNotFoundError(f"no images under {image_dirs}")
        self.crop_size = crop_size
        self.scale = scale_factor
        self.split = split
        self.noise = noise
        self._noise_rng = np.random.default_rng(seed)
        self.data_len = (len(self.files) if data_len <= 0
                         else min(data_len, len(self.files)))

    def __len__(self):
        return self.data_len

    def __getitem__(self, index: int) -> dict:
        path = self.files[index]
        lr, hr, bc = lr_hr_bicubic(load_rgb(path), self.scale,
                                   self.crop_size, noise=self.noise,
                                   noise_rng=self._noise_rng)
        return {"LR": lr, "HR": hr, "Bicubic": bc,
                "Index": np.int32(index), "path": path,
                "class": os.path.basename(os.path.dirname(path))}


class MSIDataLoader(DataLoader):
    """Batches of the shuffled (or ordered) samples, strings (path,
    class) kept as lists; a training batch is flipped left-right with
    probability 1/2, one draw per batch from ``default_rng(seed +
    epoch)``."""

    def __iter__(self):
        idx = self._indices()
        batches = [idx[s:s + self.batch_size]
                   for s in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        self.epoch += 1
        rng = np.random.default_rng(self.seed + self.epoch)
        for chunk in batches:
            samples = [self.dataset[int(i)] for i in chunk]
            if self.dataset.split == "train" and rng.random() < 0.5:
                for s in samples:
                    for k in ("LR", "HR", "Bicubic"):
                        s[k] = np.ascontiguousarray(s[k][:, ::-1, :])
            batch = {}
            for k in samples[0]:
                vals = [s[k] for s in samples]
                batch[k] = (np.stack(vals)
                            if isinstance(vals[0], np.ndarray)
                            or np.isscalar(vals[0]) else vals)
            yield batch
