"""SRMD-style degradations and noise injectors of the MSI baselines:
counterpart of ``fastdiffsr_tpu/msi/degradation.py`` (reference
MSI_SR_model/model/util.py:230-463, 958-995, data/dataset.py:15-48).

The blur-kernel maths, the PCA basis and every random draw stay numpy on
the host with explicit ``Generator``s, as in JAX. The image path is
torch on the images' device: :func:`batch_blur` is one grouped
``F.conv2d`` (each image its own kernel, reflect-padded), the bicubic
downscale is ``ediffsr.deg.resize_bicubic`` (the weights of
``jax.image.resize(..., "bicubic", antialias=True)``), and
:func:`gaussian_noising` clamps to [0, 1] as JAX does.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ediffsr.deg import resize_bicubic


# ---------------------------------------------------------------- kernels

def cal_sigma(sig_x: float, sig_y: float, radians: float) -> np.ndarray:
    """2x2 covariance from axis sigmas and a rotation (util.py:237)."""
    d = np.array([[sig_x ** 2, 0.0], [0.0, sig_y ** 2]])
    u = np.array([[np.cos(radians), -np.sin(radians)],
                  [np.sin(radians), np.cos(radians)]])
    return u @ d @ u.T


def isotropic_gaussian_kernel(l: int, sigma: float) -> np.ndarray:
    """(l,l) normalised kernel (util.py:253-258)."""
    ax = np.arange(-l // 2 + 1.0, l // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    k = np.exp(-(xx ** 2 + yy ** 2) / (2.0 * sigma ** 2))
    return k / np.sum(k)


def anisotropic_gaussian_kernel(l: int,
                                sigma_matrix: np.ndarray) -> np.ndarray:
    """(l,l) normalised kernel of a covariance (util.py:244-250)."""
    ax = np.arange(-l // 2 + 1.0, l // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.stack([xx, yy], axis=-1)
    inv = np.linalg.inv(sigma_matrix)
    k = np.exp(-0.5 * np.sum((xy @ inv) * xy, axis=2))
    return k / np.sum(k)


def random_batch_kernel(rng: np.random.Generator, batch: int, l: int = 21,
                        sig_min: float = 0.2, sig_max: float = 4.0,
                        rate_iso: float = 1.0,
                        scaling: float = 3.0) -> np.ndarray:
    """(B,l,l) random kernels: isotropic with probability rate_iso, else
    rotated anisotropic (util.py:260-297), drawn from ``rng``."""
    out = np.zeros((batch, l, l))
    for i in range(batch):
        if rng.random() < rate_iso:
            sig = rng.random() * (sig_max - sig_min) + sig_min
            out[i] = isotropic_gaussian_kernel(l, sig)
        else:
            theta = rng.random() * math.pi * 2 - math.pi
            x = rng.random() * (sig_max - sig_min) + sig_min
            y = np.clip(rng.random() * scaling * x, sig_min, sig_max)
            out[i] = anisotropic_gaussian_kernel(l, cal_sigma(x, y, theta))
    return out.astype(np.float32)


def stable_batch_kernel(batch: int, l: int = 21,
                        sig: float = 2.6) -> np.ndarray:
    """(B,l,l) fixed isotropic kernels (util.py:299-304)."""
    return np.broadcast_to(isotropic_gaussian_kernel(l, sig),
                           (batch, l, l)).astype(np.float32)


# -------------------------------------------------------------------- PCA

def pca_matrix(kernels: np.ndarray, k: int = 2) -> np.ndarray:
    """(l*l, k) PCA basis over flattened kernels (util.py:230-235)."""
    x = kernels.reshape(kernels.shape[0], -1).astype(np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    u, _, _ = np.linalg.svd(x.T, full_matrices=False)
    return u[:, :k].astype(np.float32)


def pca_encode(batch_kernel: torch.Tensor,
               weight: torch.Tensor) -> torch.Tensor:
    """(B,l,l) x (l*l,k) -> (B,k) kernel codes (PCAEncoder, util.py:368)."""
    return batch_kernel.reshape(batch_kernel.shape[0], -1) @ weight


# ------------------------------------------------------------------- blur

def batch_blur(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Per-image depthwise blur with reflect padding (BatchBlur,
    util.py:383-406): x (B,H,W,C), kernels (B,l,l) -> (B,H,W,C)."""
    b, h, w, c = x.shape
    l = kernels.shape[-1]
    lo, hi = l // 2, (l // 2 if l % 2 == 1 else l // 2 - 1)
    xp = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi), mode="reflect")
    weight = kernels.to(x.dtype)[:, None].repeat_interleave(c, dim=0)
    out = F.conv2d(xp.reshape(1, b * c, h + lo + hi, w + lo + hi), weight,
                   groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


# ------------------------------------------------------------------ noise

def random_batch_noise(rng: np.random.Generator, batch: int, high: float,
                       rate_cln: float = 1.0) -> np.ndarray:
    """(B,1) noise sigmas: uniform·high, zeroed with probability rate_cln
    (util.py:334-339)."""
    level = rng.uniform(size=(batch, 1)) * high
    mask = (rng.uniform(size=(batch, 1)) >= rate_cln).astype(np.float64)
    return (level * mask).astype(np.float32)


def gaussian_noising(x: torch.Tensor, sigma: torch.Tensor,
                     noise: torch.Tensor,
                     clip: Tuple[float, float] = (0.0, 1.0)) -> torch.Tensor:
    """x + sigma·noise, clamped (b_GaussianNoising, util.py:342-348);
    sigma (B,1) over NHWC, noise standard normal of x's shape."""
    s = sigma.reshape(sigma.shape[0], 1, 1, 1)
    return torch.clamp(x + s * noise, clip[0], clip[1])


# --------------------------------------------------------- SRMD pipeline

class SRMDPreprocessing:
    """Blur -> bicubic downscale -> noise -> (lr, degradation code)
    (util.py:408-463). The host draws each batch's kernels and noise
    levels from ``default_rng(seed)``; :meth:`apply` is the image path on
    the images' device. The code is ``[PCA(kernel), 10·noise_level]``
    (the bare PCA code without noise)."""

    def __init__(self, scale: int, random: bool,
                 pca_weight: Optional[np.ndarray] = None, kernel: int = 21,
                 noise: bool = True, sig: float = 2.6, sig_min: float = 0.2,
                 sig_max: float = 4.0, rate_iso: float = 1.0,
                 scaling: float = 3.0, rate_cln: float = 0.2,
                 noise_high: float = 0.08, pca_dim: int = 15,
                 seed: int = 0):
        self.scale = int(scale)
        self.random = bool(random)
        self.l = int(kernel)
        self.noise = bool(noise)
        self.sig, self.sig_min, self.sig_max = sig, sig_min, sig_max
        self.rate_iso, self.scaling = rate_iso, scaling
        self.rate_cln, self.noise_high = rate_cln, noise_high
        self._rng = np.random.default_rng(seed)
        if pca_weight is None:
            # a basis over a sample of random kernels (the reference loads
            # a precomputed pca_matrix.pth; none ships)
            sample = random_batch_kernel(
                np.random.default_rng(seed + 1), 1024, l=self.l,
                sig_min=sig_min, sig_max=sig_max, rate_iso=rate_iso,
                scaling=scaling)
            pca_weight = pca_matrix(sample, k=pca_dim)
        self.pca_weight = torch.from_numpy(np.asarray(pca_weight,
                                                      np.float32))

    def draw(self, batch: int):
        """Host randomness of one batch: (kernels, noise levels)."""
        if self.random:
            kernels = random_batch_kernel(
                self._rng, batch, l=self.l, sig_min=self.sig_min,
                sig_max=self.sig_max, rate_iso=self.rate_iso,
                scaling=self.scaling)
        else:
            kernels = stable_batch_kernel(batch, l=self.l, sig=self.sig)
        if self.noise:
            level = random_batch_noise(self._rng, batch, self.noise_high,
                                       self.rate_cln)
        else:
            level = np.zeros((batch, 1), np.float32)
        return kernels, level

    def apply(self, hr: torch.Tensor, kernels: torch.Tensor,
              noise_level: torch.Tensor, noise_eps: torch.Tensor):
        """(lr, code) of an (B,H,W,C) batch in [0, 1] for given kernels,
        levels and standard-normal LR noise (JAX ``_device``). Without
        noise the LR is neither noised nor clamped (util.py:437-441)."""
        b, h, w, _ = hr.shape
        lr = resize_bicubic(batch_blur(hr, kernels), h // self.scale,
                            w // self.scale)
        code = pca_encode(kernels, self.pca_weight.to(hr.device))
        if self.noise:
            lr = gaussian_noising(lr, noise_level, noise_eps)
            code = torch.cat([code, noise_level * 10.0], dim=1)
        return lr, code

    def __call__(self, hr: torch.Tensor, generator=None,
                 return_kernel: bool = False):
        """hr (B,H,W,C) in [0, 1] -> (lr, code[, kernels]). The LR noise
        comes from ``generator``, else from a generator seeded by this
        object's host stream (one integer per call, as JAX seeds its
        key)."""
        b, h, w, c = hr.shape
        kernels, level = self.draw(b)
        if generator is None:
            generator = torch.Generator(device=hr.device).manual_seed(
                int(self._rng.integers(2 ** 31)))
        eps = torch.randn((b, h // self.scale, w // self.scale, c),
                          generator=generator, device=hr.device,
                          dtype=hr.dtype)
        lr, code = self.apply(hr, torch.from_numpy(kernels).to(hr.device),
                              torch.from_numpy(level).to(hr.device), eps)
        return (lr, code, kernels) if return_kernel else (lr, code)


def create_downsampling_dataset(datapath: str, dstpath: str, scale: int,
                                seed: int = 0, kernel: int = 21,
                                sig_min: float = 0.2,
                                sig_max: float = 4.0) -> int:
    """Offline blur-degraded LR set (util.py:958-995): every image under
    ``datapath`` (class subfolders kept) random-Gaussian-blurred and
    bicubic-downscaled to ``<name>_downsample.png``. Returns the count."""
    from ..data.dataset import get_paths_from_images
    from ..metrics import save_img
    from .data import load_rgb

    pre = SRMDPreprocessing(scale=scale, random=True, kernel=kernel,
                            noise=False, sig_min=sig_min, sig_max=sig_max,
                            seed=seed)
    n = 0
    for path in get_paths_from_images(datapath):
        rel = os.path.relpath(os.path.dirname(path), datapath)
        out_dir = os.path.join(dstpath, rel) if rel != "." else dstpath
        arr = load_rgb(path).astype(np.float32) / 255.0
        h, w = arr.shape[:2]
        arr = arr[:h - h % scale, :w - w % scale]
        lr, _ = pre(torch.from_numpy(np.ascontiguousarray(arr[None])))
        lr8 = np.clip(lr[0].numpy() * 255.0, 0, 255).round().astype(np.uint8)
        base = os.path.splitext(os.path.basename(path))[0]
        save_img(lr8, os.path.join(out_dir, base + "_downsample.png"))
        n += 1
    return n


# ------------------------------------------------- dataset noise injectors

def add_salt_pepper_noise(img_u8: np.ndarray, density: float,
                          rng: Optional[np.random.Generator] = None
                          ) -> np.ndarray:
    """Pepper 0 / salt 255 at total ``density``, one mask for every
    channel (AddSaltPepperNoise, data/dataset.py:15-31)."""
    rng = rng or np.random.default_rng()
    h, w, c = img_u8.shape
    mask = rng.choice(np.array([0, 1, 2]), size=(h, w, 1),
                      p=[density / 2.0, density / 2.0, 1 - density])
    mask = np.repeat(mask, c, axis=2)
    out = img_u8.copy()
    out[mask == 0] = 0
    out[mask == 1] = 255
    return out


def add_gaussian_noise(img_u8: np.ndarray, mean: float = 0.0,
                       variance: float = 1.0, amplitude: float = 1.0,
                       rng: Optional[np.random.Generator] = None
                       ) -> np.ndarray:
    """Additive channel-shared Gaussian noise, clipped on the high side
    only, then cast to uint8 as the reference does (AddGaussianNoise,
    data/dataset.py:33-48)."""
    rng = rng or np.random.default_rng()
    h, w, c = img_u8.shape
    n = amplitude * rng.normal(loc=mean, scale=variance, size=(h, w, 1))
    n = np.repeat(n, c, axis=2)
    out = n + img_u8.astype(np.float64)
    out[out > 255] = 255
    return out.astype(np.uint8)
