"""Offline FID scorer: counterpart of ``fastdiffsr_tpu/cli/fid.py`` (the
reference's FID.py:5-21, which shells out to pytorch_fid).

    python -m fastdiffsr_tpu_torch.cli.fid <fake_dir> <real_dir> \\
        [--device cuda|cpu]

The InceptionV3 pool3 features come from ``models/inception.py`` on the
device (CUDA unless ``--device cpu``), its weights from the
``FASTDIFFSR_TPU_INCEPTION`` pack; the Frechet distance between the two
Gaussians is taken in float64 on the host with scipy's ``sqrtm``, as the
JAX package does.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """FID = |mu1-mu2|^2 + Tr(S1 + S2 - 2 (S1 S2)^{1/2})."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def activation_statistics(feats: np.ndarray):
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def directory_features(d: str, extractor, batch_size: int = 8
                       ) -> np.ndarray:
    """Stack the extractor's features over every file of a directory, in
    name order, ``batch_size`` images per call. A batch of mixed sizes is
    first resized to 299 image by image with the extractor's own resize."""
    import torch

    from ..metrics import load_img
    from ..models.inception import resize_299

    fs = sorted(p for p in glob.glob(os.path.join(d, "*"))
                if os.path.isfile(p))
    if not fs:
        raise SystemExit(f"no images under {d}")
    out = []
    for start in range(0, len(fs), batch_size):
        imgs = [load_img(f).astype(np.float32) / 255.0
                for f in fs[start:start + batch_size]]
        if len({im.shape for im in imgs}) != 1:
            imgs = [resize_299(torch.from_numpy(im)[None])[0].numpy()
                    for im in imgs]
        out.append(extractor(np.stack(imgs)))
    return np.concatenate(out)


def calc_fid(dir_fake: str, dir_real: str, device="cpu") -> float:
    from ..models.inception import load_default
    try:
        extractor = load_default(device=device)
    except FileNotFoundError as e:
        raise SystemExit(
            f"FID feature extractor unavailable in this environment: {e}")
    mu1, s1 = activation_statistics(directory_features(dir_fake, extractor))
    mu2, s2 = activation_statistics(directory_features(dir_real, extractor))
    return frechet_distance(mu1, s1, mu2, s2)


def main(argv=None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("fake_dir")
    p.add_argument("real_dir")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..device import resolve_device, use_ieee_float32

    device = resolve_device(args.device)
    use_ieee_float32()
    fid = calc_fid(args.fake_dir, args.real_dir, device=device)
    print("FID:", fid)
    return fid


if __name__ == "__main__":
    main()
