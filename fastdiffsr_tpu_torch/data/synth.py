"""A synthetic LR->HR pair set made from a seed, as uint8 npy packs.

The port's counterpart of the ``-debug`` data of
``fastdiffsr_tpu/cli/sr_mfe.py::ensure_debug_data``: smooth random HR
tiles (16x16 uniform noise blown up bicubically, so the SR task is not
pure white noise) and their bicubic down-and-up images, written as the
``datatype: npy`` layout that ``data/dataset.py`` reads
(``{root}/hr_{r}.npy``, ``{root}/sr_{l}_{r}.npy``). It needs neither an
image library nor ``data/prepare.py``.
"""

from __future__ import annotations

import os

import numpy as np


def write_pack(droot: str, n: int, seed: int, l_res: int = 64,
               r_res: int = 256) -> str:
    """Write ``n`` pairs at l_res -> r_res under ``droot``; returns it."""
    # imported here: the data package imports without torch, so the
    # process pool of data/prepare.py starts its workers quickly
    import torch
    import torch.nn.functional as F
    os.makedirs(droot, exist_ok=True)
    g = torch.Generator().manual_seed(int(seed))
    small = torch.rand((n, 3, 16, 16), generator=g)
    hr = F.interpolate(small, size=r_res, mode="bicubic", align_corners=False)
    lr = F.interpolate(hr, size=l_res, mode="bicubic", antialias=True,
                       align_corners=False)
    sr = F.interpolate(lr, size=r_res, mode="bicubic", align_corners=False)

    def u8(t):
        return (t.clamp(0, 1) * 255).round().to(torch.uint8).permute(
            0, 2, 3, 1).numpy()

    np.save(os.path.join(droot, f"hr_{r_res}.npy"), u8(hr))
    np.save(os.path.join(droot, f"sr_{l_res}_{r_res}.npy"), u8(sr))
    return droot
