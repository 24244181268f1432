"""A plain PyTorch model of K2's summation order (``csrc/channel_stats.cu``)
under a launch plan of ``ops/groupnorm.py::channel_stats_plan``. Imports
neither JAX nor the JAX package: ``tests/test_torch_k2_plan.py`` holds it
against the plain version and JAX on the CPU, and
``tests/test_torch_kernels_gpu.py`` holds the kernel to it bit for bit on
the card.
"""

import torch


def cdiv(n, d):
    return -(-n // d)


def k2_model(x, plan):
    """K2 computed the way csrc/channel_stats.cu sums under ``plan``, in
    float32: each thread adds its pixels in order (x, then x * x rounded
    before it is added), the block adds its lanes in order, and the last
    block's lane l adds blocks l, l + final_lanes, ... before the lanes are
    added in order. (B, H, W, C) -> (B, 2, C)."""
    B, H, W, C = x.shape
    HW = H * W
    xf = x.float().reshape(B, HW, C)
    nb, lanes, nl = plan.n_blocks, plan.lanes, plan.final_lanes
    p0 = torch.tensor([k * HW // nb for k in range(nb + 1)])
    n_iter = max(cdiv(int(p0[k + 1] - p0[k]), lanes) for k in range(nb))
    pix = (p0[:-1, None, None] + torch.arange(lanes)[None, None, :]
           + torch.arange(n_iter)[None, :, None] * lanes)
    valid = pix < p0[1:, None, None]             # (nb, n_iter, lanes)
    v = xf[:, pix.clamp(max=HW - 1)]             # (B, nb, n_iter, lanes, C)
    s1 = torch.zeros((B, nb, lanes, C))
    s2 = torch.zeros((B, nb, lanes, C))
    for i in range(n_iter):
        m = valid[None, :, i, :, None]
        vi = v[:, :, i]
        s1 = torch.where(m, s1 + vi, s1)
        s2 = torch.where(m, s2 + vi * vi, s2)
    part = torch.zeros((B, nb, 2, C))
    for lane in range(lanes):
        part[:, :, 0] += s1[:, :, lane]
        part[:, :, 1] += s2[:, :, lane]
    out = torch.zeros((B, 2, C))
    for lane in range(nl):
        acc = torch.zeros((B, 2, C))
        for k in range(lane, nb, nl):
            acc = acc + part[:, k]
        out = out + acc
    return out
