"""GroupNorm + Swish pieces of the port (NHWC).

Counterpart of ``fastdiffsr_tpu/ops/groupnorm.py``:

- :func:`gn_swish_reference` is the plain GroupNorm -> Swish with float32
  two-pass statistics (``_gn_swish_reference`` there);
- :func:`channel_stats` is K2 (``channel_stats_pallas`` there): per-channel
  (sum, sum of squares) over H,W, (B,H,W,C) -> (B,2,C) float32. On a CUDA
  tensor it launches the kernel in ``csrc/channel_stats.cu`` once, with the
  plan of :func:`channel_stats_plan`, or raises; the plain version runs
  only for tensors on the CPU;
- :func:`gn_swish` is K1 (``_gn_swish_pallas`` there): channel sums (K2's
  kernel), then the channel->group collapse, normalise, affine and swish
  in ``csrc/gn_swish.cu``: two launches. :func:`gn_swish_plain` is the
  same formulation in plain PyTorch, with the collapse as
  :func:`~.fused_conv.group_stats_to_norm`;
- :func:`gn_swish_stats` and :func:`gn_swish_dot` are the JAX package's
  other two forms of the same function: K2's channel sums (the kernel on
  CUDA) or two float32 einsums (a ones-matmul and a Gram diagonal) for the
  statistics, then a broadcast normalise, affine and swish in float32;
- :func:`gn_swish_custom` makes K1 differentiable, as ``gn_swish_custom``
  there: the forward is K1 (``impl="pallas"``) or :func:`gn_swish_stats`
  (``impl="stats"``) and the backward is the VJP of
  :func:`gn_swish_reference`, recomputed from the saved x, scale and bias.
  Every UNet ``Block`` runs it with K1 (the JAX package's
  ``FASTDIFFSR_TPU_FUSED_NORM`` selector is not ported);
  :func:`gn_swish_reference` stands in for it where a test or an on-card
  check needs the UNet without the kernel.

Groups are contiguous channel slices, as in ``torch.nn.GroupNorm``. A
traced call of :func:`channel_stats` or :func:`gn_swish` goes through its
registered operator (``fdsr::channel_stats``, ``fdsr::gn_swish`` in
``ops/library.py``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from . import kernels
from .fused_conv import group_stats_to_norm


def gn_swish_reference(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, groups: int,
                       eps: float = 1e-5) -> torch.Tensor:
    """swish(GroupNorm(x) * scale + bias) of an NHWC map, float32
    statistics, output in x.dtype."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    y = xn * scale.float() + bias.float()
    return (y * torch.sigmoid(y)).to(x.dtype)


def channel_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))],
                       dim=1)


def _check_nhwc(x: torch.Tensor, what: str) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {x.dtype} (want float32 or bfloat16)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: want a contiguous NHWC map")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")


SMS = 132                # the H100 SXM's SMs
# constants of csrc/channel_stats.cu (kThreads, kSlab, kFinalLanes,
# kCounterSlots, kSlotCounters); tests/test_torch_kernels_gpu.py holds them
# to the library's
K2_THREADS = 256
K2_SLAB = 32
K2_FINAL_LANES = 16
K2_COUNTER_SLOTS = 128
K2_SLOT_COUNTERS = 4096
K2_BLOCKS_PER_SM = 2     # the grid K2's plan aims at, over all images
K2_MAX_BLOCKS = 128      # blocks per (image, slab) the last block sums


class ChannelStatsPlan(NamedTuple):
    """How ``csrc/channel_stats.cu`` walks one call."""
    vec: int          # channels per load (16 bytes, or 1: scalar loads)
    slab_units: int   # channel vectors per block (32 channels)
    n_slabs: int      # blocks across the channels of a pixel (grid y)
    lanes: int        # pixel lanes per block
    n_blocks: int     # blocks per (image, slab) (grid x)
    final_lanes: int  # lanes of the last block's ordered sum over blocks


def channel_stats_plan(B: int, HW: int, C: int, itemsize: int,
                       aligned: bool = True) -> ChannelStatsPlan:
    """K2's launch plan for a (B, HW, C) map of ``itemsize``-byte elements
    (``aligned``: its data is 16-byte aligned), from the shape alone.

    16-byte loads where C is a multiple of their channels, else scalar ones;
    32 channels per block, the block's other threads pixel lanes. Each
    (image, slab) gets enough blocks that the grid holds about
    K2_BLOCKS_PER_SM blocks per SM, but at most K2_MAX_BLOCKS (unless that
    leaves fewer blocks than SMs) and no more than give every lane one
    pixel; block k of n takes pixels [k*HW // n, (k+1)*HW // n)."""
    wide = 16 // itemsize
    vec = wide if C % wide == 0 and aligned else 1
    slab_units = K2_SLAB // vec
    n_slabs = -(-C // K2_SLAB)
    lanes = K2_THREADS // slab_units
    per = B * n_slabs
    want = max(-(-SMS // per),
               min(-(-K2_BLOCKS_PER_SM * SMS // per), K2_MAX_BLOCKS))
    n_blocks = min(want, -(-HW // lanes))
    return ChannelStatsPlan(vec, slab_units, n_slabs, lanes, n_blocks,
                            K2_FINAL_LANES)


_SLOTS: dict = {}
_SLOTS_LOCK = threading.Lock()


def _counter_slot(device: torch.device) -> int:
    """The counter slot of the current stream on ``device``: one per
    (device, stream), never shared, so K2 calls that may run at once never
    share a counter. A CUDA graph keeps the slot of the stream it was
    captured on: graphs captured on one stream are replayed one at a
    time."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    with _SLOTS_LOCK:
        slot = _SLOTS.get(key)
        if slot is None:
            slot = sum(1 for k in _SLOTS if k[0] == device.index)
            if slot >= K2_COUNTER_SLOTS:
                raise RuntimeError(
                    f"channel_stats: more than {K2_COUNTER_SLOTS} streams "
                    f"on {device}")
            _SLOTS[key] = slot
    return slot


def _channel_stats_cuda(x: torch.Tensor) -> torch.Tensor:
    """K2's kernel on a checked CUDA map, one launch (no launch count)."""
    B, H, W, C = x.shape
    if x.numel() == 0:
        raise ValueError("channel_stats: empty map")
    plan = channel_stats_plan(B, H * W, C, x.element_size(),
                              x.data_ptr() % 16 == 0)
    if B * plan.n_slabs > K2_SLOT_COUNTERS:
        raise ValueError(f"channel_stats: {B} images x {plan.n_slabs} "
                         f"channel slabs exceed the kernel's "
                         f"{K2_SLOT_COUNTERS} counters")
    lib = kernels.load()
    partial = torch.empty((B, plan.n_slabs, plan.n_blocks, 2, K2_SLAB),
                          dtype=torch.float32, device=x.device)
    stats = torch.empty((B, 2, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.fdsr_channel_stats(
            kernels.ptr(x), kernels.ptr(partial), kernels.ptr(stats), B,
            H * W, C, int(x.dtype == torch.bfloat16), plan.vec,
            plan.n_blocks, _counter_slot(x.device),
            kernels.stream_of(x.device))
    kernels.check(lib, code, "channel_stats")
    return stats


def channel_stats(x: torch.Tensor) -> torch.Tensor:
    """Per-channel (sum, sum of squares) over H,W: (B,H,W,C) -> (B,2,C)."""
    if kernels.traced():
        return torch.ops.fdsr.channel_stats(x)
    if x.device.type == "cpu":
        return channel_stats_plain(x)
    return channel_stats_launch(x)


def channel_stats_launch(x: torch.Tensor) -> torch.Tensor:
    """K2 on a CUDA map: one counted launch."""
    _check_nhwc(x, "channel_stats")
    stats = _channel_stats_cuda(x)
    kernels.count_launch("channel_stats")
    return stats


def gn_swish_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K1: float32 channel sums, the
    channel->group collapse of ``group_stats_to_norm``, then normalise,
    affine and swish, one rounded operation at a time as the kernel does.
    (:func:`gn_swish_reference` computes the same function with a
    two-pass variance.)"""
    h, w = x.shape[1:3]
    mean_c, inv_c = group_stats_to_norm(channel_stats_plain(x), h * w,
                                        groups, eps)
    y = (x.float() - mean_c[:, None, None, :]) * inv_c[:, None, None, :]
    y = y * scale.float() + bias.float()
    return (y * torch.sigmoid(y)).to(x.dtype)


def gn_swish(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             groups: int, eps: float = 1e-5) -> torch.Tensor:
    """K1: swish(GroupNorm(x) * scale + bias) of a (B,H,W,C) map, float32
    statistics, output in x.dtype. scale, bias: (C,)."""
    if kernels.traced():
        return torch.ops.fdsr.gn_swish(x, scale, bias, groups, eps)
    if x.device.type == "cpu":
        return gn_swish_plain(x, scale, bias, groups, eps)
    return gn_swish_launch(x, scale, bias, groups, eps)


def gn_swish_launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int, eps: float = 1e-5) -> torch.Tensor:
    """K1 on a CUDA map: two launches (K2's kernel, then the apply pass),
    counted once."""
    _check_nhwc(x, "gn_swish")
    B, H, W, C = x.shape
    if C % groups:
        raise ValueError(f"gn_swish: {C} channels in {groups} groups")
    if C > 3072:
        raise ValueError(f"gn_swish: C={C} exceeds the kernel's 3072")
    scale = scale.detach().float().contiguous()
    bias = bias.detach().float().contiguous()
    if (scale.shape != (C,) or bias.shape != (C,)
            or scale.device != x.device or bias.device != x.device):
        raise ValueError(f"gn_swish: scale and bias must be ({C},) on "
                         f"{x.device}")
    stats = _channel_stats_cuda(x)
    y = torch.empty_like(x)
    lib = kernels.load()
    p = kernels.ptr
    with torch.cuda.device(x.device):
        code = lib.fdsr_gn_swish_apply(
            p(x), p(stats), groups, eps, p(scale), p(bias), p(y), B, H * W,
            C, int(x.dtype == torch.bfloat16), kernels.stream_of(x.device))
    kernels.check(lib, code, "gn_swish")
    kernels.count_launch("gn_swish")
    return y


def gn_swish_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm -> Swish of a (B,H,W,C) map from K2's channel sums and a
    broadcast float32 normalise (JAX ``gn_swish_stats``), output in
    x.dtype."""
    h, w = x.shape[1:3]
    mean_c, inv_c = group_stats_to_norm(channel_stats(x), h * w, groups, eps)
    y = ((x.float() - mean_c[:, None, None, :])
         * (inv_c[:, None, None, :] * scale.float()) + bias.float())
    return (y * torch.sigmoid(y)).to(x.dtype)


@contextlib.contextmanager
def _ieee_matmul():
    """float32 products in full float32 (no TF32) within the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gn_swish_dot(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm -> Swish with contraction statistics (JAX
    ``gn_swish_dot``): sum(x) over H,W as a ones-matmul with 8 columns,
    sum(x^2) as the diagonal of the Gram ``bhwc,bhwd->bcd``, both in
    float32 (JAX's ``preferred_element_type``: the einsums run on
    ``x.float()``, since PyTorch's einsum of bfloat16 returns bfloat16)
    without TF32; then the same normalise, affine and swish."""
    b, h, w, c = x.shape
    xf = x.float()
    with _ieee_matmul():
        ones_k = torch.ones((h, w, 8), dtype=torch.float32, device=x.device)
        s1 = torch.einsum("bhwc,hwk->bkc", xf, ones_k)[:, 0]
        gram = torch.einsum("bhwc,bhwd->bcd", xf, xf)
    s2 = torch.diagonal(gram, dim1=1, dim2=2)
    mean_c, inv_c = group_stats_to_norm(torch.stack([s1, s2], dim=1), h * w,
                                        groups, eps)
    winv_c = inv_c[:, None, None, :] * scale.float()
    y = (xf - mean_c[:, None, None, :]) * winv_c + bias.float()
    return (y * torch.sigmoid(y)).to(x.dtype)


GN_SWISH_IMPLS = ("pallas", "stats")


class _GNSwish(torch.autograd.Function):
    """Forward K1 (or :func:`gn_swish_stats`); backward the VJP of
    :func:`gn_swish_reference`."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, impl):
        ctx.save_for_backward(x, scale, bias)
        ctx.groups, ctx.eps = groups, eps
        fwd = gn_swish_stats if impl == "stats" else gn_swish
        return fwd(x, scale, bias, groups, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
            y = gn_swish_reference(*leaves, ctx.groups, ctx.eps)
            grads = torch.autograd.grad(y, leaves, g)
        return (*grads, None, None, None)


def gn_swish_custom(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int, eps: float = 1e-5,
                    impl: str = "pallas") -> torch.Tensor:
    """Differentiable K1 (``impl="pallas"``) or :func:`gn_swish_stats`
    (``impl="stats"``); see the module docstring."""
    if impl not in GN_SWISH_IMPLS:
        raise ValueError(f"gn_swish_custom: impl={impl!r} (want 'pallas' or "
                         "'stats')")
    return _GNSwish.apply(x, scale, bias, groups, eps, impl)

