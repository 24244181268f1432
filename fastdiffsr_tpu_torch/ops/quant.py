"""W8A8 3x3 convolution of the wide UNet stages (kernel Q1).

Counterpart of ``fastdiffsr_tpu/ops/quant.py``: symmetric, zero-point-free
int8 with a per-output-channel weight scale and a per-tensor activation
scale,

    s_w[co] = max(max|W[co]| / 127, 1e-12)
    s_a     = max(max|h| / 127, 1e-12)       ('w8a8', dynamic)
            = STATIC_ACT_MAX / 127            ('w8a8s', static)
    q       = clamp(round(v / s), -127, 127)  (int8; round half to even)
    y       = float(conv3x3(q_h, q_w)) * (s_a * s_w) + bias, in ``dtype``

with the int8 x int8 convolution accumulated exactly in int32. Weights
are OIHW (the port's ``nn.Conv2d``), maps NHWC, as at the JAX package's
public function.

- :func:`quant_conv3_plain` is the exact int32 convolution on tensors (in
  float64, exact below 2^53; the accumulators reach 9*512*127^2 ~ 7.4e7,
  past float32's 2^24), :func:`quant_conv3_apply_plain` the whole plain
  forward from the packed weights.
- On a CUDA tensor :func:`quant_conv3_apply` launches Q1
  (``csrc/quant_conv.cu``: each map tile staged and quantized once for all
  output channels, a wgmma s8 implicit GEMM, the dequantizing epilogue;
  one launch, counted as ``quant_conv3``) or raises; the plain version
  runs only for tensors on the CPU. A traced call goes through the
  registered operator ``fdsr::quant_conv3`` (``ops/library.py``).
- The weights are quantized and packed (:func:`pack_weights`: the
  kernel's K-major layout, per block of :func:`co_tile` output channels
  and chunk of ``K_STEP`` input channels) once per parameter update:
  :func:`quant_conv3` takes a ``cache`` dict that keeps them while the
  weight tensor's storage and version are unchanged (a sampler's T evals
  pack once; a train step's optimizer update repacks).
- Gradients are what ``jax.grad`` sees: none through the int8 path;
  ``bias`` gets its own, and ``h`` and ``W`` get theirs through ``s_a *
  s_w`` at their max-abs elements (split evenly among ties, as JAX's max
  and PyTorch's amax do). The kernel's int32 accumulators are kept for
  the backward only when ``s_a`` or ``s_w`` needs a gradient.
- Under :func:`shared_activation_scale` the dynamic ``s_a`` is the
  maximum over the ranks of a process group, as JAX's one program over a
  mesh takes it over the global batch (``-dist``): one all-reduce (MAX)
  per conv in the forward, and in the backward an all-reduce (SUM) of the
  scale's gradient that goes to the rank(s) holding the maximum.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels

STATIC_ACT_MAX = 8.0
QMAX = 127
MODES = ("", "w8a8", "w8a8s")
K_STEP = 32         # Q1's input channels per chunk (one k32): Ci is padded


def default_quant() -> str:
    """Quantized-conv mode from the environment.

    FASTDIFFSR_TPU_QUANT: '' (float convs, the default), 'w8a8' (dynamic
    int8 convs on the wide UNet stages), or 'w8a8s' (static activation
    scale, no per-conv reduce).
    """
    mode = os.environ.get("FASTDIFFSR_TPU_QUANT", "")
    if mode not in MODES:
        raise ValueError(
            f"FASTDIFFSR_TPU_QUANT={mode!r} (want '', 'w8a8' or 'w8a8s')")
    return mode


def co_tile(co: int) -> int:
    """Q1's output channels per block for ``co`` channels: all of them up
    to 256 (the twin of ``co_tile`` in ``csrc/quant_conv.cu``)."""
    return 8 if co <= 8 else 64 if co <= 64 else 128 if co <= 128 else 256


def tile_shape(co: int) -> tuple:
    """(rows, columns) of Q1's output tile for ``co`` channels: a block's
    four (8x8 patch, 64 channels) units make four patches up to 64
    channels, two at 128, one at 256 (the twin of ``tile_rows`` and
    ``tile_cols`` in ``csrc/quant_conv.cu``)."""
    bn = co_tile(co)
    return (16 if bn <= 64 else 8), (16 if bn <= 128 else 8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


_SCALARS: dict = {}


def _scalar(value: float, device) -> torch.Tensor:
    """A 0-d float32 constant on ``device``, made once per device (making
    one on a GPU copies from the host and waits). Dividing by it is an IEEE
    division on every device: PyTorch divides a CUDA tensor by a Python
    number as a product with its reciprocal."""
    device = torch.device(device)
    if kernels.traced():
        return torch.full((), value, dtype=torch.float32, device=device)
    key = (value, device)
    t = _SCALARS.get(key)
    if t is None:
        t = _SCALARS[key] = torch.full((), value, dtype=torch.float32,
                                       device=device)
    return t


def weight_scale(weight: torch.Tensor) -> torch.Tensor:
    """(Co,) float32 per-output-channel scale of an OIHW weight."""
    return torch.clamp_min(weight.float().abs().amax(dim=(1, 2, 3))
                           / _scalar(QMAX, weight.device), 1e-12)


def quantize_weights(weight: torch.Tensor):
    """OIHW float weight -> (int8 OIHW weight, (Co,) float32 scale)."""
    s_w = weight_scale(weight)
    q = torch.clamp(torch.round(weight.detach().float()
                                / s_w.detach()[:, None, None, None]),
                    -QMAX, QMAX).to(torch.int8)
    return q, s_w


def packed_shape(co: int, ci: int) -> tuple:
    """Shape of :func:`pack_weights`' output for a (co, ci, 3, 3) weight:
    (output-channel blocks, input-channel chunks, 9 taps, 2 k-halves,
    co_tile(co) channels, 16 input channels)."""
    bn = co_tile(co)
    return (_round_up(co, bn) // bn, _round_up(ci, K_STEP) // K_STEP, 9, 2,
            bn, K_STEP // 2)


def pack_weights(q_w: torch.Tensor) -> torch.Tensor:
    """int8 OIHW (Co, Ci, 3, 3) -> Q1's :func:`packed_shape` int8,
    zero-padded: the weights one block of output channels reads for one
    chunk of input channels are contiguous, per tap as the K-major B
    operand of its wgmma (two core-matrix columns of 16 input channels,
    each a row of 16 bytes per output channel)."""
    co, ci = q_w.shape[:2]
    g, nk, _, _, bn, _ = packed_shape(co, ci)
    packed = F.pad(q_w.permute(2, 3, 0, 1).reshape(9, co, ci),
                   (0, nk * K_STEP - ci, 0, g * bn - co))
    return (packed.reshape(9, g, bn, nk, 2, K_STEP // 2)
            .permute(1, 3, 0, 4, 2, 5).contiguous())


def unpack_weights(packed: torch.Tensor, co: int, ci: int) -> torch.Tensor:
    """The int8 OIHW weight of :func:`pack_weights`."""
    g, nk, _, _, bn, _ = packed.shape
    w = packed.permute(2, 0, 4, 1, 3, 5).reshape(9, g * bn, nk * K_STEP)
    return w[:, :co, :ci].reshape(3, 3, co, ci).permute(2, 3, 0, 1)


def quantize_activations(h: torch.Tensor, s_a: torch.Tensor) -> torch.Tensor:
    """clamp(round(h / s_a), -127, 127) as int8 (h in float32)."""
    return torch.clamp(torch.round(h.float() / s_a), -QMAX,
                       QMAX).to(torch.int8)


def quant_conv3_plain(q_h: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """The exact int32 3x3 SAME convolution of an int8 NHWC map and an
    int8 OIHW weight (in float64: every partial sum is an integer below
    2^53)."""
    y = F.conv2d(q_h.permute(0, 3, 1, 2).double(), q_w.double(), padding=1)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def dequantize(acc: torch.Tensor, s_a: torch.Tensor, s_w: torch.Tensor,
               bias: torch.Tensor, dtype) -> torch.Tensor:
    """JAX's epilogue: (float(acc) * (s_a * s_w) + bias).astype(dtype),
    each operation rounded on its own."""
    scale = s_a * s_w
    return (acc.float() * scale + bias.float()).to(dtype)


def quant_conv3_apply_plain(h, packed, s_w, s_a, bias, dtype,
                            want_acc: bool = False):
    """Plain PyTorch version of Q1 from the packed weights: y, or (y, int32
    accumulators) with ``want_acc``."""
    co, ci = bias.shape[0], h.shape[-1]
    acc = quant_conv3_plain(quantize_activations(h, s_a),
                            unpack_weights(packed, co, ci))
    y = dequantize(acc, s_a, s_w, bias, dtype)
    return (y, acc) if want_acc else y


def _check(h, packed, s_w, s_a, bias, dtype):
    if h.device.type != "cuda":
        raise ValueError(f"quant_conv3: unsupported device {h.device}")
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_conv3: map dtype {h.dtype} (want float32 or "
                        "bfloat16)")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_conv3: output dtype {dtype} (want float32 "
                        "or bfloat16)")
    if h.dim() != 4 or not h.is_contiguous() or h.data_ptr() % 16:
        raise ValueError("quant_conv3: want a contiguous, 16-byte aligned "
                         "NHWC map")
    ci, co = h.shape[-1], bias.shape[0]
    if ci % 4:
        raise ValueError(f"quant_conv3: {ci} input channels (the kernel "
                         "loads four at a time: want a multiple of 4)")
    want = packed_shape(co, ci)
    if (tuple(packed.shape) != want or packed.dtype != torch.int8
            or not packed.is_contiguous() or packed.data_ptr() % 16):
        raise ValueError(f"quant_conv3: packed weights {tuple(packed.shape)} "
                         f"{packed.dtype} (want contiguous, 16-byte aligned "
                         f"int8 {want})")
    for name, t, shape in (("s_w", s_w, (co,)), ("s_a", s_a, ()),
                           ("bias", bias, (co,))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"quant_conv3: {name} must be contiguous "
                             f"float32 {shape}")
    for t in (packed, s_w, s_a, bias):
        if t.device != h.device:
            raise ValueError("quant_conv3: all operands must be on one "
                             "device")


def launch_args(h, packed, s_w, s_a, bias, y, acc) -> tuple:
    """The arguments of ``fdsr_quant_conv3`` for checked operands, the
    output ``y`` (its dtype the output type) and ``acc`` (or None), on the
    current stream of h's device."""
    p = kernels.ptr
    B, H, W, ci = h.shape
    g, nk, _, _, bn, _ = packed.shape
    return (p(h), p(packed), p(s_w), p(s_a), p(bias), p(y), p(acc), B, H, W,
            ci, nk * K_STEP, y.shape[-1], g * bn,
            int(h.dtype == torch.bfloat16), int(y.dtype == torch.bfloat16),
            kernels.stream_of(h.device))


def quant_conv3_launch(h, packed, s_w, s_a, bias, dtype,
                       want_acc: bool = False):
    """Q1 on a CUDA map: one counted launch. Returns y, or (y, int32
    accumulators) with ``want_acc``."""
    _check(h, packed, s_w, s_a, bias, dtype)
    B, H, W, ci = h.shape
    co = bias.shape[0]
    y = torch.empty((B, H, W, co), dtype=dtype, device=h.device)
    acc = (torch.empty((B, H, W, co), dtype=torch.int32, device=h.device)
           if want_acc else None)
    lib = kernels.load()
    with torch.cuda.device(h.device):
        code = lib.fdsr_quant_conv3(*launch_args(h, packed, s_w, s_a, bias,
                                                 y, acc))
    kernels.check(lib, code, "quant_conv3")
    kernels.count_launch("quant_conv3")
    return (y, acc) if want_acc else y


def quant_conv3_apply(h, packed, s_w, s_a, bias, dtype,
                      want_acc: bool = False):
    """Q1: y = dequantize(conv3x3(quantize(h, s_a), packed), ...) of an
    NHWC map (see the module docstring); (y, int32 accumulators) with
    ``want_acc``."""
    if kernels.traced():
        if want_acc:
            raise RuntimeError("quant_conv3: a traced call has no gradient")
        return torch.ops.fdsr.quant_conv3(h, packed, s_w, s_a, bias, dtype)
    if h.device.type == "cpu":
        return quant_conv3_apply_plain(h, packed, s_w, s_a, bias, dtype,
                                       want_acc)
    return quant_conv3_launch(h, packed, s_w, s_a, bias, dtype, want_acc)


class _QuantConv3(torch.autograd.Function):
    """Q1 with JAX's gradient: out = float(acc) * (s_a * s_w) + bias, acc
    a constant of the int8 path."""

    @staticmethod
    def forward(ctx, h, packed, s_w, s_a, bias, dtype):
        keep = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        out = quant_conv3_apply(h, packed, s_w.detach(), s_a.detach(),
                                bias.detach().float().contiguous(), dtype,
                                want_acc=keep)
        if keep:
            out, acc = out
            ctx.save_for_backward(acc, s_w, s_a)
        ctx.keep = keep
        return out

    @staticmethod
    def backward(ctx, g):
        gf = g.float()
        g_bias = gf.sum(dim=(0, 1, 2))
        g_sw = g_sa = None
        if ctx.keep:
            acc, s_w, s_a = ctx.saved_tensors
            g_scale = (gf * acc.float()).sum(dim=(0, 1, 2))
            g_sw = g_scale * s_a
            g_sa = (g_scale * s_w).sum()
        return None, None, g_sw, g_sa, g_bias, None


# the process group whose ranks share the dynamic activation scale
_SCALE_GROUP: list = [None]


@contextlib.contextmanager
def shared_activation_scale(group):
    """Within the block, the dynamic ``s_a`` of every quantized conv is the
    maximum over the ranks of ``group`` (a ``torch.distributed`` process
    group, every rank of which runs the same convs in the same order);
    ``None`` keeps it per process."""
    prev = _SCALE_GROUP[0]
    _SCALE_GROUP[0] = group
    try:
        yield
    finally:
        _SCALE_GROUP[0] = prev


class _GroupMax(torch.autograd.Function):
    """The maximum over the ranks of ``group`` of each rank's max|h| ``m``.
    Its gradient is the sum over the ranks of theirs (every rank's output
    depends on it), split over the elements that hold the global maximum
    on every rank (``ties``: this rank's count of them), as JAX's max
    splits it over the global batch."""

    @staticmethod
    def forward(ctx, m, ties, group):
        import torch.distributed as dist
        top = m.detach().clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        ctx.group = group
        if ties is not None:
            mine = torch.where(m == top, ties, torch.zeros_like(ties))
            total = mine.clone()
            dist.all_reduce(total, group=group)
            ctx.save_for_backward(mine / total)
        return top

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.detach().clone()
        dist.all_reduce(g, group=ctx.group)
        share, = ctx.saved_tensors
        return g * share, None, None


def activation_scale(h: torch.Tensor, static_scale: bool) -> torch.Tensor:
    """0-d float32 ``s_a`` on h's device; the dynamic one is differentiable
    (and shared over the ranks of :func:`shared_activation_scale`)."""
    if static_scale:
        return _scalar(STATIC_ACT_MAX / QMAX, h.device)
    grad = torch.is_grad_enabled() and h.requires_grad
    # max|h| without a float32 copy of a bfloat16 map (the same value)
    m = torch.linalg.vector_norm(h.float() if grad else h, float("inf"))
    m = m.float()
    group = _SCALE_GROUP[0]
    if group is not None:
        ties = ((h.abs() == m).sum().float() if grad else None)
        m = _GroupMax.apply(m, ties, group)
    return torch.clamp_min(m / _scalar(QMAX, h.device), 1e-12)


def quant_conv3(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                dtype, static_scale: bool = False, *,
                cache: Optional[dict] = None) -> torch.Tensor:
    """W8A8 3x3 SAME conv: h (B,H,W,Ci) NHWC float x weight (Co,Ci,3,3)
    -> (B,H,W,Co) in ``dtype``. ``static_scale``: the 'w8a8s' scale.
    ``cache``: a dict owned by the caller that keeps the packed weights
    while ``weight`` is unchanged. A call captured into a CUDA graph
    packs them inside the graph (a chained train step updates the weight
    between replays) and leaves the cache alone."""
    grad_w = torch.is_grad_enabled() and weight.requires_grad
    capturing = weight.is_cuda and torch.cuda.is_current_stream_capturing()
    key = (None if cache is None or kernels.traced() or capturing else
           (weight.data_ptr(), weight._version, weight.device))
    if key is not None and cache.get("key") == key:
        packed, s_w = cache["packed"], cache["s_w"]
    else:
        q_w, s_w = quantize_weights(weight)
        packed = pack_weights(q_w)
        if key is not None:
            cache.update(key=key, packed=packed, s_w=s_w.detach())
    if grad_w:
        s_w = weight_scale(weight)          # the same value, with its graph
    s_a = activation_scale(h, static_scale)
    return _QuantConv3.apply(h.contiguous(), packed, s_w, s_a, bias, dtype)
