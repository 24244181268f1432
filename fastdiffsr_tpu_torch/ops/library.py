"""The port's kernels as registered PyTorch operators (namespace ``fdsr``).

``torch.export`` and dispatch modes such as ``FlopCounterMode`` see
registered operators only, not a kernel launched through ``ctypes``, so
each kernel is also an operator:

- ``fdsr::fused_gn_swish_conv3x3`` (K3): its one or two NHWC sources as
  ``Tensor[]``, their (B,2,C) channel sums as ``Tensor[]`` (empty when
  ``apply_norm`` is false), the optional GroupNorm scale and bias, shift
  and residual as ``Tensor?``; it returns ``[y]``, or ``[y, stats_y]``
  when ``want_stats`` is set;
- ``fdsr::channel_stats`` (K2): (B,H,W,C) -> (B,2,C) float32;
- ``fdsr::gn_swish`` (K1's forward; its gradient stays with
  ``ops.groupnorm._GNSwish`` around the public wrapper);
- ``fdsr::quant_conv3`` (Q1: the W8A8 3x3 conv of an NHWC map from the
  packed int8 weights, ``ops.quant.pack_weights``, the (Co,) weight scale,
  the 0-d activation scale and the bias, output in ``dtype``; its gradient
  stays with ``ops.quant._QuantConv3``).

Each operator has a CUDA implementation, the counted kernel launch of
the wrapper (so an exported program's run counts its launches), and a
CPU implementation, the plain version: on a CPU tensor, as the wrappers
do, and on a CUDA tensor the kernel or an error. A fake implementation
gives the output shapes to tracing, and K3 and Q1 have a flop formula,
2*B*H*W*9*C*Co (Q1's are int8 operations), for
``torch.utils.flop_counter``.

The public wrappers call these operators only while
``kernels.traced()`` is true: an eager call launches directly and pays
no dispatcher cost. The operators are defined from their schemas with
``torch.library.define`` / ``impl`` / ``register_fake``: a
``torch.library.custom_op`` of the same function adds Python layers
(an autograd wrapper, an aliasing check of every output) that cost
several times more host time per call (PERF.md), and the exported
sampler makes ~1060 calls per image. A process that loads an exported
program must have imported this module (``import fastdiffsr_tpu_torch.ops``
does), or ``torch.export.load`` cannot resolve ``torch.ops.fdsr.*``.
"""

from __future__ import annotations

from typing import List

import torch
from torch.utils.flop_counter import register_flop_formula

from .fused_conv import _fused_cuda, fused_gn_swish_conv3x3_plain
from .groupnorm import (channel_stats_launch, channel_stats_plain,
                        gn_swish_launch, gn_swish_plain)
from .quant import quant_conv3_apply_plain, quant_conv3_launch

def _stats_arg(stats_in: List[torch.Tensor]):
    """The wrappers' ``stats_in``: None, one tensor or a tuple."""
    if not stats_in:
        return None
    return stats_in[0] if len(stats_in) == 1 else tuple(stats_in)


def _maps(x: List[torch.Tensor]):
    return x[0] if len(x) == 1 else tuple(x)


K3 = "fdsr::fused_gn_swish_conv3x3"
K2 = "fdsr::channel_stats"
K1 = "fdsr::gn_swish"
Q1 = "fdsr::quant_conv3"

K3_SCHEMA = ("(Tensor[] x, Tensor? gn_scale, Tensor? gn_bias, "
             "Tensor[] stats_in, Tensor w, Tensor b, Tensor? shift, "
             "Tensor? res, int groups, float eps, bool apply_norm, "
             "bool want_stats) -> Tensor[]")

torch.library.define(K3, K3_SCHEMA)
torch.library.define(K2, "(Tensor x) -> Tensor")
torch.library.define(K1, "(Tensor x, Tensor scale, Tensor bias, int groups, "
                         "float eps) -> Tensor")
torch.library.define(Q1, "(Tensor h, Tensor packed, Tensor s_w, Tensor s_a, "
                         "Tensor bias, ScalarType dtype) -> Tensor")


def _k3_cpu(x, gn_scale, gn_bias, stats_in, w, b, shift, res, groups, eps,
            apply_norm, want_stats):
    """K3 (``ops.fused_conv.fused_gn_swish_conv3x3``) on the CPU: its
    plain version."""
    out = fused_gn_swish_conv3x3_plain(
        _maps(x), gn_scale, gn_bias, _stats_arg(stats_in), w, b,
        shift=shift, res=res, groups=groups, eps=eps,
        apply_norm=apply_norm, want_stats=want_stats)
    return list(out) if want_stats else [out]


def _k3_cuda(x, gn_scale, gn_bias, stats_in, w, b, shift, res, groups, eps,
             apply_norm, want_stats):
    out = _fused_cuda(tuple(x), gn_scale, gn_bias, _stats_arg(stats_in), w,
                      b, shift, res, groups, eps, apply_norm, want_stats)
    return list(out) if want_stats else [out]


@torch.library.register_fake(K3)
def _k3_fake(x, gn_scale, gn_bias, stats_in, w, b, shift, res, groups, eps,
             apply_norm, want_stats):
    B, H, W = x[0].shape[:3]
    Co = w.shape[-1]
    y = x[0].new_empty((B, H, W, Co))
    if not want_stats:
        return [y]
    return [y, x[0].new_empty((B, 2, Co), dtype=torch.float32)]


@register_flop_formula(torch.ops.fdsr.fused_gn_swish_conv3x3)
def _k3_flops(x_shape, gn_scale_shape, gn_bias_shape, stats_shape, w_shape,
              *args, **kwargs) -> int:
    """The 3x3 convolution's multiply-adds, twice: 2*B*H*W*9*C*Co."""
    B, H, W = x_shape[0][:3]
    kh, kw, C, Co = w_shape
    return 2 * B * H * W * kh * kw * C * Co


def _k2_cpu(x):
    """K2 (``ops.groupnorm.channel_stats``) on the CPU: its plain
    version."""
    return channel_stats_plain(x)


def _k2_cuda(x):
    return channel_stats_launch(x)


@torch.library.register_fake(K2)
def _k2_fake(x):
    return x.new_empty((x.shape[0], 2, x.shape[-1]), dtype=torch.float32)


def _k1_cpu(x, scale, bias, groups, eps):
    """K1's forward (``ops.groupnorm.gn_swish``) on the CPU: its plain
    version."""
    return gn_swish_plain(x, scale, bias, groups, eps)


def _k1_cuda(x, scale, bias, groups, eps):
    return gn_swish_launch(x, scale, bias, groups, eps)


@torch.library.register_fake(K1)
def _k1_fake(x, scale, bias, groups, eps):
    return torch.empty_like(x)


def _q1_cpu(h, packed, s_w, s_a, bias, dtype):
    """Q1 (``ops.quant.quant_conv3_apply``) on the CPU: its plain
    version."""
    return quant_conv3_apply_plain(h, packed, s_w, s_a, bias, dtype)


def _q1_cuda(h, packed, s_w, s_a, bias, dtype):
    return quant_conv3_launch(h, packed, s_w, s_a, bias, dtype)


@torch.library.register_fake(Q1)
def _q1_fake(h, packed, s_w, s_a, bias, dtype):
    return h.new_empty((*h.shape[:3], bias.shape[0]), dtype=dtype)


@register_flop_formula(torch.ops.fdsr.quant_conv3)
def _q1_flops(h_shape, packed_shape, s_w_shape, s_a_shape, bias_shape,
              *args, **kwargs) -> int:
    """The int8 3x3 convolution's multiply-adds, twice:
    2*B*H*W*9*Ci*Co."""
    B, H, W, ci = h_shape
    return 2 * B * H * W * 9 * ci * bias_shape[0]


# the implementations by device, registered once defined (impl used as a
# decorator returns None, which would hide them from other modules)
torch.library.impl(K3, "cpu", _k3_cpu)
torch.library.impl(K3, "cuda", _k3_cuda)
torch.library.impl(K2, "cpu", _k2_cpu)
torch.library.impl(K2, "cuda", _k2_cuda)
torch.library.impl(K1, "cpu", _k1_cpu)
torch.library.impl(K1, "cuda", _k1_cuda)
torch.library.impl(Q1, "cpu", _q1_cpu)
torch.library.impl(Q1, "cuda", _q1_cuda)
