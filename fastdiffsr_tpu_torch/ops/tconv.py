"""The Upsample's stride-2 transposed conv on cuDNN's deterministic
algorithms (operator ``fdsr::upsample_tconv``).

The 'tconv' form of ``models.unet_fastdiffsr.apply_upsample2_conv3``, the
builders' default as in JAX, is one stride-2 transposed convolution with
a 4x4 kernel. cuDNN runs it as a backward-data convolution, and for
float32 on the H100 its timed pick sums with atomics: two calls on the
same input differ in their last bits (``chip_smoke.py`` phase 23), so an
exported artifact, a reloaded checkpoint or a second training step could
not be held bit-equal to the first, and a sampler chain could not be
repeated. :func:`upsample_tconv` runs the transposed convolution, and its
gradient, with cuDNN restricted to its deterministic algorithms and
picked by its heuristics rather than by timing, so that the pick is the
same in every process on a card.

It is a registered operator so that ``torch.export`` keeps the choice in
the artifact (an ``aten.convolution`` there would read the cuDNN settings
of the process that loads it). Its gradient is ``aten.convolution_backward``
under the same settings. On the CPU it is ``F.conv_transpose2d``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

OP = "fdsr::upsample_tconv"

torch.library.define(OP, "(Tensor x, Tensor w, Tensor b) -> Tensor")


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN on its deterministic algorithms, picked by its heuristics,
    within the block. PyTorch keys a convolution's plan by shape and
    ``deterministic``, so the plans met here are never the timed ones of
    the same shapes elsewhere."""
    cudnn = torch.backends.cudnn
    prev = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = prev


def _tconv(x, w, b):
    """The transposed conv: (B, Ci, H, W) and the (Ci, Co, 4, 4) kernel ->
    (B, Co, 2H, 2W), channels-last."""
    with deterministic_cudnn():
        y = F.conv_transpose2d(x, w, b, stride=2, padding=1)
    return y.contiguous(memory_format=torch.channels_last)


@torch.library.register_fake(OP)
def _tconv_fake(x, w, b):
    B, _, H, W = x.shape
    return torch.empty((B, w.shape[1], 2 * H, 2 * W), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last)


def _setup_context(ctx, inputs, output):
    x, w, _ = inputs
    ctx.save_for_backward(x, w)


def _backward(ctx, grad):
    x, w = ctx.saved_tensors
    with deterministic_cudnn():
        return torch.ops.aten.convolution_backward(
            grad.contiguous(memory_format=torch.channels_last), x, w,
            [w.shape[1]], [2, 2], [1, 1], [1, 1], True, [0, 0], 1,
            list(ctx.needs_input_grad))


torch.library.impl(OP, "cpu", _tconv)
torch.library.impl(OP, "cuda", _tconv)
torch.library.register_autograd(OP, _backward, setup_context=_setup_context)


def upsample_tconv(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """``F.conv_transpose2d(x, w, b, stride=2, padding=1)`` on cuDNN's
    deterministic algorithms, channels-last, differentiable."""
    return torch.ops.fdsr.upsample_tconv(x, w, b)
