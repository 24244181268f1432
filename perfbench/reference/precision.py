"""The arithmetic type of the reference's convolutions and matmuls.

``"f32"`` is full float32: the reference's own precision, with TF32 off.
The other two are the controls, the nearest precision below a
configuration's: ``"tf32"`` rounds both operands of every convolution and
matmul to TF32 (10 mantissa bits, round to nearest even), as the tensor
cores read float32 in TF32 mode; ``"fp8"`` rounds them to float8 e4m3
after scaling each tensor so that its largest magnitude is e4m3's
largest, the step below bfloat16. Products and sums stay in float32, so
the rounding is the same on the CPU and on the card.
"""

from __future__ import annotations

import torch

PRECISIONS = ("f32", "tf32", "fp8")
_E4M3_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) with its mantissa rounded to 10 bits, half to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32).view(x.shape)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a per-tensor scale, back in float32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / _E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A convolution's or matmul's operand in ``precision``. The rounding
    passes gradients straight through, so a backward pass multiplies by
    the rounded operands."""
    if precision == "f32":
        return x
    if precision == "tf32":
        r = round_tf32(x.detach())
    elif precision == "fp8":
        r = round_fp8(x.detach())
    else:
        raise ValueError(f"precision={precision!r} (want one of "
                         f"{PRECISIONS})")
    return x + (r - x).detach() if x.requires_grad else r
