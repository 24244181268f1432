"""The work a cell asks of the device, counted from shapes and from the
reference, never from the program.

- Peaks of one H100 SXM (dense, NVIDIA's data sheet, at its 700 W
  limit): 989 TFLOP/s bf16, 67 TFLOP/s IEEE float32 outside the tensor
  cores, 3.35 TB/s of HBM. A roofline bound is the larger of operations
  over the peak rate and bytes over the peak bandwidth.
- K3 (the fused GroupNorm -> Swish -> 3x3 conv of the sampling forward):
  per call 2*9*C*Co*B*H*W operations, and its input read once, its output
  (and a residual) written or read once, its weights once and its
  statistics (8 bytes a channel and image). The calls of one eval are
  every Block of the UNet, its stem and its three Upsample convs.
- K1 (GroupNorm -> Swish under every Block of the training forward):
  per call the map read once and written once, 11 float32 operations an
  element.
- Model FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the
  reference's forward (sampling) or forward and backward (training) on
  meta tensors of the cell's shapes: convolutions and matmuls.
"""

from __future__ import annotations

import torch

from ..reference import unets

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
ELEM_BYTES = {"bf16": 2, "f32": 4}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def k3_call_s(B, H, W, C, Co, res: bool, stats: bool, dtype: str) -> float:
    es = ELEM_BYTES[dtype]
    flops = 2.0 * 9 * C * Co * B * H * W
    nbytes = (B * H * W * (C + Co * (2 if res else 1)) * es
              + 9 * C * Co * es + (8 * B * Co if stats else 0))
    return bound_s(flops, nbytes, dtype)


def k1_call_s(B, H, W, C, dtype: str) -> float:
    n = B * H * W * C
    return bound_s(11.0 * n, 2.0 * n * ELEM_BYTES[dtype] + 8 * C, "f32")


def _walk(model: dict, batch: int, size: int):
    """One meta forward of the reference: the (kind, shape) of every
    Block, Upsample and the stem, in call order."""
    net = unets.build_unet(model, device="meta")
    calls = []

    def hook(kind):
        def fn(mod, args, out):
            calls.append((kind, mod, tuple(args[0].shape), tuple(out.shape)))
        return fn

    for mod in net.modules():
        if isinstance(mod, unets.Block):
            mod.register_forward_hook(hook("block"))
        elif isinstance(mod, unets.Upsample):
            mod.register_forward_hook(hook("up"))
    finals = {id(net.final_conv)}
    block2s = {id(m.block2) for m in net.modules()
               if isinstance(m, (unets.ResnetBlock, unets.SR3ResnetBlock))}
    u = model["unet"]
    x = torch.empty((batch, size, size, u["in_channel"]), device="meta")
    with torch.no_grad():
        net(x, torch.empty((batch,), device="meta"))
    stem = (batch, size, size, u["in_channel"], u["inner_channel"])
    return calls, finals, block2s, stem


def k3_bound_s_per_eval(model: dict, batch: int, size: int,
                        dtype: str) -> float:
    calls, finals, block2s, (B, H, W, C, Co) = _walk(model, batch, size)
    total = k3_call_s(B, H, W, C, Co, False, True, dtype)
    for kind, mod, (b, c, h, w), out in calls:
        if kind == "up":
            total += k3_call_s(b, 2 * h, 2 * w, c, c, False, True, dtype)
        else:
            total += k3_call_s(b, h, w, c, out[1], id(mod) in block2s,
                               id(mod) not in finals, dtype)
    return total


def k1_bound_s_per_forward(model: dict, batch: int, size: int,
                           dtype: str = "f32") -> float:
    calls, _, _, _ = _walk(model, batch, size)
    return sum(k1_call_s(b, h, w, c, dtype)
               for kind, _, (b, c, h, w), _ in calls if kind == "block")


def k3_calls_per_eval(model: dict, batch: int, size: int) -> int:
    calls, _, _, _ = _walk(model, batch, size)
    return 1 + len(calls)


def flops_per_eval(model: dict, batch: int, size: int) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    net = unets.build_unet(model, device="meta")
    u = model["unet"]
    x = torch.empty((batch, size, size, u["in_channel"]), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        net(x, torch.empty((batch,), device="meta"))
    return float(fc.get_total_flops())


def flops_per_train_step(model: dict, batch: int, size: int) -> float:
    """Forward and backward of the reference net at the training batch
    (dropout on; the loss's own arithmetic is not counted)."""
    from torch.utils.flop_counter import FlopCounterMode
    net = unets.build_unet(model, device="meta").train()
    u = model["unet"]
    x = torch.empty((batch, size, size, u["in_channel"]), device="meta")
    with FlopCounterMode(display=False) as fc:
        out = net(x, torch.empty((batch,), device="meta"),
                  generator=None)
        out.sum().backward()
    return float(fc.get_total_flops())

