"""Fused GroupNorm -> Swish -> 3x3 conv with a statistics epilogue (K3).

Counterpart of ``fastdiffsr_tpu/ops/fused_conv.py``. One call computes a
whole UNet ``Block`` of the inference forward:

    y = conv3x3(swish(GN(x) * gamma + beta)) + b [+ shift(B,Co)] [+ res]
    stats_y = per-channel (sum y, sum y^2) over H,W of the float32
              accumulator, res included, before the cast to x.dtype

``x`` is an NHWC map or a tuple of maps read as one channel concat (the
up path's skip concat) without building it. The GroupNorm statistics come
in as channel sums (``stats_in``, from the previous call's epilogue or
from ``channel_stats``); the kernels collapse them to the per-channel
affine themselves (``block_group_mean_inv`` in ``csrc/common.cuh``), and
:func:`group_stats_to_norm` is the plain version of that collapse.

On a CUDA tensor the wrapper launches a hand-written kernel or raises.
:func:`k3_route` names which: bfloat16 maps go to the tensor-core
implicit GEMM of ``csrc/fused_conv_wgmma.cu`` (``"wgmma"``), float32 maps
to the register-blocked, pipelined implicit GEMM in IEEE float32 FFMA of
``csrc/fused_conv.cu`` (``"cuda_cores"``), which must not pass through
TF32; that kernel picks its tile from the grid a call gives, so the
wrapper asks it for the tile count that sizes the partial statistics
(``fdsr_fused_conv_tiles``). The plain PyTorch version
(:func:`fused_gn_swish_conv3x3_plain`) runs only for tensors on the CPU;
it is also the kernels' oracle on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import kernels

Maps = Union[torch.Tensor, Tuple[torch.Tensor, ...]]

ROUTE_TAKEN = {"wgmma": 0, "cuda_cores": 0}


def k3_route(dtype: torch.dtype, Cs: Sequence[int], Co: int) -> str:
    """Which hand-written kernel takes a K3 call on the card: ``"wgmma"``
    (bfloat16, an implicit GEMM on the tensor cores) or ``"cuda_cores"``
    (float32, an implicit GEMM in IEEE float32 FFMA, 8 pixels x 8 output
    channels per thread, staged with cp.async). Both pad ragged widths
    (C = 6, Co = 3) in shared memory and mask ragged H, W, so the type
    alone decides. Raises for what neither kernel takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_gn_swish_conv3x3: dtype {dtype} "
                        "(want float32 or bfloat16)")
    if len(Cs) > 2:
        raise ValueError("fused_gn_swish_conv3x3 reads at most two sources")
    if min(Cs) < 1 or Co < 1:
        raise ValueError(f"fused_gn_swish_conv3x3: widths {tuple(Cs)}->{Co}")
    return "wgmma" if dtype == torch.bfloat16 else "cuda_cores"


def group_stats_to_norm(stats: torch.Tensor, hw: int, groups: int,
                        eps: float = 1e-5):
    """(B, 2, C) channel sums -> per-channel (mean, inv_std) of GroupNorm,
    each (B, C) float32. ``hw`` is the spatial count the sums cover."""
    b, _, c = stats.shape
    cg = c // groups
    cnt = float(hw * cg)
    gsum = stats[:, 0].reshape(b, groups, cg).sum(-1)
    gsq = stats[:, 1].reshape(b, groups, cg).sum(-1)
    mean_g = gsum / cnt
    var_g = torch.clamp(gsq / cnt - mean_g ** 2, min=0.0)
    inv_g = torch.rsqrt(var_g + eps)
    return (mean_g.repeat_interleave(cg, dim=-1),
            inv_g.repeat_interleave(cg, dim=-1))


def _norm_affine(xs: Sequence[torch.Tensor], gn_scale, gn_bias, stats_in,
                 groups: int, eps: float):
    """Per-(batch, channel) scale and bias, float32 (B, C), that fold the
    GroupNorm of the channel concat of ``xs`` with its affine."""
    B, H, W = xs[0].shape[:3]
    sts = stats_in if isinstance(stats_in, tuple) else (stats_in,)
    stats_cat = torch.cat(sts, dim=-1) if len(sts) > 1 else sts[0]
    mean_c, inv_c = group_stats_to_norm(stats_cat.float(), H * W, groups, eps)
    g = gn_scale.float()[None, :]
    scale = inv_c * g
    bias = gn_bias.float()[None, :] - mean_c * inv_c * g
    return scale.contiguous(), bias.contiguous()


def fused_gn_swish_conv3x3_plain(x: Maps, gn_scale, gn_bias, stats_in,
                                 w: torch.Tensor, b: torch.Tensor,
                                 shift: Optional[torch.Tensor] = None,
                                 res: Optional[torch.Tensor] = None,
                                 groups: int = 32, eps: float = 1e-5,
                                 apply_norm: bool = True,
                                 want_stats: bool = True):
    """Plain PyTorch version of K3: the same arithmetic, with the
    normalised map rounded to x.dtype before a float32 convolution."""
    xs = x if isinstance(x, tuple) else (x,)
    dtype = xs[0].dtype
    xcat = torch.cat(xs, dim=-1) if len(xs) > 1 else xs[0]
    v = xcat.float()
    if apply_norm:
        scale, bias = _norm_affine(xs, gn_scale, gn_bias, stats_in, groups,
                                   eps)
        v = v * scale[:, None, None, :] + bias[:, None, None, :]
        v = v * torch.sigmoid(v)
    v = v.to(dtype).float()
    acc = F.conv2d(v.permute(0, 3, 1, 2),
                   w.to(dtype).float().permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1)
    acc = acc + b.float()
    if shift is not None:
        acc = acc + shift.float()[:, None, None, :]
    if res is not None:
        acc = acc + res.float()
    y = acc.to(dtype).contiguous()
    if not want_stats:
        return y
    stats = torch.stack([acc.sum(dim=(1, 2)), (acc * acc).sum(dim=(1, 2))],
                        dim=1)
    return y, stats


def _fused_cuda(xs, gn_scale, gn_bias, stats_in, w, b, shift, res, groups,
                eps, apply_norm, want_stats):
    x0 = xs[0]
    dev, dtype = x0.device, x0.dtype
    if dev.type != "cuda":
        raise ValueError(f"fused_gn_swish_conv3x3: unsupported device {dev}")
    B, H, W = x0.shape[:3]
    for xx in xs:
        if (xx.dim() != 4 or tuple(xx.shape[:3]) != (B, H, W)
                or xx.dtype != dtype or xx.device != dev
                or not xx.is_contiguous()):
            raise ValueError("fused_gn_swish_conv3x3: sources must be "
                             "contiguous NHWC maps of one shape, dtype and "
                             "device")
    Cs = [xx.shape[-1] for xx in xs]
    C = sum(Cs)
    if w.shape[:3] != (3, 3, C):
        raise ValueError(f"weight shape {tuple(w.shape)} is not (3,3,{C},Co)")
    Co = w.shape[-1]
    route = k3_route(dtype, Cs, Co)
    w = w.to(dtype).contiguous()
    b = b.float().contiguous()
    if b.shape != (Co,):
        raise ValueError(f"bias shape {tuple(b.shape)} is not ({Co},)")
    if shift is not None:
        shift = shift.float().contiguous()
        if shift.shape != (B, Co):
            raise ValueError(f"shift shape {tuple(shift.shape)} != {(B, Co)}")
    if res is not None:
        if (tuple(res.shape) != (B, H, W, Co) or res.dtype != dtype
                or not res.is_contiguous()):
            raise ValueError("res must be a contiguous (B,H,W,Co) map of "
                             "x.dtype")
    sts = [None, None]
    if apply_norm:
        if C % groups:
            raise ValueError(f"{C} channels in {groups} groups")
        gn_scale = gn_scale.detach().float().contiguous()
        gn_bias = gn_bias.detach().float().contiguous()
        if gn_scale.shape != (C,) or gn_bias.shape != (C,):
            raise ValueError(f"GroupNorm scale and bias must be ({C},)")
        given = stats_in if isinstance(stats_in, tuple) else (stats_in,)
        if len(given) != len(xs):
            raise ValueError("stats_in must match x, one per source")
        for k, (st, c) in enumerate(zip(given, Cs)):
            if (tuple(st.shape) != (B, 2, c) or st.dtype != torch.float32
                    or not st.is_contiguous()):
                raise ValueError(f"stats_in must be contiguous float32 "
                                 f"(B,2,C) channel sums, got "
                                 f"{tuple(st.shape)} {st.dtype}")
            sts[k] = st
    else:
        gn_scale = gn_bias = None
    for t in (w, b, shift, res, gn_scale, gn_bias, *sts):
        if t is not None and t.device != dev:
            raise ValueError("all operands must be on one device")

    lib = kernels.load()
    if route == "wgmma":
        launch, max_c = (lib.fdsr_fused_gn_swish_conv3x3_wgmma,
                         lib.fdsr_fused_conv_wgmma_max_channels())
    else:
        launch, max_c = (lib.fdsr_fused_gn_swish_conv3x3,
                         lib.fdsr_fused_conv_max_channels())
    if C > max_c:
        raise ValueError(f"fused_gn_swish_conv3x3: {C} input channels exceed "
                         f"the {route} kernel's {max_c}")
    y = torch.empty((B, H, W, Co), dtype=dtype, device=dev)
    partial = stats = None
    if want_stats:
        # the float32 kernel's tile, and so its tile count, depends on the
        # grid the call gives
        n_tiles = (lib.fdsr_fused_conv_wgmma_tiles(H, W) if route == "wgmma"
                   else lib.fdsr_fused_conv_tiles(B, H, W, Co))
        partial = torch.empty((B, n_tiles, 2, Co), dtype=torch.float32,
                              device=dev)
        stats = torch.empty((B, 2, Co), dtype=torch.float32, device=dev)
    p = kernels.ptr
    with torch.cuda.device(dev):
        code = launch(
            p(xs[0]), p(xs[1]) if len(xs) > 1 else None, Cs[0],
            Cs[1] if len(xs) > 1 else 0, p(sts[0]), p(sts[1]), p(gn_scale),
            p(gn_bias), groups, eps, int(apply_norm), p(w), p(b), p(shift),
            p(res), p(y), p(partial), p(stats), B, H, W, Co,
            kernels.stream_of(dev))
    kernels.check(lib, code, f"fused_gn_swish_conv3x3 ({route})")
    kernels.count_launch("fused_gn_swish_conv3x3")
    ROUTE_TAKEN[route] += 1
    return (y, stats) if want_stats else y


def fused_gn_swish_conv3x3(x: Maps, gn_scale: Optional[torch.Tensor],
                           gn_bias: Optional[torch.Tensor], stats_in,
                           w: torch.Tensor, b: torch.Tensor,
                           shift: Optional[torch.Tensor] = None,
                           res: Optional[torch.Tensor] = None,
                           groups: int = 32, eps: float = 1e-5,
                           apply_norm: bool = True, want_stats: bool = True):
    """y [+ stats_y] (see the module docstring).

    x: (B,H,W,C) or a tuple of up to two maps; stats_in: (B,2,C) float32
    channel sums of x (a tuple matching x), required when apply_norm.
    w: (3,3,C,Co) HWIO, cast to x.dtype; b: (Co,). shift: optional (B,Co)
    per-image bias; res: optional (B,H,W,Co) residual. Returns y
    (B,H,W,Co) in x.dtype and, when want_stats, stats_y (B,2,Co) float32.
    """
    xs = x if isinstance(x, tuple) else (x,)
    if kernels.traced():
        sts = (() if stats_in is None else
               stats_in if isinstance(stats_in, tuple) else (stats_in,))
        out = torch.ops.fdsr.fused_gn_swish_conv3x3(
            list(xs), gn_scale, gn_bias, list(sts), w, b, shift, res, groups,
            eps, apply_norm, want_stats)
        return tuple(out) if want_stats else out[0]
    if xs[0].device.type == "cpu":
        return fused_gn_swish_conv3x3_plain(
            x, gn_scale, gn_bias, stats_in, w, b, shift=shift, res=res,
            groups=groups, eps=eps, apply_norm=apply_norm,
            want_stats=want_stats)
    return _fused_cuda(xs, gn_scale, gn_bias, stats_in, w, b, shift, res,
                       groups, eps, apply_norm, want_stats)
