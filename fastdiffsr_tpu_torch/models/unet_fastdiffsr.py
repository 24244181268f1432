"""FastDiffSR denoiser UNet (plain PyTorch forward).

Counterpart of ``fastdiffsr_tpu/models/unet_fastdiffsr.py`` and of the
reference model/fastdiffsr_modules/unet.py:224-323: an SR3-style
conditional UNet whose only attention is the CLAM/SLAM channel and
spatial gates of the first mid block.

Module and parameter names follow the reference's torch module tree
(``noise_level_mlp.{1,3}``, ``downs.i``, ``mid.i``, ``ups.i``,
``final_conv``; ``res_block.block1.block.{0,3}`` for GroupNorm and conv,
``res_block.noise_func.noise_func.0``, ``ca.fc1``, ``sa.conv1``), so a
reference state dict loads by name and ``models/convert.py`` maps the
Flax tree of the JAX package onto it. The reference's dead
``ResnetBlocWithAttn.conv`` 1x1 is not created.

The forward takes and returns NHWC (B,H,W,C) like the JAX package and
works on NCHW views of channels-last memory inside. ``dtype`` is the
compute type: GroupNorm statistics and Swish run in float32 and each
conv or linear layer runs in ``dtype`` with its parameters cast, as the
Flax modules do.

The GroupNorm -> Swish of every ``Block`` is kernel K1 through
``ops.groupnorm.gn_swish_custom`` (forward on the kernel, backward the
VJP of ``gn_swish_reference``), as the JAX package's
``FASTDIFFSR_TPU_FUSED_NORM=pallas`` mode; on CPU tensors it runs K1's
plain PyTorch version.

In train mode (``net.train()``) the dropout of each ResnetBlock's
``block2`` draws its mask from the ``torch.Generator`` passed to
``forward(..., generator=)``; its masks differ from Flax's by design.
In eval mode dropout is the identity.

``quant`` ('w8a8' or 'w8a8s'; ``unet_from_config`` reads
``FASTDIFFSR_TPU_QUANT``) runs the 3x3 conv of every ``Block`` whose map
is at least QUANT_MIN_HEIGHT rows high as a W8A8 int8 conv
(``ops.quant.quant_conv3``: kernel Q1 on CUDA), as the JAX Block does on
its wide stages: 21 Blocks of a 64->256 forward, 31 of a 128->512 one.
The parameters do not change.

The JAX package's exact layout rewrites take the same constructor
arguments, defaults, environment variables (read by
``unet_from_config``, as JAX's builder does) and errors. Each has the
literal form's parameters and computes its function:

- ``upsample_mode`` (``FASTDIFFSR_TPU_UPSAMPLE``: ``tconv``, the
  default, ``dense`` for the literal form, or ``d2s2``): the Upsample's
  nearest x2 + 3x3 conv as one stride-2 transposed conv, or as a 2x2
  conv into four phase maps that are then interleaved
  (:func:`apply_upsample2_conv3`);
- ``fold`` (``FASTDIFFSR_TPU_FOLD``: 'down', 'all'): level 0 runs on
  image pairs folded into the channels (:func:`fold2`): GroupNorm with
  twice the groups and its affine tiled, each conv block-diagonal;
- ``skip_concat`` (``FASTDIFFSR_TPU_SKIP_CONCAT``: 'split', 'swap'): an
  up block whose GroupNorm groups each lie in one part of [x, skip] takes
  the parts unconcatenated (K1 per part, per-part convs summed), or
  concatenated as [skip, x] with its parameters rolled;
- ``conv_split`` (``FASTDIFFSR_TPU_CONV_SPLIT``: ``ups_*`` names): that
  block's block1 conv and 1x1 residual as per-part convs summed at the
  [x, skip] boundary;
- ``stats_barrier`` (block names): an XLA optimization barrier in JAX,
  the identity outside XLA; the names are checked as JAX checks them.

The constructors default to the literal forms. The forms take the float
conv even where ``quant`` is set, as in JAX, and every GroupNorm ->
Swish of every form is K1. JAX's guards hold as with its
``fused_norm=''``, the function K1 computes.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.groupnorm import gn_swish_custom
from ..ops.quant import MODES, default_quant, quant_conv3
from ..ops.tconv import upsample_tconv

# the JAX Block quantizes where its NHWC map has h.shape[1] >= 128 (the
# height; here x.shape[2] of the NCHW view)
QUANT_MIN_HEIGHT = 128
UPSAMPLE_MODES = ("", "tconv", "d2s2")


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def positional_encoding(noise_level: torch.Tensor, dim: int) -> torch.Tensor:
    """WaveGrad sinusoidal encoding of a continuous noise level
    (reference unet.py:22-35). noise_level: (B,) -> (B, dim)."""
    count = dim // 2
    step = torch.arange(count, dtype=noise_level.dtype,
                        device=noise_level.device) / count
    enc = noise_level[:, None] * torch.exp(-math.log(1e4) * step)[None, :]
    return torch.cat([torch.sin(enc), torch.cos(enc)], dim=-1)


def _linear(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias,
                    stride=conv.stride, padding=conv.padding)


def _gn_swish(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              groups: int, eps: float) -> torch.Tensor:
    """K1 on the NHWC view of a channels-last (B, C, H, W) map."""
    return gn_swish_custom(x.permute(0, 2, 3, 1), scale, bias, groups,
                           eps).permute(0, 3, 1, 2)


def fold2(x: torch.Tensor) -> torch.Tensor:
    """Fold image pairs into the channels: a (B, C, H, W) map -> a
    (B/2, 2C, H, W) channels-last one whose channels [0:C] are image 2i
    and [C:2C] image 2i+1 (JAX ``fold2``). With block-diagonal weights
    (:func:`_blockdiag2`) and twice the GroupNorm groups, each folded op
    computes the unfolded one."""
    b, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(b // 2, 2, h, w, c)
    return y.permute(0, 2, 3, 1, 4).reshape(b // 2, h, w, 2 * c) \
            .contiguous().permute(0, 3, 1, 2)


def unfold2(y: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`fold2`."""
    b2, c2, h, w = y.shape
    x = y.permute(0, 2, 3, 1).reshape(b2, h, w, 2, c2 // 2)
    return x.permute(0, 3, 1, 2, 4).reshape(2 * b2, h, w, c2 // 2) \
            .contiguous().permute(0, 3, 1, 2)


def _blockdiag2(w: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, kh, kw) -> (2Co, 2Ci, kh, kw) block-diagonal: folded image
    A reads only A's channels, B only B's (JAX ``_blockdiag2``)."""
    z = torch.zeros_like(w)
    return torch.cat([torch.cat([w, z], dim=1), torch.cat([z, w], dim=1)],
                     dim=0)


def _folded_conv(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """``conv`` on a fold2-folded map: its weight block-diagonal, its bias
    tiled."""
    return F.conv2d(x.to(dtype), _blockdiag2(conv.weight.to(dtype)),
                    conv.bias.to(dtype).repeat(2), stride=conv.stride,
                    padding=conv.padding)


def _conv_parts(parts, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """``conv`` of the channel concat of ``parts`` as the sum of one conv
    per part over its slice of the input channels, plus the bias."""
    w = conv.weight.to(dtype)
    y, c0 = None, 0
    for part in parts:
        c1 = c0 + part.shape[1]
        yp = F.conv2d(part.to(dtype), w[:, c0:c1], None,
                      stride=conv.stride, padding=conv.padding)
        y = yp if y is None else y + yp
        c0 = c1
    return y + conv.bias.to(dtype)[:, None, None]


def check_upsample_mode(mode: str) -> None:
    if mode not in UPSAMPLE_MODES:
        raise ValueError(f"upsample_mode={mode!r} (want '', 'tconv' or "
                         "'d2s2')")


def _upsample_phase_kernel(w: torch.Tensor) -> torch.Tensor:
    """A (Co, Ci, 3, 3) kernel -> the four 2x2 phase kernels of the exact
    nearest x2 + 3x3 conv, stacked on the output channels in phase order
    (a, b) = 00, 01, 10, 11: (4Co, Ci, 2, 2) (JAX
    ``_upsample_phase_kernel``). Output row 2i+a reads input rows
    {i-1: w0, i: w1+w2} for a = 0 and {i: w0+w1, i+1: w2} for a = 1;
    columns alike."""
    rows = (torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], dim=2),
            torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], dim=2))

    def cols(k, b):
        if b == 0:
            return torch.stack([k[..., 0], k[..., 1] + k[..., 2]], dim=-1)
        return torch.stack([k[..., 0] + k[..., 1], k[..., 2]], dim=-1)

    return torch.cat([cols(rows[0], 0), cols(rows[0], 1), cols(rows[1], 0),
                      cols(rows[1], 1)], dim=0)


def _upsample_tconv_kernel(w: torch.Tensor) -> torch.Tensor:
    """A (Co, Ci, 3, 3) kernel -> the (Co, Ci, 4, 4) kernel whose
    correlation with the 2x-dilated input, padded by 2, is the exact
    nearest x2 + 3x3 conv: per axis the taps [w0, w0+w1, w1+w2, w2] (JAX
    ``_upsample_tconv_kernel``)."""
    rows = torch.stack([w[:, :, 0], w[:, :, 0] + w[:, :, 1],
                        w[:, :, 1] + w[:, :, 2], w[:, :, 2]], dim=2)
    return torch.stack([rows[..., 0], rows[..., 0] + rows[..., 1],
                        rows[..., 1] + rows[..., 2], rows[..., 2]], dim=-1)


def apply_upsample2_conv3(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, mode: str,
                          dtype) -> torch.Tensor:
    """conv3x3(nearest_x2(x)) of a (B, Ci, H, W) map, given the (Co, Ci,
    3, 3) weight and (Co,) bias, in the exact form ``mode`` (JAX
    ``apply_upsample2_conv3``), in ``dtype``:

    - ``''``: the literal nearest x2 then the 3x3 conv;
    - ``'tconv'``: one stride-2 transposed conv with the 4x4 kernel of
      :func:`_upsample_tconv_kernel`, flipped, in and out channels
      swapped, as ``F.conv_transpose2d`` takes it (its padding 1 is the
      correlation's 4 - 1 - 2), on cuDNN's deterministic algorithms
      (``ops.tconv.upsample_tconv``);
    - ``'d2s2'``: a 2x2 conv of the 1-pixel-padded map into 4Co phase
      channels, then y[2i+a, 2j+b] = z[i+a, j+b, phase (a, b)].

    The output is channels-last."""
    if mode == "":
        y = F.interpolate(x, scale_factor=2, mode="nearest")
        return F.conv2d(y.to(dtype), weight.to(dtype), bias.to(dtype),
                        padding=1)
    if mode == "tconv":
        k4 = _upsample_tconv_kernel(weight).flip(2, 3).transpose(0, 1)
        return upsample_tconv(x.to(dtype), k4.to(dtype), bias.to(dtype))
    check_upsample_mode(mode)
    co = weight.shape[0]
    xp = F.pad(x.to(dtype), (1, 1, 1, 1)).contiguous(
        memory_format=torch.channels_last)
    z = F.conv2d(xp, _upsample_phase_kernel(weight).to(dtype)) \
        .permute(0, 2, 3, 1)                          # (B, H+1, W+1, 4Co)
    y = torch.stack([z[:, :-1, :-1, :co], z[:, :-1, 1:, co:2 * co],
                     z[:, 1:, :-1, 2 * co:3 * co], z[:, 1:, 1:, 3 * co:]],
                    dim=-2)                           # (B, H, W, 4, Co)
    b, h, w = y.shape[:3]
    y = y.reshape(b, h, w, 2, 2, co).transpose(2, 3).reshape(
        b, 2 * h, 2 * w, co)
    return (y + bias.to(dtype)).permute(0, 3, 1, 2)


class Swish(nn.Module):
    def forward(self, x):
        return swish(x)


class PositionalEncoding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, noise_level):
        return positional_encoding(noise_level, self.dim)


class Block(nn.Module):
    """GroupNorm -> Swish -> Dropout -> 3x3 conv (reference unet.py:89-101).

    The GroupNorm -> Swish (K1) runs on the NHWC view of ``x``, which is
    contiguous because the UNet keeps its maps channels-last. With
    ``quant`` set, a map of at least QUANT_MIN_HEIGHT rows takes the W8A8
    conv, its packed int8 weights kept while the weight is unchanged.

    The JAX Block's other forms (its :126-206), same parameters:

    - ``fold``: ``x`` is fold2-folded; K1 with twice the groups over 2C
      channels and the affine tiled, the conv block-diagonal;
    - ``in_perm`` > 0: ``x`` is concat([skip, x]) for parameters stored
      for [x, skip]; the affine and the conv's input channels are rolled
      by ``in_perm``;
    - a 2-tuple ``(a, b)`` stands for concat([a, b]): K1 per part with the
      part's share of the groups (each group must lie in one part), the
      conv as two per-part convs summed;
    - ``csplit`` > 0: one K1, the conv as two per-part convs summed at
      input channel ``csplit``.

    These take the float conv whatever ``quant`` says, as in JAX. In
    train mode a tuple draws one dropout mask per part; the fold form
    draws its mask in the unfolded layout, so a generator gives it the
    literal form's masks."""

    def __init__(self, dim: int, dim_out: int, groups: int = 32,
                 dropout: float = 0.0, quant: str = "", *,
                 fold: bool = False, in_perm: int = 0, csplit: int = 0):
        super().__init__()
        self.block = nn.Sequential(
            nn.GroupNorm(groups, dim), Swish(),
            nn.Dropout(dropout) if dropout else nn.Identity(),
            nn.Conv2d(dim, dim_out, 3, padding=1))
        self.quant = quant
        self.fold, self.in_perm, self.csplit = fold, in_perm, csplit
        self._q1_cache: dict = {}

    def _dropout(self, h: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        drop = self.block[2]
        if not (self.training and isinstance(drop, nn.Dropout)
                and drop.p > 0):
            return h
        if generator is None:
            raise ValueError("train-mode dropout draws its mask from an "
                             "explicit generator: pass generator=")
        if self.fold:
            b2, c2, hh, ww = h.shape
            keep = fold2(torch.empty(
                (2 * b2, c2 // 2, hh, ww), dtype=h.dtype, device=h.device,
                memory_format=torch.channels_last).bernoulli_(
                    1.0 - drop.p, generator=generator))
        else:
            keep = torch.empty_like(h).bernoulli_(1.0 - drop.p,
                                                  generator=generator)
        return h * keep / (1.0 - drop.p)

    def forward(self, x, dtype,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gn, conv = self.block[0], self.block[3]
        if isinstance(x, tuple):
            size = gn.num_channels // gn.num_groups
            hs, c0 = [], 0
            for part in x:
                c1 = c0 + part.shape[1]
                hs.append(self._dropout(_gn_swish(
                    part, gn.weight[c0:c1], gn.bias[c0:c1],
                    (c1 - c0) // size, gn.eps), generator))
                c0 = c1
            return _conv_parts(hs, conv, dtype)
        if self.fold:
            h = _gn_swish(x, gn.weight.repeat(2), gn.bias.repeat(2),
                          2 * gn.num_groups, gn.eps)
            return _folded_conv(self._dropout(h, generator), conv, dtype)
        if self.in_perm:
            h = _gn_swish(x, gn.weight.roll(self.in_perm),
                          gn.bias.roll(self.in_perm), gn.num_groups, gn.eps)
            return F.conv2d(self._dropout(h, generator).to(dtype),
                            conv.weight.roll(self.in_perm, 1).to(dtype),
                            conv.bias.to(dtype), padding=1)
        h = self._dropout(_gn_swish(x, gn.weight, gn.bias, gn.num_groups,
                                    gn.eps), generator)
        if self.csplit:
            return _conv_parts((h[:, :self.csplit], h[:, self.csplit:]),
                               conv, dtype)
        if self.quant and x.shape[2] >= QUANT_MIN_HEIGHT:
            y = quant_conv3(h.permute(0, 2, 3, 1), conv.weight, conv.bias,
                            dtype, static_scale=self.quant == "w8a8s",
                            cache=self._q1_cache)
            return y.permute(0, 3, 1, 2)
        return _conv(h, conv, dtype)


class FeatureWiseAffine(nn.Module):
    """Additive noise-level shift (reference unet.py:38-54)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.noise_func = nn.Sequential(nn.Linear(in_channels, out_channels))

    def forward(self, x, noise_embed, dtype, fold: bool = False):
        shift = _linear(noise_embed, self.noise_func[0], dtype)
        if fold:
            # folded layout: image 2i's shift, then image 2i+1's
            shift = shift.reshape(shift.shape[0] // 2, -1)
        return x + shift[:, :, None, None]


class ResnetBlock(nn.Module):
    """block1 -> +noise shift -> block2, plus a 1x1 (or identity) skip
    (reference unet.py:104-120). ``fold``, ``in_perm`` and ``csplit``
    select the Block forms and the residual's (JAX :252-321). JAX's
    ``stats_barrier`` (an XLA optimization barrier between block1's conv
    and block2's GroupNorm) is the identity here, and only
    :class:`FastDiffSRUNet` checks its names."""

    def __init__(self, dim: int, dim_out: int, noise_level_emb_dim: int,
                 dropout: float = 0.0, norm_groups: int = 32,
                 quant: str = "", *, in_perm: int = 0, fold: bool = False,
                 csplit: int = 0):
        super().__init__()
        self.noise_func = FeatureWiseAffine(noise_level_emb_dim, dim_out)
        self.block1 = Block(dim, dim_out, groups=norm_groups, quant=quant,
                            fold=fold, in_perm=in_perm, csplit=csplit)
        self.block2 = Block(dim_out, dim_out, groups=norm_groups,
                            dropout=dropout, quant=quant, fold=fold)
        self.res_conv = (nn.Conv2d(dim, dim_out, 1) if dim != dim_out
                         else nn.Identity())
        self.fold, self.in_perm, self.csplit = fold, in_perm, csplit

    def _skip(self, x, dtype) -> torch.Tensor:
        """The residual of ``x`` (a map or a 2-tuple of parts)."""
        res = self.res_conv
        if isinstance(x, tuple):
            return (torch.cat(x, dim=1) if isinstance(res, nn.Identity)
                    else _conv_parts(x, res, dtype))
        if isinstance(res, nn.Identity):
            return x
        if self.fold:
            return _folded_conv(x, res, dtype)
        if self.in_perm:
            return F.conv2d(x.to(dtype),
                            res.weight.roll(self.in_perm, 1).to(dtype),
                            res.bias.to(dtype))
        if self.csplit:
            return _conv_parts((x[:, :self.csplit], x[:, self.csplit:]),
                               res, dtype)
        return _conv(x, res, dtype)

    def forward(self, x, time_emb, dtype, generator=None):
        h = self.block1(x, dtype)
        h = self.noise_func(h, time_emb, dtype, fold=self.fold)
        h = self.block2(h, dtype, generator)
        return h + self._skip(x, dtype)


class CLAM(nn.Module):
    """Channel gate: shared 1x1 MLP over avg- and max-pooled channels
    (reference unet.py:123-149)."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // ratio, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // ratio, channels, 1, bias=False)

    def forward(self, x, dtype):
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)

        def mlp(v):
            return _conv(F.relu(_conv(v, self.fc1, dtype)), self.fc2, dtype)

        return torch.sigmoid(mlp(avg) + mlp(mx)) * x


class SLAM(nn.Module):
    """Spatial gate: 7x7 conv over [channel mean, channel max]
    (reference unet.py:151-173)."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                               bias=False)

    def forward(self, x, dtype):
        s = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(_conv(s, self.conv1, dtype)) * x


class ResnetBlocWithAttn(nn.Module):
    """ResnetBlock optionally followed by CLAM then SLAM
    (reference unet.py:206-222). On the up path ``split_input`` says the
    block takes (x, skip) unconcatenated and ``in_perm`` that it takes
    concat([skip, x]); ``fold`` that it runs on fold2-folded maps."""

    def __init__(self, dim, dim_out, *, noise_level_emb_dim, norm_groups,
                 dropout=0.0, with_attn=False, quant="", in_perm=0,
                 fold=False, csplit=0, split_input=False):
        super().__init__()
        if fold and with_attn:
            raise ValueError("fold is only applied at attention-free levels")
        self.res_block = ResnetBlock(dim, dim_out, noise_level_emb_dim,
                                     dropout=dropout, norm_groups=norm_groups,
                                     quant=quant, in_perm=in_perm, fold=fold,
                                     csplit=csplit)
        self.with_attn = with_attn
        self.fold, self.in_perm = fold, in_perm
        self.split_input = split_input
        if with_attn:
            self.ca = CLAM(dim_out)
            self.sa = SLAM()

    def forward(self, x, time_emb, dtype, generator=None):
        x = self.res_block(x, time_emb, dtype, generator)
        if self.with_attn:
            x = self.sa(self.ca(x, dtype), dtype)
        return x


class Downsample(nn.Module):
    """Stride-2 3x3 conv (reference unet.py:77-83); block-diagonal on a
    fold2-folded map with ``fold``."""

    def __init__(self, dim: int, fold: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, 2, 1)
        self.fold = fold

    def forward(self, x, dtype):
        if self.fold:
            return _folded_conv(x, self.conv, dtype)
        return _conv(x, self.conv, dtype)


class Upsample(nn.Module):
    """Nearest x2 then 3x3 conv (reference unet.py:66-74), computed in the
    form ``mode`` of :func:`apply_upsample2_conv3`. ``conv`` is the 3x3
    conv in every mode, so the parameters and the fused forward, which
    reads them, do not depend on the mode."""

    def __init__(self, dim: int, mode: str = ""):
        super().__init__()
        check_upsample_mode(mode)
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)
        self.mode = mode

    def forward(self, x, dtype):
        return apply_upsample2_conv3(x, self.conv.weight, self.conv.bias,
                                     self.mode, dtype)


def resblock_names(num_mults: int, res_blocks: int) -> frozenset:
    """Names of every ResnetBlocWithAttn of the UNet (``downs_i``, ``mid_i``,
    ``ups_i`` by module index; JAX ``FastDiffSRUNet._resblock_names``):
    the down path counts the stem conv and the Downsamples, the up path
    the Upsamples, in the same index."""
    names = {"mid_0", "mid_1"}
    idx = 1                               # downs_0 is the stem conv
    for ind in range(num_mults):
        for _ in range(res_blocks):
            names.add(f"downs_{idx}")
            idx += 1
        if ind != num_mults - 1:
            idx += 1                      # Downsample
    idx = 0
    for ind in reversed(range(num_mults)):
        for _ in range(res_blocks + 1):
            names.add(f"ups_{idx}")
            idx += 1
        if ind >= 1:
            idx += 1                      # Upsample
    return frozenset(names)


class FastDiffSRUNet(nn.Module):
    """The FastDiffSR conditional UNet (reference unet.py:224-323).

    Defaults match configs/sr_fastdiffsr_test_64_256.json (inner 64,
    mults [1,2,4,4], 2 res blocks, dropout 0.2, groups 32). Input x:
    (B,H,W,in_channel) NHWC = concat(bicubic cond, noisy); noise_level:
    (B,) continuous sqrt(alpha_bar). Output (B,H,W,out_channel) float32.
    ``upsample_mode``, ``skip_concat``, ``fold``, ``stats_barrier`` and
    ``conv_split`` select the exact rewrites (module docstring), checked
    as the JAX module checks them.
    """

    def __init__(self, in_channel: int = 6, out_channel: int = 3,
                 inner_channel: int = 64, norm_groups: int = 32,
                 channel_mults: Sequence[int] = (1, 2, 4, 4),
                 res_blocks: int = 2, dropout: float = 0.2,
                 dtype=torch.float32, quant: str = "",
                 upsample_mode: str = "", skip_concat: str = "",
                 fold: str = "", stats_barrier: str = "",
                 conv_split: str = ""):
        super().__init__()
        # the JAX module's checks, in its order, with its messages
        if skip_concat not in ("", "split", "swap"):
            raise ValueError(f"skip_concat={skip_concat!r} "
                             "(want '', 'split' or 'swap')")
        names = resblock_names(len(channel_mults), res_blocks)
        barrier_set = frozenset(s for s in stats_barrier.split(",") if s)
        csplit_set = frozenset(s for s in conv_split.split(",") if s)
        bad = {s for s in csplit_set
               if not s.startswith("ups_") or s not in names}
        if bad:
            raise ValueError(
                f"conv_split names {sorted(bad)} do not name up-path "
                "ResnetBlockWithAttn instances (only ups_* blocks have a "
                "skip-concat boundary to split at)")
        if csplit_set and (quant or fold or skip_concat):
            raise ValueError("conv_split composes only with the default "
                             "quant/fold/skip_concat modes")
        unknown = barrier_set - names
        if unknown:
            raise ValueError(
                f"stats_barrier names {sorted(unknown)} do not name "
                f"ResnetBlockWithAttn instances; valid: {sorted(names)}")
        if quant not in MODES:
            raise ValueError(f"quant={quant!r} (want one of {MODES})")
        if fold not in ("", "down", "all"):
            raise ValueError(f"fold={fold!r} (want '', 'down' or 'all')")
        if fold and (quant or skip_concat):
            raise ValueError("fold composes only with the default norm/"
                             "quant/skip_concat modes")
        check_upsample_mode(upsample_mode)
        self.in_channel = in_channel
        self.out_channel = out_channel
        self.inner_channel = inner_channel
        self.norm_groups = norm_groups
        self.channel_mults = tuple(channel_mults)
        self.res_blocks = res_blocks
        self.dtype = dtype
        self.quant = quant
        self.upsample_mode, self.skip_concat = upsample_mode, skip_concat
        self.fold, self.stats_barrier = fold, stats_barrier
        self.conv_split = conv_split
        noise_dim = inner_channel
        rb = dict(noise_level_emb_dim=noise_dim, norm_groups=norm_groups,
                  dropout=dropout, quant=quant)
        self.noise_level_mlp = nn.Sequential(
            PositionalEncoding(inner_channel),
            nn.Linear(inner_channel, inner_channel * 4), Swish(),
            nn.Linear(inner_channel * 4, inner_channel))

        num_mults = len(channel_mults)
        pre = inner_channel
        feat_channels = [pre]
        downs = [nn.Conv2d(in_channel, inner_channel, 3, padding=1)]
        for ind in range(num_mults):
            fold_here = fold in ("down", "all") and ind == 0
            ch = inner_channel * channel_mults[ind]
            for _ in range(res_blocks):
                downs.append(ResnetBlocWithAttn(pre, ch, fold=fold_here, **rb))
                feat_channels.append(ch)
                pre = ch
            if ind != num_mults - 1:
                downs.append(Downsample(pre, fold=fold_here))
                feat_channels.append(pre)
        self.downs = nn.ModuleList(downs)
        self.mid = nn.ModuleList([
            ResnetBlocWithAttn(pre, pre, with_attn=True, **rb),
            ResnetBlocWithAttn(pre, pre, **rb)])
        ups = []
        for ind in reversed(range(num_mults)):
            fold_here = fold == "all" and ind == 0
            ch = inner_channel * channel_mults[ind]
            for _ in range(res_blocks + 1):
                name = f"ups_{len(ups)}"
                skip_ch = feat_channels.pop()
                dim_in = pre + skip_ch
                # split/swap are exact only where every GroupNorm group
                # lies wholly inside one part of [x, skip]
                mode_ok = (skip_concat in ("split", "swap")
                           and dim_in % norm_groups == 0
                           and pre % (dim_in // norm_groups) == 0)
                ups.append(ResnetBlocWithAttn(
                    dim_in, ch, fold=fold_here,
                    split_input=mode_ok and skip_concat == "split",
                    in_perm=(skip_ch if mode_ok and skip_concat == "swap"
                             else 0),
                    csplit=pre if name in csplit_set else 0, **rb))
                pre = ch
            if ind >= 1:
                ups.append(Upsample(pre, mode=upsample_mode))
        self.ups = nn.ModuleList(ups)
        self.final_conv = Block(pre, out_channel, groups=norm_groups,
                                quant=quant, fold=fold == "all")

    def noise_embedding(self, noise_level: torch.Tensor) -> torch.Tensor:
        mlp = self.noise_level_mlp
        t = positional_encoding(noise_level.float(), self.inner_channel)
        t = swish(_linear(t, mlp[1], self.dtype))
        return _linear(t, mlp[3], self.dtype)

    def forward(self, x: torch.Tensor, noise_level: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in train mode."""
        if self.fold and x.shape[0] % 2:
            raise ValueError(f"fold needs an even batch, got {x.shape[0]}")
        dt = self.dtype
        if noise_level.dim() == 2:
            noise_level = noise_level[:, 0]
        t = self.noise_embedding(noise_level)
        x = x.permute(0, 3, 1, 2).to(dt)

        stem = self.downs[0]
        if self.fold:
            x = _folded_conv(fold2(x), stem, dt)
            feats = [unfold2(x)]
        else:
            x = _conv(x, stem, dt)
            feats = [x]
        for layer in self.downs[1:]:
            if isinstance(layer, Downsample):
                x = layer(x, dt)
                if layer.fold:
                    # leave the folded level at the 4x smaller size
                    x = unfold2(x)
                feats.append(x)
            else:
                x = layer(x, t, dt, generator)
                feats.append(unfold2(x) if layer.fold else x)
        for layer in self.mid:
            x = layer(x, t, dt, generator)
        for layer in self.ups:
            if isinstance(layer, Upsample):
                x = layer(x, dt)
                continue
            skip = feats.pop()
            if layer.fold:
                # fold the concat, so each image's channels stay together
                x = unfold2(layer(fold2(torch.cat([x, skip], dim=1)), t, dt,
                                  generator))
            elif layer.split_input:
                x = layer((x, skip), t, dt, generator)
            elif layer.in_perm:
                x = layer(torch.cat([skip, x], dim=1), t, dt, generator)
            else:
                x = layer(torch.cat([x, skip], dim=1), t, dt, generator)
        if self.final_conv.fold:
            out = unfold2(self.final_conv(fold2(x), dt))
        else:
            out = self.final_conv(x, dt)
        return out.float().permute(0, 2, 3, 1).contiguous()


def init_params(net: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded initial parameters with the Flax defaults of the JAX
    package: LeCun-normal (truncated) conv and linear weights, zero biases,
    GroupNorm scale 1 and bias 0."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                m.weight.copy_(torch.nn.init.trunc_normal_(
                    torch.empty_like(m.weight), std=std, a=-2 * std,
                    b=2 * std, generator=gen))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return net


def unet_from_config(unet_opt: dict, dtype=torch.float32, device="cuda",
                     seed: int = 0) -> FastDiffSRUNet:
    """Build from a reference-schema ``model.unet`` config dict, with
    seeded initial parameters, in eval mode on ``device``. As JAX's
    builder, it reads ``quant`` (``FASTDIFFSR_TPU_QUANT``), the Upsample
    form (``FASTDIFFSR_TPU_UPSAMPLE``, default tconv), ``fold``,
    ``skip_concat`` and ``conv_split`` from the environment."""
    from ..device import resolve_device
    dev = resolve_device(device)
    net = FastDiffSRUNet(
        in_channel=unet_opt.get("in_channel", 6),
        out_channel=unet_opt.get("out_channel", 3),
        inner_channel=unet_opt.get("inner_channel", 64),
        norm_groups=unet_opt.get("norm_groups") or 32,
        channel_mults=tuple(unet_opt.get("channel_multiplier",
                                         (1, 2, 4, 4))),
        res_blocks=unet_opt.get("res_blocks", 2),
        dropout=unet_opt.get("dropout", 0.0),
        dtype=dtype,
        quant=default_quant(),
        upsample_mode=default_upsample_mode(),
        skip_concat=default_skip_concat(),
        fold=default_fold(),
        conv_split=default_conv_split())
    return init_params(net, seed).to(dev).eval()


def default_conv_split() -> str:
    """FASTDIFFSR_TPU_CONV_SPLIT: comma-separated up-path block names
    ('ups_12') whose block1 conv and 1x1 residual run as per-part convs
    summed at the skip-concat boundary. Default '': the literal convs."""
    return os.environ.get("FASTDIFFSR_TPU_CONV_SPLIT", "")


def default_fold() -> str:
    """FASTDIFFSR_TPU_FOLD: '' (the default: literal widths), 'down' (the
    stem, the level-0 down blocks and the first Downsample on fold2-folded
    image pairs) or 'all' (also the level-0 up blocks and the final
    Block). Needs an even batch."""
    mode = os.environ.get("FASTDIFFSR_TPU_FOLD", "")
    if mode not in ("", "down", "all"):
        raise ValueError(
            f"FASTDIFFSR_TPU_FOLD={mode!r} (want '', 'down' or 'all')")
    return mode


def default_skip_concat() -> str:
    """FASTDIFFSR_TPU_SKIP_CONCAT: '' (the default: the concat [x, skip]
    made), 'split' (never made: GroupNorm and the block1 and residual
    convs per part) or 'swap' (concat [skip, x], the parameters
    rolled)."""
    mode = os.environ.get("FASTDIFFSR_TPU_SKIP_CONCAT", "")
    if mode not in ("", "split", "swap"):
        raise ValueError(
            f"FASTDIFFSR_TPU_SKIP_CONCAT={mode!r} "
            "(want '', 'split' or 'swap')")
    return mode


def default_upsample_mode() -> str:
    """FASTDIFFSR_TPU_UPSAMPLE: 'tconv' (the default: one stride-2
    transposed conv), 'dense' (nearest x2 then the 3x3 conv, the literal
    form, returned as '') or 'd2s2' (a 2x2 conv into four phase maps,
    interleaved). One function of the same parameters."""
    mode = os.environ.get("FASTDIFFSR_TPU_UPSAMPLE", "tconv")
    if mode == "dense":
        return ""
    if mode not in ("", "d2s2", "tconv"):
        raise ValueError(
            f"FASTDIFFSR_TPU_UPSAMPLE={mode!r} "
            "(want 'tconv', 'dense' or 'd2s2')")
    return mode
