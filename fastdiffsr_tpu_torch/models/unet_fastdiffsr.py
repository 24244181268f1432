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
The parameters do not change. The JAX package's other opt-in rewrites
(fold, skip_concat, conv_split, stats_barrier, the tconv/d2s2 Upsample)
are not ported: the Upsample here is the literal nearest x2 + 3x3 conv.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.groupnorm import gn_swish_custom
from ..ops.quant import MODES, default_quant, quant_conv3

# the JAX Block quantizes where its NHWC map has h.shape[1] >= 128 (the
# height; here x.shape[2] of the NCHW view)
QUANT_MIN_HEIGHT = 128


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
    conv, its packed int8 weights kept while the weight is unchanged."""

    def __init__(self, dim: int, dim_out: int, groups: int = 32,
                 dropout: float = 0.0, quant: str = ""):
        super().__init__()
        self.block = nn.Sequential(
            nn.GroupNorm(groups, dim), Swish(),
            nn.Dropout(dropout) if dropout else nn.Identity(),
            nn.Conv2d(dim, dim_out, 3, padding=1))
        self.quant = quant
        self._q1_cache: dict = {}

    def forward(self, x: torch.Tensor, dtype,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gn = self.block[0]
        h = gn_swish_custom(x.permute(0, 2, 3, 1), gn.weight, gn.bias,
                            gn.num_groups, gn.eps).permute(0, 3, 1, 2)
        drop = self.block[2]
        if self.training and isinstance(drop, nn.Dropout) and drop.p > 0:
            if generator is None:
                raise ValueError("train-mode dropout draws its mask from an "
                                 "explicit generator: pass generator=")
            keep = torch.empty_like(h).bernoulli_(1.0 - drop.p,
                                                  generator=generator)
            h = h * keep / (1.0 - drop.p)
        conv = self.block[3]
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

    def forward(self, x, noise_embed, dtype):
        shift = _linear(noise_embed, self.noise_func[0], dtype)
        return x + shift[:, :, None, None]


class ResnetBlock(nn.Module):
    """block1 -> +noise shift -> block2, plus a 1x1 (or identity) skip
    (reference unet.py:104-120)."""

    def __init__(self, dim: int, dim_out: int, noise_level_emb_dim: int,
                 dropout: float = 0.0, norm_groups: int = 32,
                 quant: str = ""):
        super().__init__()
        self.noise_func = FeatureWiseAffine(noise_level_emb_dim, dim_out)
        self.block1 = Block(dim, dim_out, groups=norm_groups, quant=quant)
        self.block2 = Block(dim_out, dim_out, groups=norm_groups,
                            dropout=dropout, quant=quant)
        self.res_conv = (nn.Conv2d(dim, dim_out, 1) if dim != dim_out
                         else nn.Identity())

    def forward(self, x, time_emb, dtype, generator=None):
        h = self.block1(x, dtype)
        h = self.noise_func(h, time_emb, dtype)
        h = self.block2(h, dtype, generator)
        skip = (x if isinstance(self.res_conv, nn.Identity)
                else _conv(x, self.res_conv, dtype))
        return h + skip


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
    (reference unet.py:206-222)."""

    def __init__(self, dim, dim_out, *, noise_level_emb_dim, norm_groups,
                 dropout=0.0, with_attn=False, quant=""):
        super().__init__()
        self.res_block = ResnetBlock(dim, dim_out, noise_level_emb_dim,
                                     dropout=dropout, norm_groups=norm_groups,
                                     quant=quant)
        self.with_attn = with_attn
        if with_attn:
            self.ca = CLAM(dim_out)
            self.sa = SLAM()

    def forward(self, x, time_emb, dtype, generator=None):
        x = self.res_block(x, time_emb, dtype, generator)
        if self.with_attn:
            x = self.sa(self.ca(x, dtype), dtype)
        return x


class Downsample(nn.Module):
    """Stride-2 3x3 conv (reference unet.py:77-83)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, 2, 1)

    def forward(self, x, dtype):
        return _conv(x, self.conv, dtype)


class Upsample(nn.Module):
    """Nearest x2 then 3x3 conv (reference unet.py:66-74)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x, dtype):
        return _conv(F.interpolate(x, scale_factor=2, mode="nearest"),
                     self.conv, dtype)


class FastDiffSRUNet(nn.Module):
    """The FastDiffSR conditional UNet (reference unet.py:224-323).

    Defaults match configs/sr_fastdiffsr_test_64_256.json (inner 64,
    mults [1,2,4,4], 2 res blocks, dropout 0.2, groups 32). Input x:
    (B,H,W,in_channel) NHWC = concat(bicubic cond, noisy); noise_level:
    (B,) continuous sqrt(alpha_bar). Output (B,H,W,out_channel) float32.
    """

    def __init__(self, in_channel: int = 6, out_channel: int = 3,
                 inner_channel: int = 64, norm_groups: int = 32,
                 channel_mults: Sequence[int] = (1, 2, 4, 4),
                 res_blocks: int = 2, dropout: float = 0.2,
                 dtype=torch.float32, quant: str = ""):
        super().__init__()
        if quant not in MODES:
            raise ValueError(f"quant={quant!r} (want one of {MODES})")
        self.in_channel = in_channel
        self.out_channel = out_channel
        self.inner_channel = inner_channel
        self.norm_groups = norm_groups
        self.channel_mults = tuple(channel_mults)
        self.res_blocks = res_blocks
        self.dtype = dtype
        self.quant = quant
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
            ch = inner_channel * channel_mults[ind]
            for _ in range(res_blocks):
                downs.append(ResnetBlocWithAttn(pre, ch, **rb))
                feat_channels.append(ch)
                pre = ch
            if ind != num_mults - 1:
                downs.append(Downsample(pre))
                feat_channels.append(pre)
        self.downs = nn.ModuleList(downs)
        self.mid = nn.ModuleList([
            ResnetBlocWithAttn(pre, pre, with_attn=True, **rb),
            ResnetBlocWithAttn(pre, pre, **rb)])
        ups = []
        for ind in reversed(range(num_mults)):
            ch = inner_channel * channel_mults[ind]
            for _ in range(res_blocks + 1):
                ups.append(ResnetBlocWithAttn(pre + feat_channels.pop(), ch,
                                              **rb))
                pre = ch
            if ind >= 1:
                ups.append(Upsample(pre))
        self.ups = nn.ModuleList(ups)
        self.final_conv = Block(pre, out_channel, groups=norm_groups,
                                quant=quant)

    def noise_embedding(self, noise_level: torch.Tensor) -> torch.Tensor:
        mlp = self.noise_level_mlp
        t = positional_encoding(noise_level.float(), self.inner_channel)
        t = swish(_linear(t, mlp[1], self.dtype))
        return _linear(t, mlp[3], self.dtype)

    def forward(self, x: torch.Tensor, noise_level: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in train mode."""
        dt = self.dtype
        if noise_level.dim() == 2:
            noise_level = noise_level[:, 0]
        t = self.noise_embedding(noise_level)
        x = x.permute(0, 3, 1, 2).to(dt)

        feats = []
        for layer in self.downs:
            if isinstance(layer, ResnetBlocWithAttn):
                x = layer(x, t, dt, generator)
            elif isinstance(layer, Downsample):
                x = layer(x, dt)
            else:
                x = _conv(x, layer, dt)
            feats.append(x)
        for layer in self.mid:
            x = layer(x, t, dt, generator)
        for layer in self.ups:
            if isinstance(layer, ResnetBlocWithAttn):
                x = layer(torch.cat([x, feats.pop()], dim=1), t, dt,
                          generator)
            else:
                x = layer(x, dt)
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
    seeded initial parameters, in eval mode on ``device``; ``quant`` from
    ``FASTDIFFSR_TPU_QUANT`` (``ops.quant.default_quant``), as JAX's."""
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
        quant=default_quant())
    return init_params(net, seed).to(dev).eval()
