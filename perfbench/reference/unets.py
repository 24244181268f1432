"""Plain float32 copies of the two denoiser UNets the benchmark runs.

FastDiffSR's UNet (Meng-333/FastDiffSR ``model/fastdiffsr_modules/
unet.py``: an SR3-style conditional UNet whose only attention is the
CLAM channel gate and SLAM spatial gate of the first mid block) and the
SR3 UNet of its ``ddpm`` baseline (``model/ddpm_modules/unet.py``: a
per-ResnetBlock time MLP and single-head self-attention wherever the
running resolution is in ``attn_res``, and in the first mid block).

Written from those descriptions in plain ``torch``: every GroupNorm is
``F.group_norm``, every Upsample the literal nearest x2 then 3x3 conv,
and nothing is fused. Module and parameter names are the published
models' (``noise_level_mlp.1``, ``downs.1.res_block.block1.block.0``,
``mid.0.ca.fc1``, ``time_mlp.3``, ``downs.1.res_block.mlp.1``,
``mid.0.attn.qkv``, ...), so one state dict loads into these and into the
program's nets. Inputs and outputs are NHWC; inside, maps are NCHW views
of channels-last memory.

Dropout (``Block`` after the first of each ResnetBlock) draws its keep
mask in train mode from the generator passed to ``forward``, one
``bernoulli_`` per Block in forward order on a channels-last map, so a
generator seeded alike gives the masks that a net drawing the same way
gives. Every convolution and matmul goes through :func:`conv2d` /
:func:`linear`, which round their operands to the ``precision`` of
``precision.py`` (float32 unless a control asks for less).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import operand


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def positional_encoding(level: torch.Tensor, dim: int) -> torch.Tensor:
    """WaveGrad's sinusoid of a noise level or timestep: (B,) -> (B, dim)."""
    count = dim // 2
    step = torch.arange(count, dtype=level.dtype, device=level.device) / count
    enc = level[:, None] * torch.exp(-math.log(1e4) * step)[None, :]
    return torch.cat([torch.sin(enc), torch.cos(enc)], dim=-1)


def conv2d(x, weight, bias, precision, stride=1, padding=0):
    return F.conv2d(operand(x, precision), operand(weight, precision), bias,
                    stride=stride, padding=padding)


def linear(x, layer: nn.Linear, precision):
    return F.linear(operand(x, precision), operand(layer.weight, precision),
                    layer.bias)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as the NCHW view the nets work on."""
    return x.permute(0, 3, 1, 2)


class Block(nn.Module):
    """GroupNorm -> Swish -> Dropout -> 3x3 conv. ``block`` keeps the
    published indices: 0 the GroupNorm, 3 the conv."""

    def __init__(self, dim: int, dim_out: int, groups: int = 32,
                 dropout: float = 0.0):
        super().__init__()
        self.block = nn.Sequential(nn.GroupNorm(groups, dim), nn.Identity(),
                                   nn.Identity(),
                                   nn.Conv2d(dim, dim_out, 3, padding=1))
        self.p = float(dropout)

    def forward(self, x, precision, generator=None):
        gn, conv = self.block[0], self.block[3]
        h = swish(F.group_norm(x, gn.num_groups, gn.weight, gn.bias, gn.eps))
        if self.training and self.p > 0:
            b, c, hh, ww = h.shape
            keep = torch.empty((b, hh, ww, c), dtype=h.dtype,
                               device=h.device).permute(0, 3, 1, 2)
            keep.bernoulli_(1.0 - self.p, generator=generator)
            h = h * keep / (1.0 - self.p)
        return conv2d(h, conv.weight, conv.bias, precision, padding=1)


class Downsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, 2, 1)

    def forward(self, x, precision):
        return conv2d(x, self.conv.weight, self.conv.bias, precision,
                      stride=2, padding=1)


class Upsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x, precision):
        y = F.interpolate(x, scale_factor=2, mode="nearest")
        return conv2d(y, self.conv.weight, self.conv.bias, precision,
                      padding=1)


def skip_conv(x, res_conv, precision):
    if isinstance(res_conv, nn.Identity):
        return x
    return conv2d(x, res_conv.weight, res_conv.bias, precision)


def level_channels(inner: int, mults: Sequence[int], res_blocks: int):
    """The (dim_in, dim_out, resolution index) of every ResnetBlock of
    the down and up paths and the skip channels, as both UNets lay them
    out."""
    pre, feats, downs = inner, [inner], []
    for ind, m in enumerate(mults):
        for _ in range(res_blocks):
            downs.append(("res", pre, inner * m, ind))
            feats.append(inner * m)
            pre = inner * m
        if ind != len(mults) - 1:
            downs.append(("down", pre, pre, ind))
            feats.append(pre)
    mid = pre
    ups = []
    for ind in reversed(range(len(mults))):
        for _ in range(res_blocks + 1):
            ups.append(("res", pre + feats.pop(), inner * mults[ind], ind))
            pre = inner * mults[ind]
        if ind >= 1:
            ups.append(("up", pre, pre, ind))
    return downs, mid, ups, pre


# FastDiffSR


class FeatureWiseAffine(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.noise_func = nn.Sequential(nn.Linear(dim_in, dim_out))


class ResnetBlock(nn.Module):
    """block1 -> + Linear(noise embedding) -> block2 (dropout) -> + skip."""

    def __init__(self, dim, dim_out, emb_dim, dropout, groups):
        super().__init__()
        self.noise_func = FeatureWiseAffine(emb_dim, dim_out)
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups, dropout)
        self.res_conv = (nn.Conv2d(dim, dim_out, 1) if dim != dim_out
                         else nn.Identity())

    def forward(self, x, emb, precision, generator):
        h = self.block1(x, precision)
        h = h + linear(emb, self.noise_func.noise_func[0],
                       precision)[:, :, None, None]
        h = self.block2(h, precision, generator)
        return h + skip_conv(x, self.res_conv, precision)


class CLAM(nn.Module):
    """Channel gate: a shared 1x1 MLP over the average- and max-pooled
    channels, sigmoid."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // ratio, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // ratio, channels, 1, bias=False)

    def forward(self, x, precision):
        def mlp(v):
            h = F.relu(conv2d(v, self.fc1.weight, None, precision))
            return conv2d(h, self.fc2.weight, None, precision)
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)
        return torch.sigmoid(mlp(avg) + mlp(mx)) * x


class SLAM(nn.Module):
    """Spatial gate: a 7x7 conv over [channel mean, channel max], sigmoid."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                               bias=False)

    def forward(self, x, precision):
        s = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(conv2d(s, self.conv1.weight, None, precision,
                                    padding=self.conv1.padding)) * x


class ResnetBlocWithAttn(nn.Module):
    def __init__(self, dim, dim_out, emb_dim, dropout, groups,
                 with_attn=False):
        super().__init__()
        self.res_block = ResnetBlock(dim, dim_out, emb_dim, dropout, groups)
        if with_attn:
            self.ca = CLAM(dim_out)
            self.sa = SLAM()
        self.with_attn = with_attn

    def forward(self, x, emb, precision, generator):
        x = self.res_block(x, emb, precision, generator)
        if self.with_attn:
            x = self.sa(self.ca(x, precision), precision)
        return x


class FastDiffSRUNet(nn.Module):
    """Input (B,H,W,in_channel) = concat(bicubic LR, noisy residual);
    ``level`` (B,) the continuous noise level; output (B,H,W,out_channel)."""

    def __init__(self, in_channel=6, out_channel=3, inner_channel=64,
                 norm_groups=32, channel_mults=(1, 2, 4, 4), res_blocks=2,
                 dropout=0.2, precision="f32"):
        super().__init__()
        self.inner = inner_channel
        self.precision = precision
        self.noise_level_mlp = nn.Sequential(
            nn.Identity(), nn.Linear(inner_channel, inner_channel * 4),
            nn.Identity(), nn.Linear(inner_channel * 4, inner_channel))
        rb = dict(emb_dim=inner_channel, dropout=dropout, groups=norm_groups)
        downs_spec, mid, ups_spec, pre = level_channels(
            inner_channel, channel_mults, res_blocks)
        downs = [nn.Conv2d(in_channel, inner_channel, 3, padding=1)]
        for kind, ci, co, _ in downs_spec:
            downs.append(ResnetBlocWithAttn(ci, co, **rb) if kind == "res"
                         else Downsample(ci))
        self.downs = nn.ModuleList(downs)
        self.mid = nn.ModuleList([
            ResnetBlocWithAttn(mid, mid, with_attn=True, **rb),
            ResnetBlocWithAttn(mid, mid, **rb)])
        self.ups = nn.ModuleList([
            ResnetBlocWithAttn(ci, co, **rb) if kind == "res"
            else Upsample(ci) for kind, ci, co, _ in ups_spec])
        self.final_conv = Block(pre, out_channel, norm_groups)

    def forward(self, x, level, generator: Optional[torch.Generator] = None):
        p = self.precision
        mlp = self.noise_level_mlp
        emb = positional_encoding(level.float(), self.inner)
        emb = linear(swish(linear(emb, mlp[1], p)), mlp[3], p)
        stem = self.downs[0]
        x = conv2d(channels_last(x), stem.weight, stem.bias, p, padding=1)
        feats = [x]
        for layer in self.downs[1:]:
            x = (layer(x, p) if isinstance(layer, Downsample)
                 else layer(x, emb, p, generator))
            feats.append(x)
        for layer in self.mid:
            x = layer(x, emb, p, generator)
        for layer in self.ups:
            if isinstance(layer, Upsample):
                x = layer(x, p)
            else:
                x = layer(torch.cat([x, feats.pop()], dim=1), emb, p,
                          generator)
        return self.final_conv(x, p).permute(0, 2, 3, 1).contiguous()


# SR3 (ddpm)


class SR3ResnetBlock(nn.Module):
    """block1 -> + Linear(swish(t_emb)) -> block2 (dropout) -> + skip."""

    def __init__(self, dim, dim_out, emb_dim, dropout, groups):
        super().__init__()
        self.mlp = nn.Sequential(nn.Identity(), nn.Linear(emb_dim, dim_out))
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups, dropout)
        self.res_conv = (nn.Conv2d(dim, dim_out, 1) if dim != dim_out
                         else nn.Identity())

    def forward(self, x, emb, precision, generator):
        h = self.block1(x, precision)
        h = h + linear(swish(emb), self.mlp[1], precision)[:, :, None, None]
        h = self.block2(h, precision, generator)
        return h + skip_conv(x, self.res_conv, precision)


class SelfAttention(nn.Module):
    """Single-head self-attention over the H*W grid: GroupNorm, a 1x1 qkv
    without bias (channels q, k, v in turn), softmax(q k^T / sqrt(C)), a
    1x1 out, residual."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels)
        self.qkv = nn.Conv2d(channels, channels * 3, 1, bias=False)
        self.out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, precision):
        b, c, h, w = x.shape
        n = self.norm
        xn = F.group_norm(x, n.num_groups, n.weight, n.bias, n.eps)
        qkv = conv2d(xn, self.qkv.weight, None, precision)
        q, k, v = qkv.reshape(b, 3 * c, h * w).chunk(3, dim=1)  # (B, C, N)
        logits = torch.matmul(operand(q.transpose(1, 2), precision),
                              operand(k, precision)) / math.sqrt(c)
        attn = torch.softmax(logits, dim=-1)                   # (B, N, N)
        out = torch.matmul(operand(attn, precision),
                           operand(v.transpose(1, 2), precision))
        out = out.transpose(1, 2).reshape(b, c, h, w)
        return conv2d(out, self.out.weight, self.out.bias, precision) + x


class SR3BlockWithAttn(nn.Module):
    def __init__(self, dim, dim_out, emb_dim, dropout, groups,
                 with_attn=False):
        super().__init__()
        self.res_block = SR3ResnetBlock(dim, dim_out, emb_dim, dropout,
                                        groups)
        self.attn = SelfAttention(dim_out, groups) if with_attn else None

    def forward(self, x, emb, precision, generator):
        x = self.res_block(x, emb, precision, generator)
        return x if self.attn is None else self.attn(x, precision)


class SR3UNet(nn.Module):
    """Input (B,H,W,in_channel) = concat(bicubic LR, noisy HR); ``level``
    (B,) the timestep; output (B,H,W,out_channel)."""

    def __init__(self, in_channel=6, out_channel=3, inner_channel=64,
                 norm_groups=32, channel_mults=(1, 2, 4, 4), attn_res=(16,),
                 res_blocks=2, dropout=0.2, image_size=256, precision="f32"):
        super().__init__()
        self.inner = inner_channel
        self.precision = precision
        self.time_mlp = nn.Sequential(
            nn.Identity(), nn.Linear(inner_channel, inner_channel * 4),
            nn.Identity(), nn.Linear(inner_channel * 4, inner_channel))
        rb = dict(emb_dim=inner_channel, dropout=dropout, groups=norm_groups)
        downs_spec, mid, ups_spec, pre = level_channels(
            inner_channel, channel_mults, res_blocks)

        def attn_at(ind):
            return (image_size >> ind) in tuple(attn_res)

        downs = [nn.Conv2d(in_channel, inner_channel, 3, padding=1)]
        for kind, ci, co, ind in downs_spec:
            downs.append(SR3BlockWithAttn(ci, co, with_attn=attn_at(ind),
                                          **rb) if kind == "res"
                         else Downsample(ci))
        self.downs = nn.ModuleList(downs)
        self.mid = nn.ModuleList([
            SR3BlockWithAttn(mid, mid, with_attn=True, **rb),
            SR3BlockWithAttn(mid, mid, **rb)])
        self.ups = nn.ModuleList([
            SR3BlockWithAttn(ci, co, with_attn=attn_at(ind), **rb)
            if kind == "res" else Upsample(ci)
            for kind, ci, co, ind in ups_spec])
        self.final_conv = Block(pre, out_channel, norm_groups)

    def forward(self, x, level, generator: Optional[torch.Generator] = None):
        p = self.precision
        mlp = self.time_mlp
        emb = positional_encoding(level.float(), self.inner)
        emb = linear(swish(linear(emb, mlp[1], p)), mlp[3], p)
        stem = self.downs[0]
        x = conv2d(channels_last(x), stem.weight, stem.bias, p, padding=1)
        feats = [x]
        for layer in self.downs[1:]:
            x = (layer(x, p) if isinstance(layer, Downsample)
                 else layer(x, emb, p, generator))
            feats.append(x)
        for layer in self.mid:
            x = layer(x, emb, p, generator)
        for layer in self.ups:
            if isinstance(layer, Upsample):
                x = layer(x, p)
            else:
                x = layer(torch.cat([x, feats.pop()], dim=1), emb, p,
                          generator)
        return self.final_conv(x, p).permute(0, 2, 3, 1).contiguous()


def build_unet(model: dict, precision: str = "f32", device="cpu"):
    """The reference UNet of a configuration's ``model`` section, with
    uninitialised parameters (the benchmark loads its own)."""
    u = model["unet"]
    kw = dict(in_channel=u["in_channel"], out_channel=u["out_channel"],
              inner_channel=u["inner_channel"],
              norm_groups=u.get("norm_groups") or 32,
              channel_mults=tuple(u["channel_multiplier"]),
              res_blocks=u["res_blocks"], dropout=u["dropout"],
              precision=precision)
    variant = model["which_model_G"]
    with torch.device(device):
        if variant == "fastdiffsr":
            net = FastDiffSRUNet(**kw)
        elif variant == "ddpm":
            net = SR3UNet(attn_res=tuple(u["attn_res"]),
                          image_size=int(model["diffusion"]["image_size"]),
                          **kw)
        else:
            raise ValueError(f"no reference for which_model_G={variant!r}")
    return net.eval()
