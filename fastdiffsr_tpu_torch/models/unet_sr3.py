"""SR3 denoiser UNet of the ddpm and tesr variants (plain PyTorch forward).

Counterpart of ``fastdiffsr_tpu/models/unet_sr3.py`` and of the
reference model/ddpm_modules/unet.py:147-243 (tesr's UNet,
tesr_modules/unet.py:168-266, is the same topology driven by a
continuous noise level). Against the FastDiffSR UNet:

- the time MLP is named ``time_mlp`` and each ResnetBlock adds
  ``Linear(swish(t_emb))`` per channel between its two Blocks;
- a single-head SelfAttention (GroupNorm -> 1x1 qkv without bias ->
  softmax(QK^T / sqrt(C)) -> 1x1 out, residual) follows every ResnetBlock
  whose running resolution is in ``attn_res``, and the first mid block;
- there is no CLAM/SLAM gate.

Module and parameter names are the reference's (``time_mlp.{1,3}``,
``downs.i.res_block.mlp.1``, ``downs.i.attn.{norm,qkv,out}``, ...), which
``fastdiffsr_tpu/models/convert.py::torch_unet_to_flax`` reads;
``models/convert.py::flax_sr3_params_to_torch`` maps the Flax tree onto
them.

Every ``Block`` is the FastDiffSR UNet's: its GroupNorm -> Swish is
kernel K1 through ``gn_swish_custom``, and its train-mode dropout draws
from the ``generator`` passed to ``forward``. The attention is plain
PyTorch: its two matmuls run in float32 on ``dtype``-rounded operands
(as JAX's ``preferred_element_type=float32``) with a float32 softmax.
Maps stay channels-last NCHW views of NHWC memory, as K1 needs. Only the
literal nearest x2 + 3x3 conv Upsample is ported (``upsample_mode ''``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .unet_fastdiffsr import (Block, Downsample, PositionalEncoding, Swish,
                              Upsample, _conv, _linear, init_params,
                              positional_encoding, swish)


def refuse_upsample_mode(mode: str) -> None:
    if mode:
        raise NotImplementedError(
            f"upsample_mode={mode!r}: only the literal nearest x2 + conv "
            "Upsample ('') is ported (tconv/d2s2: ROADMAP.md queue 5, "
            "opt-in ops)")


class SR3ResnetBlock(nn.Module):
    """block1 -> + Linear(swish(t_emb)) -> block2, plus a 1x1 (or
    identity) skip (reference ddpm unet.py:78-96)."""

    def __init__(self, dim: int, dim_out: int,
                 time_emb_dim: Optional[int] = None, dropout: float = 0.0,
                 norm_groups: int = 32):
        super().__init__()
        self.mlp = (nn.Sequential(Swish(), nn.Linear(time_emb_dim, dim_out))
                    if time_emb_dim else None)
        self.block1 = Block(dim, dim_out, groups=norm_groups)
        self.block2 = Block(dim_out, dim_out, groups=norm_groups,
                            dropout=dropout)
        self.res_conv = (nn.Conv2d(dim, dim_out, 1) if dim != dim_out
                         else nn.Identity())

    def forward(self, x, t_emb, dtype, generator=None):
        h = self.block1(x, dtype)
        if self.mlp is not None and t_emb is not None:
            h = h + _linear(swish(t_emb), self.mlp[1], dtype)[:, :, None,
                                                              None]
        h = self.block2(h, dtype, generator)
        skip = (x if isinstance(self.res_conv, nn.Identity)
                else _conv(x, self.res_conv, dtype))
        return h + skip


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dtype,
           divisor: float = 1.0) -> torch.Tensor:
    """softmax(q k^T / divisor) v over (B, heads, tokens, dim) operands:
    both matmuls in float32 on the ``dtype``-rounded values, the softmax
    in float32, the weights rounded to ``dtype``; output in ``dtype``."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if divisor != 1.0:
        logits = logits / divisor
    wts = torch.softmax(logits, dim=-1).to(dtype)
    return torch.matmul(wts.float(), v.float()).to(dtype)


def pointwise(t: torch.Tensor, layer: nn.Module, dtype) -> torch.Tensor:
    """A 1x1 conv layer (Conv1d or Conv2d) applied to (B, N, C) tokens,
    in ``dtype``."""
    w = layer.weight.reshape(layer.weight.shape[0], -1).to(dtype)
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(t.to(dtype), w, b)


def tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) view -> (B, H*W, C) tokens."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def from_tokens(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H*W, C) tokens -> (B, C, H, W) channels-last view."""
    return t.reshape(t.shape[0], h, w, t.shape[2]).permute(0, 3, 1, 2)


class SelfAttention(nn.Module):
    """Full self-attention over the H*W grid, scale 1/sqrt(C)
    (reference ddpm unet.py:99-128)."""

    def __init__(self, in_channel: int, n_head: int = 1,
                 norm_groups: int = 32):
        super().__init__()
        self.n_head = n_head
        self.norm = nn.GroupNorm(norm_groups, in_channel)
        self.qkv = nn.Conv2d(in_channel, in_channel * 3, 1, bias=False)
        self.out = nn.Conv2d(in_channel, in_channel, 1)

    def forward(self, x, dtype):
        b, c, h, w = x.shape
        heads, hd = self.n_head, c // self.n_head
        n = self.norm
        xn = F.group_norm(x.float(), n.num_groups, n.weight, n.bias, n.eps)
        qkv = pointwise(tokens(xn), self.qkv, dtype)
        q, k, v = qkv.reshape(b, h * w, heads, 3, hd).permute(3, 0, 2, 1, 4)
        out = attend(q, k, v, dtype, math.sqrt(c))
        out = pointwise(out.permute(0, 2, 1, 3).reshape(b, h * w, c),
                        self.out, dtype)
        return from_tokens(out, h, w) + x


class SR3BlockWithAttn(nn.Module):
    def __init__(self, dim, dim_out, *, time_emb_dim, norm_groups,
                 dropout=0.0, with_attn=False):
        super().__init__()
        self.res_block = SR3ResnetBlock(dim, dim_out, time_emb_dim,
                                        dropout=dropout,
                                        norm_groups=norm_groups)
        self.attn = (SelfAttention(dim_out, norm_groups=norm_groups)
                     if with_attn else None)

    def forward(self, x, t_emb, dtype, generator=None):
        x = self.res_block(x, t_emb, dtype, generator)
        if self.attn is not None:
            x = self.attn(x, dtype)
        return x


class SR3UNet(nn.Module):
    """The ddpm/tesr UNet (reference ddpm unet.py:147-243). ``time``:
    discrete t for ddpm, continuous gamma for tesr, both through the
    same sinusoid. Input x: (B,H,W,in_channel) NHWC; output
    (B,H,W,out_channel) float32."""

    def __init__(self, in_channel: int = 6, out_channel: int = 3,
                 inner_channel: int = 32, norm_groups: int = 32,
                 channel_mults: Sequence[int] = (1, 2, 4, 8, 8),
                 attn_res: Sequence[int] = (8,), res_blocks: int = 3,
                 dropout: float = 0.0, with_time_emb: bool = True,
                 image_size: int = 128, dtype=torch.float32,
                 upsample_mode: str = ""):
        super().__init__()
        refuse_upsample_mode(upsample_mode)
        self.in_channel = in_channel
        self.inner_channel = inner_channel
        self.dtype = dtype
        time_dim = inner_channel if with_time_emb else None
        self.time_mlp = (nn.Sequential(
            PositionalEncoding(inner_channel),
            nn.Linear(inner_channel, inner_channel * 4), Swish(),
            nn.Linear(inner_channel * 4, inner_channel))
            if with_time_emb else None)
        rb = dict(time_emb_dim=time_dim, norm_groups=norm_groups,
                  dropout=dropout)

        num_mults = len(channel_mults)
        now_res = image_size
        pre = inner_channel
        feat_channels = [pre]
        downs = [nn.Conv2d(in_channel, inner_channel, 3, padding=1)]
        for ind in range(num_mults):
            use_attn = now_res in tuple(attn_res)
            ch = inner_channel * channel_mults[ind]
            for _ in range(res_blocks):
                downs.append(SR3BlockWithAttn(pre, ch, with_attn=use_attn,
                                              **rb))
                feat_channels.append(ch)
                pre = ch
            if ind != num_mults - 1:
                downs.append(Downsample(pre))
                feat_channels.append(pre)
                now_res //= 2
        self.downs = nn.ModuleList(downs)
        self.mid = nn.ModuleList([
            SR3BlockWithAttn(pre, pre, with_attn=True, **rb),
            SR3BlockWithAttn(pre, pre, with_attn=False, **rb)])
        ups = []
        for ind in reversed(range(num_mults)):
            use_attn = now_res in tuple(attn_res)
            ch = inner_channel * channel_mults[ind]
            for _ in range(res_blocks + 1):
                ups.append(SR3BlockWithAttn(pre + feat_channels.pop(), ch,
                                            with_attn=use_attn, **rb))
                pre = ch
            if ind >= 1:
                ups.append(Upsample(pre))
                now_res *= 2
        self.ups = nn.ModuleList(ups)
        self.final_conv = Block(pre, out_channel, groups=norm_groups)

    def time_embedding(self, time: torch.Tensor) -> Optional[torch.Tensor]:
        if self.time_mlp is None:
            return None
        mlp = self.time_mlp
        t = positional_encoding(time.float(), self.inner_channel)
        t = swish(_linear(t, mlp[1], self.dtype))
        return _linear(t, mlp[3], self.dtype)

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in train mode."""
        dt = self.dtype
        if time.dim() == 2:
            time = time[:, 0]
        t = self.time_embedding(time)
        x = x.permute(0, 3, 1, 2).to(dt)

        feats = []
        for layer in self.downs:
            if isinstance(layer, SR3BlockWithAttn):
                x = layer(x, t, dt, generator)
            elif isinstance(layer, Downsample):
                x = layer(x, dt)
            else:
                x = _conv(x, layer, dt)
            feats.append(x)
        for layer in self.mid:
            x = layer(x, t, dt, generator)
        for layer in self.ups:
            if isinstance(layer, SR3BlockWithAttn):
                x = layer(torch.cat([x, feats.pop()], dim=1), t, dt,
                          generator)
            else:
                x = layer(x, dt)
        out = self.final_conv(x, dt)
        return out.float().permute(0, 2, 3, 1).contiguous()


def sr3_unet_from_config(unet_opt: dict, image_size: int = 128,
                         dtype=torch.float32, device="cuda",
                         seed: int = 0) -> SR3UNet:
    """Build from a reference-schema ``model.unet`` config dict, with
    seeded initial parameters (Flax's defaults), in eval mode on
    ``device``."""
    from ..device import resolve_device
    dev = resolve_device(device)
    net = SR3UNet(
        in_channel=unet_opt.get("in_channel", 6),
        out_channel=unet_opt.get("out_channel", 3),
        inner_channel=unet_opt.get("inner_channel", 32),
        norm_groups=unet_opt.get("norm_groups") or 32,
        channel_mults=tuple(unet_opt.get("channel_multiplier",
                                         (1, 2, 4, 8, 8))),
        attn_res=tuple(unet_opt.get("attn_res", (8,))),
        res_blocks=unet_opt.get("res_blocks", 3),
        dropout=unet_opt.get("dropout", 0.0),
        image_size=image_size,
        dtype=dtype)
    return init_params(net, seed).to(dev).eval()
