"""HAT (Hybrid Attention Transformer): counterpart of
``fastdiffsr_tpu/msi/hat.py`` (reference MSI_SR_model/model/hat.py).

- HAB: window attention with a relative-position bias (shifted on odd
  blocks) plus a parallel CAB branch (conv -> GELU -> conv -> channel
  attention, squeeze 30) scaled by ``conv_scale`` 0.01, then the MLP;
- OCAB: overlapping cross attention. Queries from ws×ws windows, keys
  and values from ows×ows windows (ows = ws·(1 + overlap)) at stride ws
  over a zero pad of (ows - ws)/2, built with ``F.unfold``; its own
  ((ws + ows - 1)^2, heads) bias table;
- RHAG: HABs -> OCAB -> conv3x3, + skip;
- HAT: conv_first -> RHAGs -> LayerNorm -> conv + skip -> pixelshuffle.
  Defaults: embed 180, depths (6,)*6, heads 6, window 16, compress 3,
  squeeze 30, overlap 0.5, mlp_ratio 4, ×4.

The module names are the reference's state-dict keys
(``layers.{i}.residual_group.{blocks.{j},overlap_attn}``,
``conv_block.cab.{0,2,3.attention.{1,3}}``, ``upsample.upsampling.{2k}``).
NHWC in [0, 1] at the boundary; the input is reflect-padded to a window
multiple and the output cropped back.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .swinir import (DIV2K_RGB_MEAN, Mlp, PatchEmbed, WindowAttention,
                     pixelshuffle_upsampler, reflect_pad_to, shifted_windows,
                     to_map, tokens, window_masks, window_partition,
                     window_reverse)


def rpi_oca(ws: int, ows: int) -> np.ndarray:
    """(ws*ws, ows*ows) index into the OCA bias table (reference
    calculate_rpi_oca)."""
    co = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                              indexing="ij")).reshape(2, -1)
    ce = np.stack(np.meshgrid(np.arange(ows), np.arange(ows),
                              indexing="ij")).reshape(2, -1)
    rel = (ce[:, None, :] - co[:, :, None]).transpose(1, 2, 0)
    rel = rel + (ws - ows + 1)
    rel[:, :, 0] *= ws + ows - 1
    return rel.sum(-1)


class ChannelAttention(nn.Module):
    def __init__(self, num_feat: int, squeeze_factor: int):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(num_feat, num_feat // squeeze_factor, 1),
            nn.ReLU(),
            nn.Conv2d(num_feat // squeeze_factor, num_feat, 1),
            nn.Sigmoid())

    def forward(self, x):
        return x * self.attention(x)


class CAB(nn.Module):
    def __init__(self, num_feat: int, compress_ratio: int = 3,
                 squeeze_factor: int = 30):
        super().__init__()
        self.cab = nn.Sequential(
            nn.Conv2d(num_feat, num_feat // compress_ratio, 3, padding=1),
            nn.GELU(),
            nn.Conv2d(num_feat // compress_ratio, num_feat, 3, padding=1),
            ChannelAttention(num_feat, squeeze_factor))

    def forward(self, x):
        return self.cab(x)


class HAB(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift_size,
                 compress_ratio=3, squeeze_factor=30, conv_scale=0.01,
                 mlp_ratio=4.0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.conv_scale = conv_scale
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.conv_block = CAB(dim, compress_ratio, squeeze_factor)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, x_size, masks):
        h, wd = x_size
        b, n, c = x.shape
        w = min(self.window_size, h, wd)
        shift = self.shift_size if min(h, wd) > self.window_size else 0
        xn = self.norm1(x).reshape(b, h, wd, c)
        conv_x = tokens(self.conv_block(xn.permute(0, 3, 1, 2)))
        xs = shifted_windows(self.attn, xn, w, shift,
                             masks.get((w, shift)) if shift else None)
        x = x + xs + conv_x * self.conv_scale
        return x + self.mlp(self.norm2(x))


class OCAB(nn.Module):
    def __init__(self, dim, window_size, overlap_ratio, num_heads,
                 mlp_ratio=2.0):
        super().__init__()
        ws = window_size
        self.ws = ws
        self.ows = int(ws * overlap_ratio) + ws
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((ws + self.ows - 1) ** 2, num_heads))
        self.register_buffer("rpi", torch.from_numpy(rpi_oca(ws, self.ows)),
                             persistent=False)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, x_size):
        h, wd = x_size
        b, n, c = x.shape
        ws, ows, heads = self.ws, self.ows, self.num_heads
        hd = c // heads
        qkv = self.qkv(self.norm1(x)).reshape(b, h, wd, 3 * c)
        q = window_partition(qkv[..., :c], ws).reshape(-1, ws * ws, c)
        # k and v windows: ows×ows at stride ws over the zero-padded map,
        # in the row-major window order of window_partition
        kv = F.unfold(qkv[..., c:].permute(0, 3, 1, 2), kernel_size=ows,
                      stride=ws, padding=(ows - ws) // 2)
        kv = kv.reshape(b, 2 * c, ows * ows, -1).permute(0, 3, 2, 1)
        kv = kv.reshape(-1, ows * ows, 2 * c)
        b_ = q.shape[0]
        qh = q.reshape(b_, ws * ws, heads, hd).transpose(1, 2)
        kh = kv[..., :c].reshape(b_, ows * ows, heads, hd).transpose(1, 2)
        vh = kv[..., c:].reshape(b_, ows * ows, heads, hd).transpose(1, 2)
        attn = (qh * hd ** -0.5) @ kh.transpose(-2, -1)
        bias = self.relative_position_bias_table[self.rpi.reshape(-1)]
        attn = attn + bias.reshape(ws * ws, ows * ows, heads).permute(
            2, 0, 1)[None]
        out = (attn.softmax(dim=-1) @ vh).transpose(1, 2).reshape(
            b_, ws * ws, c)
        out = window_reverse(out.reshape(-1, ws, ws, c), ws, h, wd)
        x = self.proj(out.reshape(b, n, c)) + x
        return x + self.mlp(self.norm2(x))


class AttenBlocks(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, compress_ratio,
                 squeeze_factor, conv_scale, overlap_ratio, mlp_ratio):
        super().__init__()
        self.blocks = nn.ModuleList(
            HAB(dim, num_heads, window_size,
                0 if i % 2 == 0 else window_size // 2, compress_ratio,
                squeeze_factor, conv_scale, mlp_ratio)
            for i in range(depth))
        self.overlap_attn = OCAB(dim, window_size, overlap_ratio, num_heads,
                                 mlp_ratio)


class RHAG(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, compress_ratio=3,
                 squeeze_factor=30, conv_scale=0.01, overlap_ratio=0.5,
                 mlp_ratio=4.0):
        super().__init__()
        self.residual_group = AttenBlocks(
            dim, depth, num_heads, window_size, compress_ratio,
            squeeze_factor, conv_scale, overlap_ratio, mlp_ratio)
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x, x_size, masks):
        res = x
        for blk in self.residual_group.blocks:
            x = blk(x, x_size, masks)
        x = self.residual_group.overlap_attn(x, x_size)
        return tokens(self.conv(to_map(x, x_size))) + res


class Upsample(nn.Module):
    def __init__(self, scale: int, num_feat: int):
        super().__init__()
        self.upsampling = pixelshuffle_upsampler(scale, num_feat)

    def forward(self, x):
        return self.upsampling(x)


class HAT(nn.Module):
    def __init__(self, upscale: int = 4, in_chans: int = 3,
                 embed_dim: int = 180, depths: Sequence[int] = (6,) * 6,
                 num_heads: Sequence[int] = (6,) * 6, window_size: int = 16,
                 compress_ratio: int = 3, squeeze_factor: int = 30,
                 conv_scale: float = 0.01, overlap_ratio: float = 0.5,
                 mlp_ratio: float = 4.0, img_range: float = 1.0,
                 num_feat: int = 64):
        super().__init__()
        self.upscale = upscale
        self.window_size = window_size
        self.img_range = img_range
        self.register_buffer("mean", torch.tensor(DIV2K_RGB_MEAN),
                             persistent=False)
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, padding=1)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            RHAG(embed_dim, d, hds, window_size, compress_ratio,
                 squeeze_factor, conv_scale, overlap_ratio, mlp_ratio)
            for d, hds in zip(depths, num_heads))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, padding=1)
        self.conv_before_upsample = nn.Sequential(
            nn.Conv2d(embed_dim, num_feat, 3, padding=1),
            nn.LeakyReLU(0.01))
        self.upsample = Upsample(upscale, num_feat)
        self.conv_last = nn.Conv2d(num_feat, in_chans, 3, padding=1)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """(B,H,W,3) in [0, 1] -> (B, H*scale, W*scale, 3); HAT draws
        nothing (``generator`` is accepted for the trainer's one call)."""
        _, h0, w0, _ = x.shape
        x = reflect_pad_to(x.permute(0, 3, 1, 2), self.window_size)
        x = (x - self.mean[:, None, None]) * self.img_range
        size = (x.shape[2], x.shape[3])
        masks = window_masks(*size, self.window_size, x.device)
        feat = self.conv_first(x)
        seq = self.patch_embed.norm(tokens(feat))
        for layer in self.layers:
            seq = layer(seq, size, masks)
        x = self.conv_after_body(to_map(self.norm(seq), size)) + feat
        x = self.conv_last(self.upsample(self.conv_before_upsample(x)))
        x = x.permute(0, 2, 3, 1) / self.img_range + self.mean
        return x[:, :h0 * self.upscale, :w0 * self.upscale, :]
