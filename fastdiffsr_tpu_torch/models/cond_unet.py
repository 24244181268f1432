"""ConditionalUNet, EDiffSR's second denoiser (plain PyTorch forward).

Counterpart of ``fastdiffsr_tpu/models/cond_unet.py`` (reference
EDiffSR/codes/config/sisr/models/modules/DenoisingUNet_arch.py:19-135
and module_util.py):

- input cat([x - cond, cond]) -> 7x7 conv (no bias), reflect-padded to a
  multiple of 2^depth;
- per encoder level two scale-shift ResBlocks (SiLU; the time scale and
  shift from sinusoidal embedding -> Linear -> GELU -> Linear), a
  residual pre-norm LinearAttention (softmax over the head dim for q and
  over the tokens for k), then a 4x4 stride-2 conv (a 3x3 conv at the
  last level);
- middle: ResBlock, LinearAttention, ResBlock;
- decoder levels with two skip concats each and a nearest x2 + 3x3 conv
  Upsample (a 3x3 conv at level 0); a final concat with the stem, a
  ResBlock and a 3x3 conv.

Module and parameter names are the reference's (``init_conv``,
``time_mlp.{1,3}``, ``downs.i.{0,1}`` ResBlocks with ``mlp.1``,
``block{1,2}.proj``, ``res_conv``; ``downs.i.2.fn.norm.g``,
``downs.i.2.fn.fn.{to_qkv, to_out.0, to_out.1.g}``; ``downs.i.3``;
``ups.k`` for level depth-1-k with the Upsample conv at ``ups.k.3.1``;
``mid_block{1,2}``, ``mid_attn``, ``final_res_block``, ``final_conv``).
``models/convert.py::flax_cond_unet_params_to_torch`` maps the JAX
package's tree onto them.

NHWC in and out, NCHW inside; ``dtype`` is the compute type of the convs
and linears (float32 parameters); the attention's two einsums run in
float32. Only the literal nearest x2 + 3x3 conv Upsample is ported: the
JAX package's ``tconv``/``d2s2`` forms of it (its default through
``default_upsample_mode``) compute the same function.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nafnet import (UNPORTED, LayerNorm2d, SinusoidalPosEmb,
                     sinusoidal_pos_emb)
from .unet_fastdiffsr import _conv, _linear, init_params


def default_conv(dim_in: int, dim_out: int, kernel_size: int = 3,
                 bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(dim_in, dim_out, kernel_size,
                     padding=kernel_size // 2, bias=bias)


class Block(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = default_conv(dim_in, dim_out)


class ResBlock(nn.Module):
    """proj -> x*(scale+1)+shift -> SiLU -> proj -> SiLU, plus a 1x1
    skip where the channel count changes."""

    def __init__(self, dim_in: int, dim_out: int, time_emb_dim: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.SiLU(),
                                 nn.Linear(time_emb_dim, dim_out * 2))
        self.block1 = Block(dim_in, dim_out)
        self.block2 = Block(dim_out, dim_out)
        self.res_conv = (default_conv(dim_in, dim_out, 1)
                         if dim_in != dim_out else nn.Identity())

    def forward(self, x, t_emb, dtype=torch.float32):
        te = _linear(F.silu(t_emb), self.mlp[1], dtype)
        scale, shift = te[:, :, None, None].chunk(2, dim=1)
        h = _conv(x, self.block1.proj, dtype)
        h = F.silu(h * (scale + 1) + shift)
        h = F.silu(_conv(h, self.block2.proj, dtype))
        if isinstance(self.res_conv, nn.Conv2d):
            x = _conv(x, self.res_conv, dtype)
        return h + x


class LinearAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv2d(hidden, dim, 1),
                                    LayerNorm2d(dim))

    def forward(self, x, dtype=torch.float32):
        b, _, h, w = x.shape
        n = h * w
        qkv = _conv(x, self.to_qkv, dtype).reshape(b, 3, self.heads,
                                                   self.dim_head, n)
        q = torch.softmax(qkv[:, 0], dim=2) * (self.dim_head ** -0.5)
        k = torch.softmax(qkv[:, 1], dim=3)
        v = qkv[:, 2] / n
        context = torch.einsum("bhdn,bhen->bhde", k.float(), v.float())
        out = torch.einsum("bhde,bhdn->bhen", context, q.float())
        out = out.reshape(b, self.heads * self.dim_head, h, w).to(dtype)
        return self.to_out[1](_conv(out, self.to_out[0], dtype))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = LayerNorm2d(dim)

    def forward(self, x, dtype=torch.float32):
        return self.fn(self.norm(x), dtype)


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, dtype=torch.float32):
        return self.fn(x, dtype) + x


def _attention(dim: int) -> Residual:
    return Residual(PreNorm(dim, LinearAttention(dim)))


class ConditionalUNet(nn.Module):
    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 depth: int = 4, upscale: int = 1, dtype=torch.float32,
                 upsample_mode: str = ""):
        super().__init__()
        if upsample_mode:
            raise NotImplementedError(
                f"ConditionalUNet upsample_mode={upsample_mode!r} is "
                f"{UNPORTED}; '' (nearest x2 + conv) is the same function")
        self.nf, self.depth, self.dtype = nf, depth, dtype
        self.upscale = upscale           # accepted, unused (reference too)
        time_dim = nf * 4
        self.init_conv = default_conv(in_nc * 2, nf, 7)
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(nf), nn.Linear(nf, time_dim), nn.GELU(),
            nn.Linear(time_dim, time_dim))
        self.downs = nn.ModuleList()
        self.ups = nn.ModuleList()
        for i in range(depth):
            dim_in, dim_out = nf * 2 ** i, nf * 2 ** (i + 1)
            self.downs.append(nn.ModuleList([
                ResBlock(dim_in, dim_in, time_dim),
                ResBlock(dim_in, dim_in, time_dim),
                _attention(dim_in),
                (nn.Conv2d(dim_in, dim_out, 4, stride=2, padding=1)
                 if i != depth - 1 else default_conv(dim_in, dim_out))]))
            self.ups.insert(0, nn.ModuleList([
                ResBlock(dim_out + dim_in, dim_out, time_dim),
                ResBlock(dim_out + dim_in, dim_out, time_dim),
                _attention(dim_out),
                (nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"),
                               nn.Conv2d(dim_out, dim_in, 3, padding=1))
                 if i != 0 else default_conv(dim_out, dim_in))]))
        mid = nf * 2 ** depth
        self.mid_block1 = ResBlock(mid, mid, time_dim)
        self.mid_attn = _attention(mid)
        self.mid_block2 = ResBlock(mid, mid, time_dim)
        self.final_res_block = ResBlock(nf * 2, nf, time_dim)
        self.final_conv = nn.Conv2d(nf, out_nc, 3, padding=1)

    def forward(self, xt: torch.Tensor, cond: torch.Tensor,
                time: torch.Tensor) -> torch.Tensor:
        """(B,H,W,C) noisy state and condition, (B,) or scalar times ->
        (B,H,W,C) float32 predicted noise."""
        dt = self.dtype
        if time.ndim == 0:
            time = time[None]
        t = _linear(sinusoidal_pos_emb(time, self.nf), self.time_mlp[1], dt)
        t = _linear(F.gelu(t), self.time_mlp[3], dt)

        x = torch.cat([xt - cond, cond], dim=-1).to(dt).permute(0, 3, 1, 2)
        H, W = x.shape[2], x.shape[3]
        s = 2 ** self.depth
        ph, pw = (s - H % s) % s, (s - W % s) % s
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        x = _conv(x, self.init_conv, dt)
        stem = x

        skips = []
        for b1, b2, attn, down in self.downs:
            x = b1(x, t, dt)
            skips.append(x)
            x = attn(b2(x, t, dt), dt)
            skips.append(x)
            x = _conv(x, down, dt)

        x = self.mid_block1(x, t, dt)
        x = self.mid_attn(x, dt)
        x = self.mid_block2(x, t, dt)

        for b1, b2, attn, up in self.ups:
            x = b1(torch.cat([x, skips.pop()], dim=1), t, dt)
            x = b2(torch.cat([x, skips.pop()], dim=1), t, dt)
            x = attn(x, dt)
            if isinstance(up, nn.Sequential):
                x = _conv(F.interpolate(x, scale_factor=2, mode="nearest"),
                          up[1], dt)
            else:
                x = _conv(x, up, dt)

        x = self.final_res_block(torch.cat([x, stem], dim=1), t, dt)
        x = _conv(x, self.final_conv, dt)
        return x[:, :, :H, :W].permute(0, 2, 3, 1).float()


def cond_unet_from_config(setting: dict, dtype=torch.float32, device="cuda",
                          seed: int = 0) -> ConditionalUNet:
    """Build from EDiffSR YAML network settings (``in_nc``, ``out_nc``,
    ``nf``, ``depth``), with seeded Flax-style initial parameters, on
    ``device``."""
    from ..device import resolve_device
    dev = resolve_device(device)
    net = ConditionalUNet(in_nc=setting.get("in_nc", 3),
                          out_nc=setting.get("out_nc", 3),
                          nf=setting.get("nf", 64),
                          depth=setting.get("depth", 4), dtype=dtype)
    return init_params(net, seed).to(dev)
