"""SwinIR, the flagship classical MSI baseline: counterpart of
``fastdiffsr_tpu/msi/swinir.py`` (reference MSI_SR_model/model/swinir.py:
548-753, GeneratorResNet with the pixelshuffle upsampler).

Shallow conv -> RSTB stack (Swin blocks: window attention with a
relative-position bias, shifted windows on odd blocks with a -100 mask
between regions) -> LayerNorm -> conv + skip -> pixelshuffle upsampler ->
conv. Defaults are the trainer's (swinir.py:828-836): embed 180, depths
(6,)*6, heads 6, window 8, mlp_ratio 2, ×4, DIV2K rgb mean shift,
drop-path rate 0.1 (linear over the blocks).

The module names are the reference's state-dict keys
(``conv_first``, ``patch_embed.norm``, ``layers.{i}.residual_group.
blocks.{j}.{norm1,attn.qkv,...}``, ``conv_before_upsample.0``,
``upsample.{2k}``), which ``models/convert.py::flax_swinir_params_to_torch``
and the JAX package's ``torch_swinir_to_flax`` map to the Flax tree. The
``relative_position_index`` buffers are not saved (the reference saves
them, and ``attn_mask`` and ``mean``; ``load_reference_msi_pth`` drops
them).

Input and output are NHWC in [0, 1]: the input is reflect-padded to a
window multiple, the output cropped back to ``scale`` × the input. The
convolutions run in NCHW, the transformer blocks on (B, H·W, C) tokens.
The shift mask is built on the device for the padded size of each
forward; no shift when ``min(h, w) <= window``, as in JAX. Drop-path
masks (training only) come from the ``generator`` the caller passes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

DIV2K_RGB_MEAN = (0.4488, 0.4371, 0.4040)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B,H,W,C) -> (B*nH*nW, w, w, C)."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int,
                   wd: int) -> torch.Tensor:
    b = windows.shape[0] // (h * wd // w // w)
    x = windows.reshape(b, h // w, wd // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wd, -1)


def relative_position_index(w: int) -> np.ndarray:
    """(w*w, w*w) index into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def shift_attn_mask(h: int, wd: int, w: int, shift: int,
                    device=None) -> torch.Tensor:
    """(num_windows, w*w, w*w) additive mask, -100 between pixels of
    different shift regions (reference SwinTransformerBlock.calculate_mask)."""
    img = torch.zeros((1, h, wd, 1), device=device)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = window_partition(img, w).reshape(-1, w * w)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def drop_path(res: torch.Tensor, p: float, training: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth of a residual branch (B, N, C): kept
    with probability 1 - p and scaled by 1 / (1 - p)."""
    if p == 0.0 or not training:
        return res
    if generator is None:
        raise ValueError("drop-path in training draws its masks from an "
                         "explicit generator; pass generator=")
    keep = 1.0 - p
    mask = torch.rand((res.shape[0], 1, 1), generator=generator,
                      device=res.device) < keep
    return res * mask.to(res.dtype) / keep


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size)),
            persistent=False)
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        """Attention within windows (B_, n, C) with the bias table and an
        optional per-window additive mask (num_windows, n, n)."""
        b_, n, c = x.shape
        heads = self.num_heads
        hd = c // heads
        q, k, v = self.qkv(x).reshape(b_, n, 3, heads, hd).permute(
            2, 0, 3, 1, 4)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(n, n, heads).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b_ // nw, nw, heads, n, n)
                    + mask[None, :, None]).reshape(-1, heads, n, n)
        out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def shifted_windows(fn, xn, w, shift, mask):
    """Apply ``fn(windows, mask)`` to the (B,H,W,C) map ``xn`` cut into
    w×w windows, cyclically shifted by ``shift`` first (and back after)."""
    b, h, wd, c = xn.shape
    if shift > 0:
        xn = torch.roll(xn, (-shift, -shift), dims=(1, 2))
    wins = window_partition(xn, w).reshape(-1, w * w, c)
    out = window_reverse(fn(wins, mask).reshape(-1, w, w, c), w, h, wd)
    if shift > 0:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out.reshape(b, h * wd, c)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 8,
                 shift_size: int = 0, mlp_ratio: float = 2.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, x_size, masks: dict, generator=None):
        h, wd = x_size
        b, n, c = x.shape
        w = min(self.window_size, h, wd)
        shift = self.shift_size if w == self.window_size else 0
        if min(h, wd) <= self.window_size:
            shift = 0
        mask = masks.get((w, shift)) if shift else None
        xs = shifted_windows(self.attn, self.norm1(x).reshape(b, h, wd, c),
                             w, shift, mask)
        x = x + drop_path(xs, self.drop_path, self.training, generator)
        res = self.mlp(self.norm2(x))
        return x + drop_path(res, self.drop_path, self.training, generator)


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio,
                 drop_paths: Sequence[float]):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, num_heads, window_size,
                                 0 if i % 2 == 0 else window_size // 2,
                                 mlp_ratio, drop_paths[i])
            for i in range(depth))


class RSTB(nn.Module):
    """Residual Swin transformer block: Swin blocks -> conv3x3, + skip."""

    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio,
                 drop_paths: Sequence[float]):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, num_heads, window_size,
                                         mlp_ratio, drop_paths)
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x, x_size, masks, generator=None):
        res = x
        for blk in self.residual_group.blocks:
            x = blk(x, x_size, masks, generator)
        return tokens(self.conv(to_map(x, x_size))) + res


class PatchEmbed(nn.Module):
    """Holds the LayerNorm on the first tokens (the reference's
    PatchEmbed with patch size 1)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)


def tokens(x: torch.Tensor) -> torch.Tensor:
    """(B,C,H,W) -> (B,H*W,C)."""
    return x.flatten(2).transpose(1, 2)


def to_map(x: torch.Tensor, x_size) -> torch.Tensor:
    """(B,H*W,C) -> (B,C,H,W)."""
    b, _, c = x.shape
    return x.transpose(1, 2).reshape(b, c, x_size[0], x_size[1])


def pixelshuffle_upsampler(scale: int, num_feat: int) -> nn.Sequential:
    """conv3x3 (num_feat -> num_feat*r^2) + PixelShuffle(r) per factor r
    of ``scale`` (3 where it divides, else 2)."""
    layers = []
    while scale > 1:
        r = 3 if scale % 3 == 0 else 2
        layers += [nn.Conv2d(num_feat, num_feat * r * r, 3, padding=1),
                   nn.PixelShuffle(r)]
        scale //= r
    return nn.Sequential(*layers)


def reflect_pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Reflect-pad NCHW ``x`` at the bottom and right to a multiple."""
    h, w = x.shape[2], x.shape[3]
    ph, pw = (multiple - h % multiple) % multiple, (multiple - w % multiple) \
        % multiple
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="reflect")
    return x


def window_masks(h, wd, window_size, device) -> dict:
    """The shift masks a forward at the padded size (h, wd) needs, keyed
    by (window, shift)."""
    if min(h, wd) <= window_size:
        return {}
    shift = window_size // 2
    return {(window_size, shift): shift_attn_mask(h, wd, window_size, shift,
                                                  device)}


class SwinIR(nn.Module):
    def __init__(self, upscale: int = 4, in_chans: int = 3,
                 embed_dim: int = 180, depths: Sequence[int] = (6,) * 6,
                 num_heads: Sequence[int] = (6,) * 6, window_size: int = 8,
                 mlp_ratio: float = 2.0, img_range: float = 1.0,
                 drop_path_rate: float = 0.1, num_feat: int = 64):
        super().__init__()
        self.upscale = upscale
        self.window_size = window_size
        self.img_range = img_range
        self.register_buffer(
            "mean", torch.tensor(DIV2K_RGB_MEAN if in_chans == 3 else (0.0,),
                                 dtype=torch.float32), persistent=False)
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, padding=1)
        self.patch_embed = PatchEmbed(embed_dim)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        offs = np.cumsum([0] + list(depths))
        self.layers = nn.ModuleList(
            RSTB(embed_dim, d, hds, window_size, mlp_ratio,
                 dpr[offs[i]:offs[i + 1]])
            for i, (d, hds) in enumerate(zip(depths, num_heads)))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, padding=1)
        self.conv_before_upsample = nn.Sequential(
            nn.Conv2d(embed_dim, num_feat, 3, padding=1),
            nn.LeakyReLU(0.01))
        self.upsample = pixelshuffle_upsampler(upscale, num_feat)
        self.conv_last = nn.Conv2d(num_feat, in_chans, 3, padding=1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B,H,W,C) in [0, 1] -> (B, H*scale, W*scale, C). ``generator``
        draws the drop-path masks in training mode."""
        _, h0, w0, _ = x.shape
        x = ((x - self.mean) * self.img_range).permute(0, 3, 1, 2)
        x = reflect_pad_to(x, self.window_size)
        size = (x.shape[2], x.shape[3])
        masks = window_masks(*size, self.window_size, x.device)
        feat = self.conv_first(x)
        seq = self.patch_embed.norm(tokens(feat))
        for layer in self.layers:
            seq = layer(seq, size, masks, generator)
        x = self.conv_after_body(to_map(self.norm(seq), size)) + feat
        x = self.conv_last(self.upsample(self.conv_before_upsample(x)))
        x = x.permute(0, 2, 3, 1) / self.img_range + self.mean
        return x[:, :h0 * self.upscale, :w0 * self.upscale, :]
