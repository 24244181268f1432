"""ConditionalNAFNet, EDiffSR's denoiser (plain PyTorch forward).

Counterpart of ``fastdiffsr_tpu/models/nafnet.py`` (reference
EDiffSR/codes/config/sisr/models/modules/DenoisingNAFNet_arch.py):

- NAFBlock: channel LayerNorm (scale only, biased variance) -> time
  scale/shift -> 1x1 expand -> 3x3 depthwise -> SimpleGate -> simplified
  channel attention -> 1x1, residual scaled by ``beta``; then the FFN
  half scaled by ``gamma``;
- time MLP: sinusoidal embedding -> Linear(w, 8w) -> SimpleGate ->
  Linear(4w, 4w);
- topology: input cat([x - mu, mu]) -> intro conv -> RCAB enhance
  (+residual) -> encoder stages (NAFBlocks, then a 2x2 stride-2 conv that
  doubles the channels) -> middle blocks -> decoder stages (1x1 conv +
  PixelShuffle up, additive skips) -> ending conv, cropped to the input
  size. The input is zero-padded to a multiple of 2^len(enc_blk_nums).

Module and parameter names are the reference's state-dict names
(``time_mlp.{1,3}``, ``intro``, ``enhance.rcab.*``,
``encoders.i.j.{conv1..5, sca.1, mlp.1, norm1.g, norm2.g, beta,
gamma}``, ``downs.i``, ``ups.i.0``, ``middle_blks.j``, ``decoders.i.j``,
``ending``), so a reference ``DenoisingNAFNet_arch`` state dict loads
strictly. ``models/convert.py::flax_nafnet_params_to_torch`` maps the
JAX package's tree onto them.

The net takes and returns NHWC and runs NCHW inside. ``dtype`` is the
compute type of the convs and linears, with float32 parameters (the
Flax ``dtype`` semantics); the output is float32. ``up_mode`` picks the
decoder's upsample: ``''`` the literal 1x1 conv + PixelShuffle,
``'tconv'`` (the JAX default) the same function as one stride-2
transposed conv of the 1x1 weights. ``dw_mode='shift'`` computes each
NAFBlock's depthwise 3x3 conv as nine shifted multiply-adds over the
zero-padded map (JAX's order: dy, then dx). ``fold_mode`` ('enc' or
'all') folds image pairs into the channels (``unet_fastdiffsr.fold2``,
JAX's image-major layout) for encoder stage 0, and under 'all' also for
the last decoder stage, at even batch only: a folded NAFBlock runs
block-diagonal 1x1 convs built from its own weights (the outputs that
feed SimpleGate in gate-half-major order, ``_gate_major_idx``), its
depthwise kernel tiled, and its LayerNorm per image half, so each image
gets the unfolded block's function. Every mode keeps the same parameters.
No NAFBlock draws dropout (the JAX package's rate is 0 in EDiffSR).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .unet_fastdiffsr import (_blockdiag2, _conv, _linear, fold2,
                              init_params, unfold2)


def sinusoidal_pos_emb(x: torch.Tensor, dim: int) -> torch.Tensor:
    """module_util.py:29-45 (the half-1 denominator variant)."""
    half = dim // 2
    scale = math.log(10000) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=x.device) * -scale)
    emb = x[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def simple_gate(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=1)
    return x1 * x2


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return sinusoidal_pos_emb(x, self.dim)


class SimpleGate(nn.Module):
    def forward(self, x):
        return simple_gate(x)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW map, scale ``g`` only,
    biased variance (module_util.py:74-83)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        mean = x.mean(dim=1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.g


def _gate_major_idx(co: int, device) -> torch.Tensor:
    """Output order of a folded conv that feeds SimpleGate: the image
    halves' gate halves as [A_x1, B_x1, A_x2, B_x2], so that a plain
    chunk(2) gates each image against itself (JAX ``_gate_major_idx``).
    Indexes the image-major channels (i*co + j) of a folded output."""
    half = co // 2
    a = torch.arange(half, device=device)
    return torch.cat([a, co + a, half + a, co + half + a])


def _folded_1x1(x, conv: nn.Conv2d, dtype, order=None) -> torch.Tensor:
    """``conv`` (1x1) on a folded map: its weight block-diagonal, its bias
    tiled, both output channels permuted by ``order``."""
    w, b = _blockdiag2(conv.weight), conv.bias.repeat(2)
    if order is not None:
        w, b = w[order], b[order]
    return F.conv2d(x.to(dtype), w.to(dtype), b.to(dtype))


def _cln_folded(x: torch.Tensor, g: torch.Tensor, eps: float
                ) -> torch.Tensor:
    """LayerNorm2d on a folded (B/2, 2c, H, W) map: statistics per image
    half, the scale tiled (JAX ``_cln_folded``)."""
    b2, c2, h, w = x.shape
    xr = x.reshape(b2, 2, c2 // 2, h, w)
    mean = xr.mean(dim=2, keepdim=True)
    var = ((xr - mean) ** 2).mean(dim=2, keepdim=True)
    xr = (xr - mean) * torch.rsqrt(var + eps)
    return xr.reshape(b2, c2, h, w) * g.repeat(1, 2, 1, 1)


def _shift_dw(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """The depthwise 3x3 conv as nine shifted multiply-adds over the
    zero-padded map, in JAX's order (dy, then dx)."""
    k = conv.weight.to(dtype)
    x = x.to(dtype)
    xp = F.pad(x, (1, 1, 1, 1))
    hh, ww = x.shape[2], x.shape[3]
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = xp[:, :, dy:dy + hh, dx:dx + ww] * \
                k[:, 0, dy, dx][None, :, None, None]
            acc = term if acc is None else acc + term
    return acc + conv.bias.to(dtype)[None, :, None, None]


class NAFBlock(nn.Module):
    def __init__(self, c: int, time_emb_dim: int, dw_expand: int = 2,
                 ffn_expand: int = 2):
        super().__init__()
        dw = c * dw_expand
        ffn = c * ffn_expand
        self.mlp = nn.Sequential(SimpleGate(),
                                 nn.Linear(time_emb_dim // 2, c * 4))
        self.conv1 = nn.Conv2d(c, dw, 1)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
        self.conv3 = nn.Conv2d(dw // 2, c, 1)
        self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                 nn.Conv2d(dw // 2, dw // 2, 1))
        self.conv4 = nn.Conv2d(c, ffn, 1)
        self.conv5 = nn.Conv2d(ffn // 2, c, 1)
        self.norm1 = LayerNorm2d(c)
        self.norm2 = LayerNorm2d(c)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def forward(self, x, t_emb, dtype=torch.float32, dw_mode: str = "",
                folded: bool = False):
        """``folded``: ``x`` is a fold2-folded (B/2, 2c, H, W) map of the
        batch whose (B, ...) time embedding is ``t_emb``."""
        te = _linear(simple_gate(t_emb), self.mlp[1], dtype)
        if folded:
            return self._folded(x, te, dtype)
        shift_att, scale_att, shift_ffn, scale_ffn = \
            te[:, :, None, None].chunk(4, dim=1)

        inp = x
        x = self.norm1(x)
        x = x * (scale_att + 1) + shift_att
        x = _conv(x, self.conv1, dtype)
        if dw_mode == "shift":
            x = _shift_dw(x, self.conv2, dtype)
        else:
            x = F.conv2d(x.to(dtype), self.conv2.weight.to(dtype),
                         self.conv2.bias.to(dtype), padding=1,
                         groups=self.conv2.groups)
        x = simple_gate(x)
        sca = _conv(x.mean(dim=(2, 3), keepdim=True), self.sca[1], dtype)
        x = _conv(x * sca, self.conv3, dtype)
        y = inp + x * self.beta

        x = self.norm2(y)
        x = x * (scale_ffn + 1) + shift_ffn
        x = simple_gate(_conv(x, self.conv4, dtype))
        x = _conv(x, self.conv5, dtype)
        return y + x * self.gamma

    def _folded(self, x, te, dtype):
        """JAX ``NAFBlock._folded_body``: the depthwise conv is always the
        grouped conv here, as there."""
        b2 = x.shape[0]
        c = self.norm1.g.shape[1]
        dw = self.conv1.out_channels
        shift_att, scale_att, shift_ffn, scale_ffn = [
            m.reshape(b2, 2 * c)[:, :, None, None] for m in te.chunk(4, 1)]
        gate = _gate_major_idx(dw, x.device)

        inp = x
        x = _cln_folded(x, self.norm1.g, self.norm1.eps)
        x = x * (scale_att + 1) + shift_att
        x = _folded_1x1(x, self.conv1, dtype, gate)
        # depthwise: the kernel tiled in the same gate-half-major order
        k = self.conv2.weight.repeat(2, 1, 1, 1)[gate]
        x = F.conv2d(x.to(dtype), k.to(dtype),
                     self.conv2.bias.repeat(2)[gate].to(dtype), padding=1,
                     groups=2 * dw)
        x = simple_gate(x)                  # (B/2, dw, H, W) image-major
        sca = _folded_1x1(x.mean(dim=(2, 3), keepdim=True), self.sca[1],
                          dtype)
        x = _folded_1x1(x * sca, self.conv3, dtype)
        y = inp + x * self.beta.repeat(1, 2, 1, 1)

        x = _cln_folded(y, self.norm2.g, self.norm2.eps)
        x = x * (scale_ffn + 1) + shift_ffn
        x = _folded_1x1(x, self.conv4, dtype,
                        _gate_major_idx(self.conv4.out_channels, x.device))
        x = _folded_1x1(simple_gate(x), self.conv5, dtype)
        return y + x * self.gamma.repeat(1, 2, 1, 1)


class CALayer(nn.Module):
    def __init__(self, num_feat: int, squeeze: int = 16):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(num_feat, num_feat // squeeze, 1), nn.ReLU(),
            nn.Conv2d(num_feat // squeeze, num_feat, 1), nn.Sigmoid())

    def forward(self, x, dtype=torch.float32):
        a = x.mean(dim=(2, 3), keepdim=True)
        a = F.relu(_conv(a, self.attention[1], dtype))
        a = _conv(a, self.attention[3], dtype)
        return x * torch.sigmoid(a)


class RCAB(nn.Module):
    """Residual channel attention block (DenoisingNAFNet_arch.py:121-141):
    conv3x3 -> ReLU -> conv3x3 -> channel attention, plus the input."""

    def __init__(self, num_feat: int, squeeze: int = 16):
        super().__init__()
        self.rcab = nn.Sequential(
            nn.Conv2d(num_feat, num_feat, 3, padding=1), nn.ReLU(),
            nn.Conv2d(num_feat, num_feat, 3, padding=1),
            CALayer(num_feat, squeeze))

    def forward(self, x, dtype=torch.float32):
        h = F.relu(_conv(x, self.rcab[0], dtype))
        h = _conv(h, self.rcab[2], dtype)
        return self.rcab[3](h, dtype) + x


class ConditionalNAFNet(nn.Module):
    def __init__(self, img_channel: int = 3, width: int = 16,
                 middle_blk_num: int = 1, enc_blk_nums: Sequence[int] = (),
                 dec_blk_nums: Sequence[int] = (), upscale: int = 1,
                 dtype=torch.float32, dw_mode: str = "", up_mode: str = "",
                 fold_mode: str = ""):
        super().__init__()
        if dw_mode not in ("", "shift"):
            raise ValueError(f"dw_mode={dw_mode!r} (want '' or 'shift')")
        if fold_mode not in ("", "enc", "all"):
            raise ValueError(f"fold_mode={fold_mode!r} (want '', 'enc' or "
                             "'all')")
        if up_mode not in ("", "tconv"):
            raise ValueError(f"up_mode={up_mode!r} (want '' or 'tconv')")
        self.width = width
        self.dtype = dtype
        self.up_mode = up_mode
        self.dw_mode = dw_mode
        self.fold_mode = fold_mode
        self.upscale = upscale           # accepted, unused (reference too)
        time_dim = width * 4
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(width), nn.Linear(width, time_dim * 2),
            SimpleGate(), nn.Linear(time_dim, time_dim))
        self.intro = nn.Conv2d(img_channel * 2, width, 3, padding=1)
        self.enhance = RCAB(width)
        self.encoders = nn.ModuleList()
        self.downs = nn.ModuleList()
        chan = width
        for num in enc_blk_nums:
            self.encoders.append(nn.ModuleList(
                [NAFBlock(chan, time_dim) for _ in range(num)]))
            self.downs.append(nn.Conv2d(chan, 2 * chan, 2, stride=2))
            chan *= 2
        self.middle_blks = nn.ModuleList(
            [NAFBlock(chan, time_dim) for _ in range(middle_blk_num)])
        self.ups = nn.ModuleList()
        self.decoders = nn.ModuleList()
        for num in dec_blk_nums:
            self.ups.append(nn.Sequential(
                nn.Conv2d(chan, chan * 2, 1, bias=False),
                nn.PixelShuffle(2)))
            chan //= 2
            self.decoders.append(nn.ModuleList(
                [NAFBlock(chan, time_dim) for _ in range(num)]))
        self.ending = nn.Conv2d(width, img_channel, 3, padding=1)
        self.padder_size = 2 ** len(enc_blk_nums)

    def _up(self, x, i):
        w = self.ups[i][0].weight.to(self.dtype)     # (2c, c, 1, 1)
        x = x.to(self.dtype)
        if self.up_mode == "tconv":
            # out[o, 2h+i, 2w+j] = x[:, h, w] @ W[o*4 + i*2 + j, :]
            c = w.shape[1]
            wt = w[:, :, 0, 0].reshape(c // 2, 2, 2, c).permute(3, 0, 1, 2)
            return F.conv_transpose2d(x, wt, stride=2)
        return F.pixel_shuffle(F.conv2d(x, w), 2)

    def _stage(self, x, t, blocks, fold: bool):
        """A stage's NAFBlocks, on the folded map where ``fold`` (and the
        stage has blocks)."""
        fold = fold and len(blocks) > 0
        if fold:
            x = fold2(x)
        for blk in blocks:
            x = blk(x, t, self.dtype, self.dw_mode, fold)
        return unfold2(x) if fold else x

    def forward(self, inp: torch.Tensor, cond: torch.Tensor,
                time: torch.Tensor) -> torch.Tensor:
        """(B,H,W,C) noisy state and condition, (B,) or scalar times ->
        (B,H,W,C) float32 predicted noise."""
        dt = self.dtype
        if time.ndim == 0:
            time = time[None]
        t = sinusoidal_pos_emb(time, self.width)
        t = _linear(t, self.time_mlp[1], dt)
        t = _linear(simple_gate(t), self.time_mlp[3], dt)

        x = torch.cat([inp - cond, cond], dim=-1).to(dt)
        x = x.permute(0, 3, 1, 2)
        H, W = x.shape[2], x.shape[3]
        ph = (self.padder_size - H % self.padder_size) % self.padder_size
        pw = (self.padder_size - W % self.padder_size) % self.padder_size
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph))

        x = _conv(x, self.intro, dt)
        x = x + self.enhance(x, dt)
        # fold image pairs into the channels where JAX does: encoder
        # stage 0, and under 'all' the last decoder stage; even batch only
        fold = bool(self.fold_mode) and x.shape[0] % 2 == 0
        encs = []
        for i, (blocks, down) in enumerate(zip(self.encoders, self.downs)):
            x = self._stage(x, t, blocks, fold and i == 0)
            encs.append(x)
            x = _conv(x, down, dt)
        for blk in self.middle_blks:
            x = blk(x, t, dt, self.dw_mode)
        last = len(self.decoders) - 1
        for i, (blocks, skip) in enumerate(zip(self.decoders, encs[::-1])):
            x = self._up(x, i) + skip
            x = self._stage(x, t, blocks,
                            fold and self.fold_mode == "all" and i == last)
        x = _conv(x, self.ending, dt)
        return x[:, :, :H, :W].permute(0, 2, 3, 1).float()


def nafnet_from_config(setting: dict, dtype=torch.float32, device="cuda",
                       seed: int = 0, up_mode: str = "tconv",
                       dw_mode: str = "", fold_mode: str = ""
                       ) -> ConditionalNAFNet:
    """Build from EDiffSR YAML network settings (width 64, enc
    [14,1,1,1], dec [1,1,1,1], middle 1 by default), with seeded Flax-style
    initial parameters (``unet_fastdiffsr.init_params``; the LayerNorm
    scales start at 1, ``beta``/``gamma`` at 0), on ``device``."""
    from ..device import resolve_device
    dev = resolve_device(device)
    net = ConditionalNAFNet(
        img_channel=setting.get("img_channel", 3),
        width=setting.get("width", 64),
        middle_blk_num=setting.get("middle_blk_num", 1),
        enc_blk_nums=tuple(setting.get("enc_blk_nums", (14, 1, 1, 1))),
        dec_blk_nums=tuple(setting.get("dec_blk_nums", (1, 1, 1, 1))),
        upscale=setting.get("upscale", 1), dtype=dtype, up_mode=up_mode,
        dw_mode=dw_mode, fold_mode=fold_mode)
    return init_params(net, seed).to(dev)
