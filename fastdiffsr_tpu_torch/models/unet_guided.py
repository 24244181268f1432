"""Guided-diffusion UNet of the gdp variant (plain PyTorch forward).

Counterpart of ``fastdiffsr_tpu/models/unet_guided.py`` and of the
reference model/gdp_modules/unet.py:530-801 (OpenAI's guided-diffusion
UNet with ``resblock_updown``, ``use_scale_shift_norm`` and 64 channels
per attention head):

- ``guided_timestep_embedding``: half-dim frequencies, cos first;
- ``GuidedResBlock``: GroupNorm -> SiLU -> (nearest x2 | 2x2 average
  pool of both paths) -> 3x3 conv; the embedding's SiLU -> Linear gives
  (scale, shift); GroupNorm * (1 + scale) + shift -> SiLU -> dropout ->
  3x3 conv (zero-initialised); a 1x1 skip where the width changes;
- ``GuidedAttention`` (QKVAttentionLegacy): GroupNorm -> qkv with the
  heads split before q/k/v -> ch^-1/4 on both q and k -> softmax ->
  zero-initialised ``proj_out``, residual;
- attention where the downsample factor ``ds`` is in
  ``attention_resolutions``.

The width is ``model_channels`` (default 128): the config's
``inner_channel`` is ignored, as the reference does. Module and
parameter names are the reference's (``time_embed.{0,2}``,
``input_blocks.i.j.{in_layers,emb_layers,out_layers,skip_connection}``,
``middle_block.j``, ``output_blocks.i.j``, attention ``norm``, ``qkv``,
``proj_out`` as 1x1 Conv1d, ``out.{0,2}``), which
``fastdiffsr_tpu/models/convert.py::torch_guided_unet_to_flax`` reads.

Kernel K1 (``gn_swish_custom``) runs each ResBlock's ``in_layers``
GroupNorm -> SiLU and the final ``out`` GroupNorm -> SiLU: both are K1's
function (32 groups, eps 1e-5, a per-channel affine, swish). The
scale-shift norm of ``out_layers`` stays plain ``F.group_norm`` -> affine
-> SiLU: its affine is per image, (B, C), and K1 takes (C,). Maps stay
channels-last NCHW views of NHWC memory, as K1 needs.

An up ResBlock computes its ``in_layers`` conv of the nearest-x2 map in
the form ``upsample_mode`` of ``unet_fastdiffsr.apply_upsample2_conv3``
('' literal, 'tconv', 'd2s2'; JAX :72-81), its skip path still on the
upsampled x; ``guided_unet_from_config`` reads the form from
``FASTDIFFSR_TPU_UPSAMPLE`` (default tconv), as JAX's builder does.

Train-mode dropout draws its masks from the ``generator`` passed to
``forward``. With ``use_checkpoint`` each ResBlock runs under
``torch.utils.checkpoint`` (JAX's ``nn.remat``); its dropout mask is
drawn before the checkpointed part and passed in, so the recompute in
the backward applies the mask the forward used.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.groupnorm import gn_swish_custom
from .unet_fastdiffsr import (_conv, _linear, apply_upsample2_conv3,
                              check_upsample_mode, default_upsample_mode,
                              init_params)
from .unet_sr3 import attend, from_tokens, pointwise, tokens

GROUPS = 32


def guided_timestep_embedding(timesteps: torch.Tensor, dim: int,
                              max_period: float = 10000.0) -> torch.Tensor:
    """(B,) timesteps -> (B, dim): [cos, sin] of t * max_period^(-i/half)
    (reference gdp unet.py:120-138)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _gn_swish(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """K1 on the NHWC view of a channels-last (B, C, H, W) map."""
    return gn_swish_custom(x.permute(0, 2, 3, 1), gn.weight, gn.bias,
                           gn.num_groups, gn.eps).permute(0, 3, 1, 2)


def _resample(x: torch.Tensor, up: bool, down: bool) -> torch.Tensor:
    if up:
        return F.interpolate(x, scale_factor=2, mode="nearest")
    if down:
        return F.avg_pool2d(x, 2, 2)
    return x


class GuidedResBlock(nn.Module):
    """Scale-shift-norm residual block, optionally resampling
    (reference gdp unet.py:276-389)."""

    def __init__(self, channels: int, out_channels: int, emb_channels: int,
                 dropout: float = 0.0, up: bool = False, down: bool = False,
                 use_checkpoint: bool = False, upsample_mode: str = ""):
        super().__init__()
        check_upsample_mode(upsample_mode)
        self.up, self.down = up, down
        self.upsample_mode = upsample_mode
        self.use_checkpoint = use_checkpoint
        self.in_layers = nn.Sequential(
            nn.GroupNorm(GROUPS, channels), nn.SiLU(),
            nn.Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, 2 * out_channels))
        self.out_layers = nn.Sequential(
            nn.GroupNorm(GROUPS, out_channels), nn.SiLU(),
            nn.Dropout(dropout),
            nn.Conv2d(out_channels, out_channels, 3, padding=1))
        self.skip_connection = (nn.Conv2d(channels, out_channels, 1)
                                if out_channels != channels
                                else nn.Identity())

    def _keep_mask(self, x, generator) -> Optional[torch.Tensor]:
        """The train-mode dropout mask of this call, channels-last, or
        None where dropout is off."""
        p = self.out_layers[2].p
        if not (self.training and p > 0):
            return None
        if generator is None:
            raise ValueError("train-mode dropout draws its mask from an "
                             "explicit generator: pass generator=")
        b, _, h, w = x.shape
        h, w = (2 * h, 2 * w) if self.up else (
            (h // 2, w // 2) if self.down else (h, w))
        c = self.out_layers[3].out_channels
        keep = torch.empty((b, h, w, c), device=x.device).bernoulli_(
            1.0 - p, generator=generator)
        return keep.bool().permute(0, 3, 1, 2)

    def forward(self, x, emb, dtype, generator=None):
        keep = self._keep_mask(x, generator)
        if self.use_checkpoint and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                self._body, x, emb, keep, dtype, use_reentrant=False)
        return self._body(x, emb, keep, dtype)

    def _body(self, x, emb, keep, dtype):
        h = _gn_swish(x, self.in_layers[0])
        conv = self.in_layers[2]
        if self.up and self.upsample_mode:
            # conv3(nearest_up2(h)) without the 4x map
            h = apply_upsample2_conv3(h, conv.weight, conv.bias,
                                      self.upsample_mode, dtype)
        else:
            h = _conv(_resample(h, self.up, self.down), conv, dtype)
        x = _resample(x, self.up, self.down)
        e = _linear(F.silu(emb), self.emb_layers[1], dtype).float()
        scale, shift = e[:, :, None, None].chunk(2, dim=1)
        gn = self.out_layers[0]
        h = F.group_norm(h.float(), gn.num_groups, gn.weight, gn.bias,
                         gn.eps).contiguous(memory_format=torch.channels_last)
        h = F.silu(h * (1 + scale) + shift)
        if keep is not None:
            h = h * keep / (1.0 - self.out_layers[2].p)
        h = _conv(h, self.out_layers[3], dtype)
        skip = (x if isinstance(self.skip_connection, nn.Identity)
                else _conv(x, self.skip_connection, dtype))
        return skip + h


class GuidedAttention(nn.Module):
    """QKVAttentionLegacy semantics (reference gdp unet.py:392-491)."""

    def __init__(self, channels: int, num_head_channels: int = 64):
        super().__init__()
        self.heads = (channels // num_head_channels
                      if num_head_channels > 0 else 1)
        self.norm = nn.GroupNorm(GROUPS, channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x, dtype):
        b, c, h, w = x.shape
        heads = self.heads
        ch = c // heads
        n = self.norm
        xn = F.group_norm(x.float(), n.num_groups, n.weight, n.bias, n.eps)
        # heads split BEFORE q/k/v: the output axis is (heads, 3, ch)
        qkv = pointwise(tokens(xn), self.qkv, dtype).reshape(
            b, h * w, heads, 3 * ch).permute(0, 2, 1, 3)
        q, k, v = qkv.split(ch, dim=-1)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        a = attend(q * scale, k * scale, v, dtype)
        a = pointwise(a.permute(0, 2, 1, 3).reshape(b, h * w, c),
                      self.proj_out, dtype)
        return x + from_tokens(a, h, w)


class GuidedUNet(nn.Module):
    """The gdp denoiser (reference gdp unet.py:530-801). Input x:
    (B,H,W,in_channel) NHWC, packed ``cat([x_noisy, cond])``; timesteps
    (B,) discrete. Output (B,H,W,out_channel) float32."""

    def __init__(self, image_size: int = 256, in_channel: int = 6,
                 model_channels: int = 128, out_channel: int = 3,
                 res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (32, 16, 8),
                 dropout: float = 0.0,
                 channel_mults: Sequence[int] = (1, 2, 4, 8),
                 num_head_channels: int = 64, use_checkpoint: bool = False,
                 dtype=torch.float32, upsample_mode: str = ""):
        super().__init__()
        self.in_channel = in_channel
        self.model_channels = mc = model_channels
        self.dtype = dtype
        emb_ch = mc * 4
        self.time_embed = nn.Sequential(nn.Linear(mc, emb_ch), nn.SiLU(),
                                        nn.Linear(emb_ch, emb_ch))
        attn_res = tuple(attention_resolutions)

        def res(cin, cout, up=False, down=False):
            return GuidedResBlock(cin, cout, emb_ch, dropout=dropout, up=up,
                                  down=down, use_checkpoint=use_checkpoint,
                                  upsample_mode=upsample_mode)

        def attn(ch):
            return GuidedAttention(ch, num_head_channels)

        ch = int(channel_mults[0] * mc)
        inputs = [nn.ModuleList([nn.Conv2d(in_channel, ch, 3, padding=1)])]
        input_chans = [ch]
        ds = 1
        for level, mult in enumerate(channel_mults):
            for _ in range(res_blocks):
                out_ch = int(mult * mc)
                stage = [res(ch, out_ch)]
                ch = out_ch
                if ds in attn_res:
                    stage.append(attn(ch))
                inputs.append(nn.ModuleList(stage))
                input_chans.append(ch)
            if level != len(channel_mults) - 1:
                inputs.append(nn.ModuleList([res(ch, ch, down=True)]))
                input_chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(inputs)
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch),
                                           res(ch, ch)])
        outputs = []
        for level, mult in list(enumerate(channel_mults))[::-1]:
            for i in range(res_blocks + 1):
                out_ch = int(mult * mc)
                stage = [res(ch + input_chans.pop(), out_ch)]
                ch = out_ch
                if ds in attn_res:
                    stage.append(attn(ch))
                if level and i == res_blocks:
                    stage.append(res(ch, ch, up=True))
                    ds //= 2
                outputs.append(nn.ModuleList(stage))
        self.output_blocks = nn.ModuleList(outputs)
        self.out = nn.Sequential(nn.GroupNorm(GROUPS, ch), nn.SiLU(),
                                 nn.Conv2d(ch, out_channel, 3, padding=1))

    def _stage(self, stage, h, emb, dt, generator):
        for layer in stage:
            if isinstance(layer, GuidedResBlock):
                h = layer(h, emb, dt, generator)
            elif isinstance(layer, GuidedAttention):
                h = layer(h, dt)
            else:
                h = _conv(h, layer, dt)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in train mode."""
        dt = self.dtype
        if timesteps.dim() == 2:
            timesteps = timesteps[:, 0]
        emb = guided_timestep_embedding(timesteps, self.model_channels)
        emb = _linear(F.silu(_linear(emb, self.time_embed[0], dt)),
                      self.time_embed[2], dt)
        h = x.permute(0, 3, 1, 2).to(dt)
        hs = []
        for stage in self.input_blocks:
            h = self._stage(stage, h, emb, dt, generator)
            hs.append(h)
        h = self._stage(self.middle_block, h, emb, dt, generator)
        for stage in self.output_blocks:
            h = self._stage(stage, torch.cat([h, hs.pop()], dim=1), emb, dt,
                            generator)
        h = _conv(_gn_swish(h, self.out[0]), self.out[2], dt)
        return h.float().permute(0, 2, 3, 1).contiguous()


def init_guided_params(net: GuidedUNet, seed: int = 0) -> GuidedUNet:
    """Flax's initial parameters of the JAX package: LeCun-normal weights
    (``init_params``), then zeros for each ResBlock's ``out_layers`` conv,
    each attention's ``proj_out`` and the final conv, as ``zeros_init``
    there."""
    init_params(net, seed)
    with torch.no_grad():
        for m in net.modules():
            zero = ([m.out_layers[3]] if isinstance(m, GuidedResBlock)
                    else [m.proj_out] if isinstance(m, GuidedAttention)
                    else [])
            for layer in zero:
                layer.weight.zero_()
                layer.bias.zero_()
        net.out[2].weight.zero_()
        net.out[2].bias.zero_()
    return net


def guided_unet_from_config(unet_opt: dict, image_size: int = 256,
                            dtype=torch.float32, device="cuda",
                            seed: int = 0,
                            use_checkpoint: bool = False) -> GuidedUNet:
    """Build from a reference-schema ``model.unet`` config dict, in eval
    mode on ``device``. The width comes from ``model_channels`` (default
    128); ``inner_channel`` is ignored (reference gdp unet.py:565,583).
    The Upsample form comes from ``FASTDIFFSR_TPU_UPSAMPLE``."""
    from ..device import resolve_device
    dev = resolve_device(device)
    net = GuidedUNet(
        image_size=image_size,
        in_channel=unet_opt.get("in_channel", 6),
        model_channels=unet_opt.get("model_channels", 128),
        out_channel=unet_opt.get("out_channel", 3),
        res_blocks=unet_opt.get("res_blocks", 2),
        channel_mults=tuple(unet_opt.get("channel_multiplier", (1, 2, 4, 8))),
        dropout=unet_opt.get("dropout", 0.0),
        use_checkpoint=use_checkpoint,
        dtype=dtype,
        upsample_mode=default_upsample_mode())
    return init_guided_params(net, seed).to(dev).eval()
