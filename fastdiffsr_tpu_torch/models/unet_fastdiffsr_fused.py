"""Fused-kernel inference forward of the FastDiffSR UNet.

Counterpart of ``fastdiffsr_tpu/models/unet_fastdiffsr_fused.py``: the
same math and the same parameters as :class:`FastDiffSRUNet`, in eval
mode, but every GroupNorm -> Swish -> conv ``Block`` and every plain 3x3
conv of the stem and the Upsamples runs as one call of K3
(``ops.fused_conv.fused_gn_swish_conv3x3``), which also returns the
per-channel statistics the next GroupNorm needs. Statistics flow instead
of being recomputed:

- each K3 call returns (y, stats_y);
- the skip concat's statistics are the concatenation of its parts';
- the outputs of the three Downsamples (a plain stride-2 conv) and of
  CLAM/SLAM get theirs from K2 (``ops.groupnorm.channel_stats``);
- an Upsample is nearest x2 then K3 with ``apply_norm=False``.

So one UNet eval at full width makes 49 K3 calls and 4 K2 calls. All maps
are NHWC. :func:`prepare_fused_params` converts the module's parameters
once into the layout K3 reads (HWIO conv weights in the compute type).
It reads only the parameters, so the module's exact rewrites
(``upsample_mode``, ``fold``, ``skip_concat``, ``conv_split``,
``stats_barrier``) do not apply here, as JAX's ``fused_apply`` ignores
them: the fused forward computes the same function in its own form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.fused_conv import fused_gn_swish_conv3x3
from ..ops.groupnorm import channel_stats
from .unet_fastdiffsr import FastDiffSRUNet, positional_encoding, swish


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x nearest upsample of an NHWC map."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


def _hwio(conv_w: torch.Tensor, dtype) -> torch.Tensor:
    return conv_w.detach().permute(2, 3, 1, 0).to(dtype).contiguous()


def _block_params(block, dtype) -> dict:
    gn, conv = block.block[0], block.block[3]
    return {"scale": gn.weight.detach().float(),
            "bias": gn.bias.detach().float(),
            "w": _hwio(conv.weight, dtype), "b": conv.bias.detach().float()}


def _resblock_params(rb, dtype) -> dict:
    lin = rb.noise_func.noise_func[0]
    p = {"block1": _block_params(rb.block1, dtype),
         "block2": _block_params(rb.block2, dtype),
         "noise_w": lin.weight.detach().float(),
         "noise_b": lin.bias.detach().float()}
    if not isinstance(rb.res_conv, torch.nn.Identity):
        # 1x1 conv as an NHWC matmul: (Cin, Cout)
        p["res_w"] = rb.res_conv.weight.detach()[:, :, 0, 0].t().to(
            dtype).contiguous()
        p["res_b"] = rb.res_conv.bias.detach().to(dtype)
    return p


@torch.no_grad()
def prepare_fused_params(net: FastDiffSRUNet, dtype=torch.bfloat16) -> dict:
    """The parameters of ``net`` in the layouts the fused forward reads."""
    from .unet_fastdiffsr import Downsample, ResnetBlocWithAttn
    mlp = net.noise_level_mlp
    fp = {"dtype": dtype, "groups": net.norm_groups,
          "inner": net.inner_channel, "mults": net.channel_mults,
          "res_blocks": net.res_blocks,
          "mlp1": (mlp[1].weight.detach().float(),
                   mlp[1].bias.detach().float()),
          "mlp2": (mlp[3].weight.detach().float(),
                   mlp[3].bias.detach().float()),
          "stem": {"w": _hwio(net.downs[0].weight, dtype),
                   "b": net.downs[0].bias.detach().float()},
          "downs": [], "ups": [],
          "final": _block_params(net.final_conv, dtype)}
    for layer in net.downs[1:]:
        if isinstance(layer, ResnetBlocWithAttn):
            fp["downs"].append(("res", _resblock_params(layer.res_block,
                                                        dtype)))
        else:
            assert isinstance(layer, Downsample)
            fp["downs"].append(("down", {
                "w": layer.conv.weight.detach().to(dtype),
                "b": layer.conv.bias.detach().to(dtype)}))
    m0, m1 = net.mid
    fp["mid0"] = _resblock_params(m0.res_block, dtype)
    fp["ca"] = (m0.ca.fc1.weight.detach()[:, :, 0, 0].t().to(dtype),
                m0.ca.fc2.weight.detach()[:, :, 0, 0].t().to(dtype))
    fp["sa"] = m0.sa.conv1.weight.detach().to(dtype)
    fp["mid1"] = _resblock_params(m1.res_block, dtype)
    for layer in net.ups:
        if isinstance(layer, ResnetBlocWithAttn):
            fp["ups"].append(("res", _resblock_params(layer.res_block,
                                                      dtype)))
        else:
            fp["ups"].append(("up", {"w": _hwio(layer.conv.weight, dtype),
                                     "b": layer.conv.bias.detach().float()}))
    return fp


def _block(p, x, stats, groups, *, shift=None, res=None, want_stats=True):
    """One Block (GN -> Swish -> conv) as a K3 call."""
    return fused_gn_swish_conv3x3(x, p["scale"], p["bias"], stats, p["w"],
                                  p["b"], shift=shift, res=res,
                                  groups=groups, want_stats=want_stats)


def _resblock(p, x, stats, noise_emb, groups):
    """block1 -> +shift -> block2 -> +skip; returns (out, stats_out).
    x / stats may be 2-tuples (the skip concat, read by K3 without
    building it)."""
    shift = F.linear(noise_emb, p["noise_w"], p["noise_b"])
    h, st = _block(p["block1"], x, stats, groups, shift=shift)
    xs = x if isinstance(x, tuple) else (x,)
    if "res_w" in p:
        xin = torch.cat(xs, dim=-1) if len(xs) > 1 else xs[0]
        skip = torch.matmul(xin, p["res_w"]) + p["res_b"]
    else:
        skip = xs[0]
    return _block(p["block2"], h, st, groups, res=skip.contiguous())


def _clam_slam(ca, sa, x):
    """CLAM channel gate then SLAM spatial gate on an NHWC map."""
    fc1, fc2 = ca
    avg = x.mean(dim=(1, 2))
    mx = x.amax(dim=(1, 2))
    out = F.relu(avg @ fc1) @ fc2 + F.relu(mx @ fc1) @ fc2
    x = torch.sigmoid(out)[:, None, None, :] * x
    s = torch.cat([x.mean(dim=-1, keepdim=True),
                   x.amax(dim=-1, keepdim=True)], dim=-1)
    s = F.conv2d(s.permute(0, 3, 1, 2), sa, padding=3).permute(0, 2, 3, 1)
    return (torch.sigmoid(s) * x).contiguous()


def _downsample(p, x):
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"], p["b"], stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def fused_apply(fp: dict, x: torch.Tensor,
                noise_level: torch.Tensor) -> torch.Tensor:
    """Inference forward of the UNet whose parameters ``fp`` came from
    :func:`prepare_fused_params`. x: (B,H,W,in_channel) NHWC; noise_level
    (B,). Returns (B,H,W,out_channel) float32."""
    dtype, groups = fp["dtype"], fp["groups"]
    if noise_level.dim() == 2:
        noise_level = noise_level[:, 0]
    x = x.to(dtype).contiguous()

    t = positional_encoding(noise_level.float(), fp["inner"])
    t = swish(F.linear(t, *fp["mlp1"]))
    t = F.linear(t, *fp["mlp2"])

    x, stats = fused_gn_swish_conv3x3(x, None, None, None, fp["stem"]["w"],
                                      fp["stem"]["b"], apply_norm=False)
    feats = [(x, stats)]
    for kind, p in fp["downs"]:
        if kind == "res":
            x, stats = _resblock(p, x, stats, t, groups)
        else:
            x = _downsample(p, x)
            stats = channel_stats(x)
        feats.append((x, stats))

    x, stats = _resblock(fp["mid0"], x, stats, t, groups)
    x = _clam_slam(fp["ca"], fp["sa"], x)
    stats = channel_stats(x)
    x, stats = _resblock(fp["mid1"], x, stats, t, groups)

    for kind, p in fp["ups"]:
        if kind == "res":
            skip, skip_stats = feats.pop()
            x, stats = _resblock(p, (x, skip), (stats, skip_stats), t, groups)
        else:
            x, stats = fused_gn_swish_conv3x3(nearest_up2(x), None, None,
                                              None, p["w"], p["b"],
                                              apply_norm=False)

    out = _block(fp["final"], x, stats, groups, want_stats=False)
    return out.float()
