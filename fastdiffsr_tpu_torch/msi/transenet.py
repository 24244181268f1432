"""TransENet, transformer-enhanced SR: counterpart of
``fastdiffsr_tpu/msi/transenet.py`` (reference MSI_SR_model/model/
transenet.py:288-433 and model/transformer.py).

Head conv -> three residual feature stages (5 ResBlocks each) and a
pixelshuffle upsampler on the third; 1x1 reductions to n_feats/4; 8x8
patches flattened in (p1, p2, c) order to 512-d tokens; a ViT encoder
per stream (depth 8, 6 heads of 32, tanh-approximate GELU MLP of 512,
attention scale dim^-0.5); three decoders (self-attention, then
cross-attention with queries from the upsampled stream and keys/values
from an encoder stage through one shared pre-norm, then the MLP);
unpatchify, 1x1 expand, tail conv; UCMerced mean shift. The LayerNorms
use eps 1e-6, Flax's default, as the JAX package does.

Module names are the reference's state-dict keys (``head.0``,
``feat_extrat_stage{s}.body.{i}.body.{0,2}``, ``upsampler.{2k}``,
``stage{s}_conv1x1``, ``patch_to_embedding_{low{s},high}``,
``encoder_*.layers.{i}.{0,1}.fn.{norm,fn.*}``,
``decoder{s}.layers.{i}.{0,1,2}.fn.{norm,fn.*}``, ``embedding_to_patch``,
``span_conv1x1``, ``tail``). NHWC in [0, 1] at the boundary.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .hsenet import UCM_RGB_MEAN
from .swinir import pixelshuffle_upsampler

LN_EPS = 1e-6


class ResBlock(nn.Module):
    def __init__(self, feats: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(feats, feats, 3, padding=1),
                                  nn.ReLU(),
                                  nn.Conv2d(feats, feats, 3, padding=1))

    def forward(self, x):
        return x + self.body(x)


class FeatStage(nn.Module):
    def __init__(self, feats: int, n_blocks: int = 5):
        super().__init__()
        self.body = nn.Sequential(*(ResBlock(feats)
                                    for _ in range(n_blocks)))

    def forward(self, x):
        return self.body(x)


def attend(q, k, v, heads: int, scale: float):
    """Multi-head attention of (B, n, h·d) queries on (B, m, h·d) keys
    and values; softmax in float32."""
    b, n, _ = q.shape
    hd = q.shape[-1] // heads

    def split(t):
        return t.reshape(b, -1, heads, hd).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    attn = ((q @ k.transpose(-2, -1)) * scale).softmax(dim=-1)
    return (attn @ v).transpose(1, 2).reshape(b, n, heads * hd)


class SelfAttention(nn.Module):
    def __init__(self, dim, heads=6, dim_head=32):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.scale = dim ** -0.5
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x):
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        return self.to_out(attend(q, k, v, self.heads, self.scale))


class CrossAttention(nn.Module):
    def __init__(self, dim, heads=6, dim_head=32):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.scale = dim ** -0.5
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x, m):
        return self.to_out(attend(self.to_q(x), self.to_k(m), self.to_v(m),
                                  self.heads, self.scale))


class FeedForward(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        # the reference's (Linear, GELU, Dropout, Linear, Dropout) indices
        self.net = nn.Sequential(nn.Linear(dim, hidden),
                                 nn.GELU(approximate="tanh"), nn.Identity(),
                                 nn.Linear(hidden, dim))

    def forward(self, x):
        return self.net(x)


class PreNorm(nn.Module):
    """fn(norm(x), norm(m), ...): one LayerNorm for every input."""

    def __init__(self, dim, fn):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn

    def forward(self, *xs):
        return self.fn(*(self.norm(x) for x in xs))


class Residual(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x, *rest):
        return x + self.fn(x, *rest)


class Encoder(nn.Module):
    def __init__(self, dim, depth, heads=6, dim_head=32, mlp_dim=512):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleList([
            Residual(PreNorm(dim, SelfAttention(dim, heads, dim_head))),
            Residual(PreNorm(dim, FeedForward(dim, mlp_dim)))])
            for _ in range(depth))

    def forward(self, x):
        for attn, ff in self.layers:
            x = ff(attn(x))
        return x


class Decoder(nn.Module):
    def __init__(self, dim, depth=1, heads=6, dim_head=32, mlp_dim=512):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleList([
            Residual(PreNorm(dim, SelfAttention(dim, heads, dim_head))),
            Residual(PreNorm(dim, CrossAttention(dim, heads, dim_head))),
            Residual(PreNorm(dim, FeedForward(dim, mlp_dim)))])
            for _ in range(depth))

    def forward(self, x, m):
        for attn, cross, ff in self.layers:
            x = ff(cross(attn(x), m))
        return x


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B,C,H,W) -> (B, (H/p)(W/p), p·p·C) in (p1, p2, c) order."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpatchify(x: torch.Tensor, p: int, h: int, w: int,
               c: int) -> torch.Tensor:
    """The inverse of :func:`patchify`, to (B,C,H,W)."""
    b = x.shape[0]
    x = x.reshape(b, h // p, w // p, p, p, c).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(b, c, h, w)


class TransENet(nn.Module):
    def __init__(self, scale: int = 4, n_feats: int = 64, n_colors: int = 3,
                 en_depth: int = 8, de_depth: int = 1, dim: int = 512,
                 heads: int = 6, dim_head: int = 32, mlp_dim: int = 512,
                 patch_size: int = 8):
        super().__init__()
        nf, red, p = n_feats, n_feats // 4, patch_size
        self.patch_size = p
        self.register_buffer("mean", torch.tensor(UCM_RGB_MEAN),
                             persistent=False)
        self.head = nn.Sequential(nn.Conv2d(n_colors, nf, 3, padding=1))
        for s in (1, 2, 3):
            setattr(self, f"feat_extrat_stage{s}", FeatStage(nf))
            setattr(self, f"stage{s}_conv1x1", nn.Conv2d(nf, red, 1))
            setattr(self, f"patch_to_embedding_low{s}",
                    nn.Linear(red * p * p, dim))
        self.upsampler = pixelshuffle_upsampler(scale, nf)
        self.up_conv1x1 = nn.Conv2d(nf, red, 1)
        self.span_conv1x1 = nn.Conv2d(red, nf, 1)
        self.patch_to_embedding_high = nn.Linear(red * p * p, dim)
        self.embedding_to_patch = nn.Linear(dim, red * p * p)
        kw = dict(heads=heads, dim_head=dim_head, mlp_dim=mlp_dim)
        for name in ("encoder_stage1", "encoder_stage2", "encoder_stage3",
                     "encoder_up"):
            setattr(self, name, Encoder(dim, en_depth, **kw))
        for s in (1, 2, 3):
            setattr(self, f"decoder{s}", Decoder(dim, de_depth, **kw))
        self.tail = nn.Conv2d(nf, n_colors, 3, padding=1)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """(B,H,W,3) in [0, 1], H and W multiples of the patch size ->
        (B, H*scale, W*scale, 3); draws nothing."""
        p = self.patch_size
        x = self.head((x - self.mean).permute(0, 3, 1, 2))
        feats = [getattr(self, f"feat_extrat_stage{s}")(x) for s in (1, 2, 3)]
        up = self.up_conv1x1(self.upsampler(feats[2]))
        hb, wb = up.shape[2], up.shape[3]
        t = [getattr(self, f"encoder_stage{s}")(
            getattr(self, f"patch_to_embedding_low{s}")(
                patchify(getattr(self, f"stage{s}_conv1x1")(f), p)))
             for s, f in zip((1, 2, 3), feats)]
        tu = self.encoder_up(self.patch_to_embedding_high(patchify(up, p)))
        tu = self.decoder3(tu, t[2])
        tu = self.decoder2(tu, t[1])
        tu = self.decoder1(tu, t[0])
        out = unpatchify(self.embedding_to_patch(tu), p, hb, wb, up.shape[1])
        out = self.tail(self.span_conv1x1(out))
        return out.permute(0, 2, 3, 1) + self.mean
