"""HSENet, the hybrid-scale self-similarity network: counterpart of
``fastdiffsr_tpu/msi/hsenet.py`` (reference MSI_SR_model/model/hsenet.py).

- the UCMerced rgb mean shift (the reference's frozen 1x1 MeanShift
  convs, a plain subtract/add here);
- NonLocalBlock2D: embedded-gaussian self-attention over all H·W
  positions (a (H·W)^2 map per image, softmax in float32), its output
  conv ``W`` zero at init;
- AdjustedNonLocalBlock: theta from the half-scale branch, phi and g
  from the base branch;
- SSEM: head -> {2 BasicBlocks, NonLocal -> 1x1 -> sigmoid} -> gated
  product -> tail, + skip;
- HSEM: base-scale SSEM and half-scale SSEM (bilinear down by 2 and back,
  ``F.interpolate`` without antialias, as ``jax.image.resize(...,
  antialias=False)``) fused by the adjusted non-local block -> tail, +
  skip;
- BasicModule: 2 BasicBlocks -> HSEM -> 2 BasicBlocks, + skip;
- HSENet: head -> 10 BasicModules (+ global skip) -> pixelshuffle ->
  tail conv; n_feats 64 (hsenet.py:651).

Module names are the reference's state-dict keys (``head.0``,
``body_modulist.{i}.{head,body.0,tail}``, ``base_scale.0``,
``NonLocal_base``, ``AB.{0,1}``, ``MB.{0,1}.0``, ``tail.{0.{2k},1}``).
NHWC in [0, 1] at the boundary.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .swinir import pixelshuffle_upsampler

UCM_RGB_MEAN = (0.4916, 0.4991, 0.4565)


def basic_block(feats: int, kernel: int = 3) -> nn.Sequential:
    """conv -> ReLU (the reference BasicBlock)."""
    return nn.Sequential(nn.Conv2d(feats, feats, kernel,
                                   padding=kernel // 2), nn.ReLU())


def zero_init(conv: nn.Conv2d) -> nn.Conv2d:
    """Mark a conv whose weight and bias start at zero (``msi.main.
    init_weights`` reads the mark)."""
    conv.zero_init = True
    return conv


def non_local(theta, phi, g):
    """softmax(theta phi^T) g over flattened positions: theta (B,C,Hq,Wq),
    phi and g (B,C,H,W) -> (B,C,H,W) (the query grid is H×W too)."""
    b, c, h, w = g.shape
    th = theta.flatten(2).transpose(1, 2)
    f = th @ phi.flatten(2)
    y = f.softmax(dim=-1) @ g.flatten(2).transpose(1, 2)
    return y.transpose(1, 2).reshape(b, c, h, w)


class NonLocalBlock2D(nn.Module):
    def __init__(self, channels: int, inter: int):
        super().__init__()
        self.g = nn.Conv2d(channels, inter, 1)
        self.theta = nn.Conv2d(channels, inter, 1)
        self.phi = nn.Conv2d(channels, inter, 1)
        self.W = zero_init(nn.Conv2d(inter, channels, 1))

    def forward(self, x):
        return self.W(non_local(self.theta(x), self.phi(x), self.g(x))) + x


class AdjustedNonLocalBlock(nn.Module):
    def __init__(self, channels: int, inter: int):
        super().__init__()
        self.g = nn.Conv2d(channels, inter, 1)
        self.theta = nn.Conv2d(channels, inter, 1)
        self.phi = nn.Conv2d(channels, inter, 1)
        self.W = zero_init(nn.Conv2d(inter, channels, 1))

    def forward(self, x0, x1):
        return self.W(non_local(self.theta(x1), self.phi(x0),
                                self.g(x0))) + x0


class SSEM(nn.Module):
    def __init__(self, feats: int):
        super().__init__()
        self.head = nn.Sequential(basic_block(feats))
        self.MB = nn.Sequential(basic_block(feats), basic_block(feats))
        self.AB = nn.Sequential(NonLocalBlock2D(feats, feats // 2),
                                nn.Conv2d(feats, feats, 1), nn.Sigmoid())
        self.tail = nn.Sequential(basic_block(feats))

    def forward(self, x):
        head = self.head(x)
        return x + self.tail(self.MB(head) * self.AB(head))


class HSEM(nn.Module):
    def __init__(self, feats: int):
        super().__init__()
        self.base_scale = nn.Sequential(SSEM(feats))
        self.down_scale = nn.Sequential(SSEM(feats))
        self.NonLocal_base = AdjustedNonLocalBlock(feats, feats // 2)
        self.tail = nn.Sequential(basic_block(feats))

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        x_base = self.base_scale(x)
        x_down = F.interpolate(x, size=(h // 2, w // 2), mode="bilinear",
                               align_corners=False)
        x_down = F.interpolate(self.down_scale(x_down), size=(h, w),
                               mode="bilinear", align_corners=False)
        return x + self.tail(self.NonLocal_base(x_base, x_down))


class BasicModule(nn.Module):
    def __init__(self, feats: int):
        super().__init__()
        self.head = nn.Sequential(basic_block(feats), basic_block(feats))
        self.body = nn.Sequential(HSEM(feats))
        self.tail = nn.Sequential(basic_block(feats), basic_block(feats))

    def forward(self, x):
        return x + self.tail(self.body(self.head(x)))


class HSENet(nn.Module):
    def __init__(self, scale: int = 4, n_feats: int = 64,
                 n_basic_modules: int = 10, n_colors: int = 3):
        super().__init__()
        self.register_buffer("mean", torch.tensor(UCM_RGB_MEAN),
                             persistent=False)
        self.head = nn.Sequential(nn.Conv2d(n_colors, n_feats, 3, padding=1))
        self.body_modulist = nn.ModuleList(
            BasicModule(n_feats) for _ in range(n_basic_modules))
        self.tail = nn.Sequential(
            pixelshuffle_upsampler(scale, n_feats),
            nn.Conv2d(n_feats, n_colors, 3, padding=1))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """(B,H,W,3) in [0, 1] -> (B, H*scale, W*scale, 3); draws
        nothing."""
        x = self.head((x - self.mean).permute(0, 3, 1, 2))
        skip = x
        for bm in self.body_modulist:
            x = bm(x)
        return self.tail(skip + x).permute(0, 2, 3, 1) + self.mean
