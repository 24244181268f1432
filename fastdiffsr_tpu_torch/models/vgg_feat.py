"""VGG19 feature extractor for the perceptual/content losses: counterpart
of ``fastdiffsr_tpu/models/vgg_feat.py``.

``VGGFeatureExtractor`` computes ``features[: feature_layer + 1]`` of
torchvision's VGG19 (cfg 'E', optionally with BatchNorm) on NHWC input in
[0, 1], ImageNet-normalised with ``use_input_norm`` (the BasicSR
convention of EDiffSR's ``define_F``). ``msi_feature_extractor`` is the
MSI content-loss one (MSI_SR_model/model/swinir.py:60-70):
``features[:12]`` (through relu3_1), no input normalisation.

The torchvision weights cannot be downloaded here, so they stay gated as
in the JAX package: ``load_default`` reads the same ``.npz`` pack
(``conv{i}_w`` HWIO, ``conv{i}_b``, ``bn{i}_{scale,bias,mean,var}`` by
``features`` index) from ``FASTDIFFSR_TPU_VGG`` or
``fastdiffsr_tpu_torch/assets/vgg19.npz``, and raises without one.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

# torchvision VGG19 cfg 'E'
_CFG: Tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
               512, 512, 512, 512, "M", 512, 512, 512, 512, "M")

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def layer_table(use_bn: bool = False) -> List[Tuple[str, Optional[int]]]:
    """torchvision ``features`` index table: (kind, out_ch) per index,
    kind in {conv, bn, relu, pool}."""
    table: List[Tuple[str, Optional[int]]] = []
    for v in _CFG:
        if v == "M":
            table.append(("pool", None))
        else:
            table.append(("conv", v))
            if use_bn:
                table.append(("bn", v))
            table.append(("relu", None))
    return table


class VGGFeatureExtractor(nn.Module):
    """Feature maps of ``features[: feature_layer + 1]`` from a pack's
    params dict. Input (B,H,W,3) in [0, 1]; output NHWC."""

    def __init__(self, params: Dict[str, np.ndarray],
                 feature_layer: int = 34, use_bn: bool = False,
                 use_input_norm: bool = True):
        super().__init__()
        self.feature_layer = int(feature_layer)
        self.use_input_norm = use_input_norm
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD),
                             persistent=False)
        layers, cin = [], 3
        for i, (kind, c) in enumerate(
                layer_table(use_bn)[: self.feature_layer + 1]):
            if kind == "conv":
                conv = nn.Conv2d(cin, c, 3, padding=1)
                conv.weight.data = torch.from_numpy(np.ascontiguousarray(
                    np.transpose(params[f"conv{i}_w"], (3, 2, 0, 1)),
                    np.float32))
                conv.bias.data = torch.from_numpy(
                    np.asarray(params[f"conv{i}_b"], np.float32))
                layers.append(conv)
                cin = c
            elif kind == "bn":
                bn = nn.BatchNorm2d(c, eps=1e-5).eval()
                for attr, key in (("weight", "scale"), ("bias", "bias"),
                                  ("running_mean", "mean"),
                                  ("running_var", "var")):
                    getattr(bn, attr).data = torch.from_numpy(
                        np.asarray(params[f"bn{i}_{key}"], np.float32))
                layers.append(bn)
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        return self.features(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def msi_feature_extractor(params: Dict[str, np.ndarray]
                          ) -> VGGFeatureExtractor:
    """The MSI content-loss extractor: ``features[:12]`` (index 11,
    relu3_1), no input normalisation."""
    return VGGFeatureExtractor(params, feature_layer=11,
                               use_input_norm=False)


def load_default(feature_layer: int = 34, use_input_norm: bool = True,
                 device="cpu") -> VGGFeatureExtractor:
    """The extractor from the converted weight pack; FileNotFoundError
    without one."""
    path = os.environ.get(
        "FASTDIFFSR_TPU_VGG",
        os.path.join(os.path.dirname(__file__), "..", "assets", "vgg19.npz"))
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"VGG19 weight pack not found at {path}; set FASTDIFFSR_TPU_VGG "
            "to the pack the JAX package's vgg_feat --export writes")
    with np.load(path) as data:
        params = {k: data[k] for k in data.files}
    return VGGFeatureExtractor(params, feature_layer=feature_layer,
                               use_input_norm=use_input_norm).to(device)

