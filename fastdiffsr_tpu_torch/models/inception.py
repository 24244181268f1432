"""InceptionV3 (FID variant) feature extractor in PyTorch.

Counterpart of ``fastdiffsr_tpu/models/inception.py``. The reference
scores FID with ``pytorch_fid`` (reference FID.py:5-21): torchvision's
Inception3 with the FID pooling tweaks (the 3x3 average pools of the
A/C/E blocks do not count their padding; ``Mixed_7c`` pools its branch
with a 3x3 max-pool where ``Mixed_7b`` averages) and the TF-ported
weights. Neither torchvision nor the weights are fetched here, so the
graph lives here and the weights come from the ``.npz`` pack that the
JAX package reads (``FASTDIFFSR_TPU_INCEPTION``, or else
``fastdiffsr_tpu_torch/assets/inception_fid.npz``): torchvision
state-dict names, conv kernels HWIO (``params_from_pack`` turns them to
OIHW).

Input contract (pytorch_fid's): NHWC float in [0, 1], resized to
299x299 bilinearly at half-pixel centres without antialiasing
(``F.interpolate(..., align_corners=False, antialias=False)``, as the JAX
extractor's ``jax.image.resize(..., "bilinear", antialias=False)``),
scaled to [-1, 1]; output the (B, 2048) pool3 features.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3  # torchvision BasicConv2d BatchNorm2d(eps=0.001)
SIZE = 299


def _conv_bn(p: Dict, prefix: str, x, stride=1, padding=(0, 0)):
    """BasicConv2d: bias-free conv, then BatchNorm (running statistics),
    then ReLU."""
    x = F.conv2d(x, p[f"{prefix}.conv.weight"], stride=stride,
                 padding=padding)

    def v(name):
        return p[f"{prefix}.bn.{name}"].view(1, -1, 1, 1)
    x = ((x - v("running_mean")) * torch.rsqrt(v("running_var") + BN_EPS)
         * v("weight") + v("bias"))
    return F.relu(x)


def _avg_pool_3x3_nocountpad(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _inception_a(p, pre, x):
    b1 = _conv_bn(p, f"{pre}.branch1x1", x)
    b5 = _conv_bn(p, f"{pre}.branch5x5_1", x)
    b5 = _conv_bn(p, f"{pre}.branch5x5_2", b5, padding=(2, 2))
    b3 = _conv_bn(p, f"{pre}.branch3x3dbl_1", x)
    b3 = _conv_bn(p, f"{pre}.branch3x3dbl_2", b3, padding=(1, 1))
    b3 = _conv_bn(p, f"{pre}.branch3x3dbl_3", b3, padding=(1, 1))
    bp = _conv_bn(p, f"{pre}.branch_pool", _avg_pool_3x3_nocountpad(x))
    return torch.cat([b1, b5, b3, bp], 1)


def _inception_b(p, pre, x):
    b3 = _conv_bn(p, f"{pre}.branch3x3", x, stride=2)
    bd = _conv_bn(p, f"{pre}.branch3x3dbl_1", x)
    bd = _conv_bn(p, f"{pre}.branch3x3dbl_2", bd, padding=(1, 1))
    bd = _conv_bn(p, f"{pre}.branch3x3dbl_3", bd, stride=2)
    return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)


def _inception_c(p, pre, x):
    p13, p31 = (0, 3), (3, 0)
    b1 = _conv_bn(p, f"{pre}.branch1x1", x)
    b7 = _conv_bn(p, f"{pre}.branch7x7_1", x)
    b7 = _conv_bn(p, f"{pre}.branch7x7_2", b7, padding=p13)
    b7 = _conv_bn(p, f"{pre}.branch7x7_3", b7, padding=p31)
    bd = _conv_bn(p, f"{pre}.branch7x7dbl_1", x)
    bd = _conv_bn(p, f"{pre}.branch7x7dbl_2", bd, padding=p31)
    bd = _conv_bn(p, f"{pre}.branch7x7dbl_3", bd, padding=p13)
    bd = _conv_bn(p, f"{pre}.branch7x7dbl_4", bd, padding=p31)
    bd = _conv_bn(p, f"{pre}.branch7x7dbl_5", bd, padding=p13)
    bp = _conv_bn(p, f"{pre}.branch_pool", _avg_pool_3x3_nocountpad(x))
    return torch.cat([b1, b7, bd, bp], 1)


def _inception_d(p, pre, x):
    b3 = _conv_bn(p, f"{pre}.branch3x3_1", x)
    b3 = _conv_bn(p, f"{pre}.branch3x3_2", b3, stride=2)
    b7 = _conv_bn(p, f"{pre}.branch7x7x3_1", x)
    b7 = _conv_bn(p, f"{pre}.branch7x7x3_2", b7, padding=(0, 3))
    b7 = _conv_bn(p, f"{pre}.branch7x7x3_3", b7, padding=(3, 0))
    b7 = _conv_bn(p, f"{pre}.branch7x7x3_4", b7, stride=2)
    return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


def _inception_e(p, pre, x, pool: str):
    b1 = _conv_bn(p, f"{pre}.branch1x1", x)
    b3 = _conv_bn(p, f"{pre}.branch3x3_1", x)
    b3 = torch.cat([_conv_bn(p, f"{pre}.branch3x3_2a", b3, padding=(0, 1)),
                    _conv_bn(p, f"{pre}.branch3x3_2b", b3, padding=(1, 0))],
                   1)
    bd = _conv_bn(p, f"{pre}.branch3x3dbl_1", x)
    bd = _conv_bn(p, f"{pre}.branch3x3dbl_2", bd, padding=(1, 1))
    bd = torch.cat([
        _conv_bn(p, f"{pre}.branch3x3dbl_3a", bd, padding=(0, 1)),
        _conv_bn(p, f"{pre}.branch3x3dbl_3b", bd, padding=(1, 0))], 1)
    if pool == "max":                   # FIDInceptionE_2 (pytorch_fid)
        bp = F.max_pool2d(x, 3, stride=1, padding=1)
    else:                               # FIDInceptionE_1
        bp = _avg_pool_3x3_nocountpad(x)
    bp = _conv_bn(p, f"{pre}.branch_pool", bp)
    return torch.cat([b1, b3, bd, bp], 1)


def inception_pool3(params: Dict[str, torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
    """(B, 299, 299, 3) in [-1, 1] -> (B, 2048) pool3 features."""
    x = x.permute(0, 3, 1, 2)
    x = _conv_bn(params, "Conv2d_1a_3x3", x, stride=2)
    x = _conv_bn(params, "Conv2d_2a_3x3", x)
    x = _conv_bn(params, "Conv2d_2b_3x3", x, padding=(1, 1))
    x = F.max_pool2d(x, 3, 2)
    x = _conv_bn(params, "Conv2d_3b_1x1", x)
    x = _conv_bn(params, "Conv2d_4a_3x3", x)
    x = F.max_pool2d(x, 3, 2)
    for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _inception_a(params, name, x)
    x = _inception_b(params, "Mixed_6a", x)
    for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _inception_c(params, name, x)
    x = _inception_d(params, "Mixed_7a", x)
    x = _inception_e(params, "Mixed_7b", x, pool="avg")
    x = _inception_e(params, "Mixed_7c", x, pool="max")
    return x.mean(dim=(2, 3))           # adaptive average pool to 1x1


def resize_299(x01: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) -> (B,299,299,C), bilinear at half-pixel centres, no
    antialiasing (pytorch_fid's resize)."""
    y = F.interpolate(x01.permute(0, 3, 1, 2), size=(SIZE, SIZE),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def _a(i, pool):
    return [("branch1x1", i, 64, 1, 1), ("branch5x5_1", i, 48, 1, 1),
            ("branch5x5_2", 48, 64, 5, 5), ("branch3x3dbl_1", i, 64, 1, 1),
            ("branch3x3dbl_2", 64, 96, 3, 3),
            ("branch3x3dbl_3", 96, 96, 3, 3), ("branch_pool", i, pool, 1, 1)]


def _c(c7):
    return [("branch1x1", 768, 192, 1, 1), ("branch7x7_1", 768, c7, 1, 1),
            ("branch7x7_2", c7, c7, 1, 7), ("branch7x7_3", c7, 192, 7, 1),
            ("branch7x7dbl_1", 768, c7, 1, 1),
            ("branch7x7dbl_2", c7, c7, 7, 1),
            ("branch7x7dbl_3", c7, c7, 1, 7),
            ("branch7x7dbl_4", c7, c7, 7, 1),
            ("branch7x7dbl_5", c7, 192, 1, 7),
            ("branch_pool", 768, 192, 1, 1)]


def _e(i):
    return [("branch1x1", i, 320, 1, 1), ("branch3x3_1", i, 384, 1, 1),
            ("branch3x3_2a", 384, 384, 1, 3),
            ("branch3x3_2b", 384, 384, 3, 1),
            ("branch3x3dbl_1", i, 448, 1, 1),
            ("branch3x3dbl_2", 448, 384, 3, 3),
            ("branch3x3dbl_3a", 384, 384, 1, 3),
            ("branch3x3dbl_3b", 384, 384, 3, 1),
            ("branch_pool", i, 192, 1, 1)]


# every BasicConv2d of the graph: (name, in, out, kernel h, kernel w)
CONVS = (
    [("Conv2d_1a_3x3", 3, 32, 3, 3), ("Conv2d_2a_3x3", 32, 32, 3, 3),
     ("Conv2d_2b_3x3", 32, 64, 3, 3), ("Conv2d_3b_1x1", 64, 80, 1, 1),
     ("Conv2d_4a_3x3", 80, 192, 3, 3)]
    + [(f"{m}.{n}", *r) for m, (i, pool) in
       (("Mixed_5b", (192, 32)), ("Mixed_5c", (256, 64)),
        ("Mixed_5d", (288, 64))) for n, *r in _a(i, pool)]
    + [(f"Mixed_6a.{n}", *r) for n, *r in
       [("branch3x3", 288, 384, 3, 3), ("branch3x3dbl_1", 288, 64, 1, 1),
        ("branch3x3dbl_2", 64, 96, 3, 3), ("branch3x3dbl_3", 96, 96, 3, 3)]]
    + [(f"{m}.{n}", *r) for m, c7 in
       (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
        ("Mixed_6e", 192)) for n, *r in _c(c7)]
    + [(f"Mixed_7a.{n}", *r) for n, *r in
       [("branch3x3_1", 768, 192, 1, 1), ("branch3x3_2", 192, 320, 3, 3),
        ("branch7x7x3_1", 768, 192, 1, 1), ("branch7x7x3_2", 192, 192, 1, 7),
        ("branch7x7x3_3", 192, 192, 7, 1),
        ("branch7x7x3_4", 192, 192, 3, 3)]]
    + [(f"{m}.{n}", *r) for m, i in (("Mixed_7b", 1280), ("Mixed_7c", 2048))
       for n, *r in _e(i)])


def pack_shapes() -> Dict[str, tuple]:
    """The shape of every array of a weight pack (conv kernels HWIO)."""
    out = {}
    for name, i, o, kh, kw in CONVS:
        out[f"{name}.conv.weight"] = (kh, kw, i, o)
        for t in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.bn.{t}"] = (o,)
    return out


def random_pack(seed: int) -> Dict[str, np.ndarray]:
    """A seeded weight pack of the right shapes, for checks where the
    real weights are absent: He-scaled kernels (so pool3 still depends on
    the input), BatchNorm scale 1, shift 0, running mean 0.05 N, running
    variance 1 + 0.3 U."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in pack_shapes().items():
        if k.endswith(".conv.weight"):
            v = rng.standard_normal(shape) * np.sqrt(
                2.0 / np.prod(shape[:3]))
        elif k.endswith("running_mean"):
            v = 0.05 * rng.standard_normal(shape)
        elif k.endswith("running_var"):
            v = 1.0 + 0.3 * rng.uniform(size=shape)
        else:
            v = np.ones(shape) if k.endswith("bn.weight") else np.zeros(shape)
        out[k] = v.astype(np.float32)
    return out


def params_from_pack(pack) -> Dict[str, torch.Tensor]:
    """The graph's tensors from a weight pack's arrays (torchvision names;
    conv kernels HWIO -> OIHW, BatchNorm tensors as they are). A pack
    that lacks an array of the graph, or holds one of another shape,
    raises, naming it; arrays the graph does not use (the classifier's)
    are left out."""
    out = {}
    for k, shape in pack_shapes().items():
        if k not in pack:
            raise KeyError(f"Inception weight pack lacks {k!r}")
        arr = np.asarray(pack[k], np.float32)
        if arr.shape != shape:
            raise ValueError(f"Inception weight pack: {k!r} has shape "
                             f"{arr.shape}, the graph wants {shape}")
        if k.endswith(".conv.weight"):
            arr = arr.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


class InceptionFID(nn.Module):
    """pytorch_fid-compatible feature extractor on an explicit device:
    resize to 299, scale to [-1, 1], pool3 features."""

    def __init__(self, params: Dict[str, torch.Tensor], device="cpu"):
        super().__init__()
        self.params = {k: v.to(device=device, dtype=torch.float32)
                       for k, v in params.items()}
        self.device = torch.device(device)

    @torch.no_grad()
    def forward(self, x01) -> np.ndarray:
        """x01: (B,H,W,C) float in [0, 1] (numpy or tensor) -> (B, 2048)
        numpy float32."""
        x = torch.as_tensor(np.asarray(x01, np.float32), device=self.device)
        return inception_pool3(self.params,
                               resize_299(x) * 2.0 - 1.0).cpu().numpy()


def default_pack_path() -> str:
    return os.environ.get(
        "FASTDIFFSR_TPU_INCEPTION",
        os.path.join(os.path.dirname(__file__), "..", "assets",
                     "inception_fid.npz"))


def load_default(device="cpu") -> InceptionFID:
    path = default_pack_path()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Inception FID weight pack not found at {path}; export with "
            "python -m fastdiffsr_tpu.models.inception --export "
            "(requires pytorch_fid or torchvision)")
    with np.load(path) as pack:
        return InceptionFID(params_from_pack(pack), device=device)
