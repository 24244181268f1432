"""Flax FastDiffSR UNet params -> the port's torch ``state_dict``.

The inverse direction of ``fastdiffsr_tpu/models/convert.py``
(``torch_unet_to_flax``). Input is the nested dict of numpy arrays that
``FastDiffSRUNet.init(...)["params"]`` gives after ``np.asarray`` on each
leaf, which is also the ``params`` entry of a JAX pickle checkpoint. The
output keys are the reference's torch names, which
:class:`~fastdiffsr_tpu_torch.models.unet_fastdiffsr.FastDiffSRUNet`
uses, so ``net.load_state_dict(flax_params_to_torch(tree))`` loads it.

Layouts: conv kernel (kh,kw,I,O) HWIO -> weight (O,I,kh,kw) OIHW; Dense
kernel (I,O) -> Linear weight (O,I); the CLAM Dense kernels -> 1x1 conv
weights (O,I,1,1); GroupNorm scale/bias -> weight/bias. The fused forward
turns the conv weights back to HWIO once, in
``unet_fastdiffsr_fused.prepare_fused_params``.

:func:`optax_state_to_torch` converts the optimizer state of a JAX
checkpoint: optax's moment trees have the params' structure and go
through the same key map.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence

import numpy as np
import torch


def _conv_w(k) -> np.ndarray:
    return np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1))


def _dense_w(k) -> np.ndarray:
    return np.transpose(np.asarray(k, np.float32), (1, 0))


def _flatten(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_BLOCK_LEAF = {("norm", "scale"): "block.0.weight",
               ("norm", "bias"): "block.0.bias",
               ("conv", "kernel"): "block.3.weight",
               ("conv", "bias"): "block.3.bias"}


def _res_block_key(rest: tuple) -> str:
    """('block1','norm','scale') etc. -> key under ``res_block.``."""
    head = rest[0]
    if head in ("block1", "block2"):
        return f"{head}.{_BLOCK_LEAF[rest[1:]]}"
    if head == "noise_dense":
        return f"noise_func.noise_func.0.{_param(rest[1])}"
    if head == "res_conv":
        return f"res_conv.{_param(rest[1])}"
    raise KeyError(rest)


def _param(leaf: str) -> str:
    return {"kernel": "weight", "bias": "bias", "scale": "weight"}[leaf]


def flax_params_to_torch(params: dict) -> Dict[str, torch.Tensor]:
    """Convert a Flax FastDiffSR UNet params tree to a torch state dict."""
    sd: Dict[str, np.ndarray] = {}
    for path, val in _flatten(params):
        val = np.asarray(val, np.float32)
        top, rest = path[0], path[1:]
        is_kernel = rest[-1] == "kernel"
        if top in ("mlp_dense1", "mlp_dense2"):
            idx = {"mlp_dense1": 1, "mlp_dense2": 3}[top]
            sd[f"noise_level_mlp.{idx}.{_param(rest[-1])}"] = (
                _dense_w(val) if is_kernel else val)
            continue
        if top == "final_block":
            sd[f"final_conv.{_BLOCK_LEAF[rest]}"] = (
                _conv_w(val) if is_kernel else val)
            continue
        m = re.fullmatch(r"(downs|ups|mid)_(\d+)", top)
        if m is None:
            raise KeyError(f"unexpected Flax param {'/'.join(path)}")
        base = f"{m.group(1)}.{m.group(2)}"
        if rest in (("kernel",), ("bias",)):             # stem conv
            sd[f"{base}.{_param(rest[0])}"] = (
                _conv_w(val) if is_kernel else val)
        elif rest[0] == "conv":                          # Down/Upsample
            sd[f"{base}.conv.{_param(rest[1])}"] = (
                _conv_w(val) if is_kernel else val)
        elif rest[0] == "res_block":
            key = _res_block_key(rest[1:])
            dense = rest[1] == "noise_dense"
            sd[f"{base}.res_block.{key}"] = (
                (_dense_w(val) if dense else _conv_w(val)) if is_kernel
                else val)
        elif rest[0] == "ca":                            # CLAM fc1/fc2
            sd[f"{base}.ca.{rest[1]}.weight"] = _dense_w(val)[:, :, None,
                                                              None]
        elif rest[0] == "sa":                            # SLAM 7x7
            sd[f"{base}.sa.conv1.weight"] = _conv_w(val)
        else:
            raise KeyError(f"unexpected Flax param {'/'.join(path)}")
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


def optax_state_to_torch(opt_state: Sequence,
                         param_names: Sequence[str]) -> dict:
    """The ``state`` entry of a torch optimizer state dict from an optax
    chain state (a tuple of optax states, e.g. ``(ScaleByAdamState(count,
    mu, nu), EmptyState())``, or stand-ins with the same class names and
    fields). ``param_names`` lists the torch parameter names in the
    optimizer's order. Adam's moments become ``exp_avg``/``exp_avg_sq``
    with ``step`` = count, as torch.optim.Adam/AdamW keep them."""
    by_name = {type(s).__name__: s for s in opt_state}
    if "ScaleByAdamState" not in by_name:
        raise NotImplementedError(
            f"optax state {sorted(by_name)}: only Adam/AdamW moments are "
            "converted")
    count, mu, nu = by_name["ScaleByAdamState"]
    mu, nu = flax_params_to_torch(mu), flax_params_to_torch(nu)
    step = float(np.asarray(count))
    return {i: {"step": torch.tensor(step), "exp_avg": mu[name],
                "exp_avg_sq": nu[name]}
            for i, name in enumerate(param_names)}
