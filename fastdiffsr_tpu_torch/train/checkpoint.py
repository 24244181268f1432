"""Checkpoint save/resume with reference-compatible naming.

Counterpart of ``fastdiffsr_tpu/train/checkpoint.py``. One directory
``I{iter}_E{epoch}`` per save point holds ``state.pt``, a ``torch.save``
payload {step, epoch, params, ema_params, opt_state}: params and
ema_params are state dicts of the UNet, opt_state is the optimizer's
state dict. ``load_state`` and ``load_params_only`` also read the JAX
package's pickle backend (``state.pkl``): its Flax trees go through the
converter of the run's variant (``models.convert.flax_converter``: a
UNet variant of the main framework, or an EDiffSR denoiser,
``ConditionalNAFNet`` / ``ConditionalUNet``, whose AdamW/Adam/Lion states
carry a schedule count that equals the step). Its ``orbax/`` backend is
not readable here. :func:`load_reference_gen_pth`
reads a reference ``I*_E*_gen.pth``.
"""

from __future__ import annotations

import collections
import os
import pickle
from typing import Dict

import numpy as np
import torch

from ..models.convert import (flax_converter, optax_state_to_torch,
                              strip_diffusion_prefix)
from .state import TrainState

# optax states a JAX pickle names, as plain stand-ins (pickle rebuilds a
# NamedTuple from its fields in order)
_OPTAX = {
    ("optax._src.transform", "ScaleByAdamState"):
        collections.namedtuple("ScaleByAdamState", "count mu nu"),
    ("optax._src.transform", "ScaleByLionState"):
        collections.namedtuple("ScaleByLionState", "count mu"),
    # the count of an optimizer built on a schedule (EDiffSR's)
    ("optax._src.transform", "ScaleByScheduleState"):
        collections.namedtuple("ScaleByScheduleState", "count"),
    ("optax._src.base", "EmptyState"):
        collections.namedtuple("EmptyState", ""),
}
_NUMPY = {"_reconstruct", "scalar", "ndarray", "dtype"}


class _JaxCheckpointUnpickler(pickle.Unpickler):
    """Reads a JAX ``save_state`` pickle without importing optax or jax:
    only numpy arrays, builtin containers and the optax states above are
    rebuilt; any other class is refused. numpy 2 writes its arrays as
    ``numpy._core.*``, which numpy 1.x calls ``numpy.core.*``."""

    def find_class(self, module, name):
        if (module, name) in _OPTAX:
            return _OPTAX[(module, name)]
        if module in ("numpy", "numpy._core.multiarray",
                      "numpy.core.multiarray") and name in _NUMPY:
            if module == "numpy":
                return getattr(np, name)
            try:
                return super().find_class(module, name)
            except ModuleNotFoundError:
                return super().find_class(
                    module.replace("numpy._core", "numpy.core"), name)
        raise pickle.UnpicklingError(
            f"JAX checkpoint names {module}.{name}, which the port does not "
            "read")


def _read_jax_pickle(path: str) -> dict:
    with open(path, "rb") as f:
        return _JaxCheckpointUnpickler(f).load()


def _find(prefix: str) -> tuple:
    """('torch' | 'jax', file) of the checkpoint under ``prefix``."""
    for kind, name in (("torch", "state.pt"), ("jax", "state.pkl")):
        path = os.path.join(prefix, name)
        if os.path.isfile(path):
            return kind, path
    if os.path.isdir(os.path.join(prefix, "orbax")):
        raise ValueError(
            f"{prefix!r} is an Orbax checkpoint of the JAX package, which "
            "the port cannot read: save it with FASTDIFFSR_TPU_CKPT=pickle")
    raise FileNotFoundError(f"no checkpoint found under {prefix!r} "
                            "(neither state.pt nor state.pkl)")


def save_state(state: TrainState, ckpt_dir: str, *, it=None,
               epoch=None) -> str:
    """Write ``{ckpt_dir}/I{it}_E{epoch}/state.pt`` (atomically) and
    return the directory."""
    it = state.step if it is None else int(it)
    epoch = state.epoch if epoch is None else int(epoch)
    path = os.path.join(ckpt_dir, f"I{it}_E{epoch}")
    os.makedirs(path, exist_ok=True)
    payload = {"step": int(state.step), "epoch": epoch,
               "params": state.net.state_dict(),
               "ema_params": state.ema_params,
               "opt_state": state.optimizer.state_dict()}
    tmp = os.path.join(path, "state.pt.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, "state.pt"))
    return path


def load_state(prefix: str, state: TrainState, variant: str) -> TrainState:
    """Restore ``state`` in place from a checkpoint directory of either
    package (reference-style prefix '.../I896896_E196'); ``variant``
    (``which_model_G``) names the UNet of a JAX checkpoint's trees."""
    kind, path = _find(prefix)
    dev = next(state.net.parameters()).device
    names = [n for n, _ in state.net.named_parameters()]
    if kind == "torch":
        payload = torch.load(path, map_location=dev, weights_only=True)
        params, ema = payload["params"], payload["ema_params"]
        opt_sd = payload["opt_state"]
    else:
        payload = _read_jax_pickle(path)
        convert = flax_converter(variant)
        params = convert(payload["params"])
        ema = convert(payload["ema_params"])
        opt_sd = {"state": optax_state_to_torch(payload["opt_state"], names,
                                                variant),
                  "param_groups": state.optimizer.state_dict()[
                      "param_groups"]}
    state.net.load_state_dict(params)
    state.optimizer.load_state_dict(opt_sd)
    with torch.no_grad():
        for k in names:
            state.ema_params[k].copy_(ema[k])
    state.step = int(payload["step"])
    state.epoch = int(payload["epoch"])
    return state


def load_params_only(prefix: str, use_ema: bool = False, *, variant: str
                     ) -> Dict[str, torch.Tensor]:
    """The UNet state dict (EMA params with ``use_ema``) of a checkpoint
    directory of either package, on the CPU; ``variant`` names the UNet
    of a JAX checkpoint's tree."""
    key = "ema_params" if use_ema else "params"
    kind, path = _find(prefix)
    if kind == "torch":
        return torch.load(path, map_location="cpu", weights_only=True)[key]
    return flax_converter(variant)(_read_jax_pickle(path)[key])


def load_reference_gen_pth(path: str, *, variant: str
                           ) -> Dict[str, torch.Tensor]:
    """The UNet state dict of a reference ``*_gen.pth`` (the
    GaussianDiffusion state dict, or a bare UNet one), on the CPU in
    float32: the ``denoise_fn.`` prefix and the schedule buffers go
    (``models.convert.strip_diffusion_prefix``). The names are the
    port's, so ``net.load_state_dict(..., strict=True)`` takes the
    result, and raises, naming them, for keys ``variant``'s UNet lacks.
    Counterpart of the JAX package's
    ``train/checkpoint.py::load_reference_gen_pth``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = strip_diffusion_prefix(sd)
    return {k: v.float() for k, v in sd.items()}
