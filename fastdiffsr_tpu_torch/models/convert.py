"""Flax UNet params -> the port's torch ``state_dict``.

The inverse direction of ``fastdiffsr_tpu/models/convert.py``:
:func:`flax_params_to_torch` inverts ``torch_unet_to_flax`` on FastDiffSR
trees, :func:`flax_sr3_params_to_torch` on the SR3 trees of ddpm/tesr,
:func:`flax_guided_params_to_torch` inverts ``torch_guided_unet_to_flax``
(gdp), and :func:`flax_converter` picks one by variant. Input is the
nested dict of numpy arrays that ``net.init(...)["params"]`` gives after
``np.asarray`` on each leaf, which is also the ``params`` entry of a JAX
pickle checkpoint. The output keys are the reference's torch names,
which the port's UNets use, so ``net.load_state_dict(convert(tree))``
loads it.

Layouts: conv kernel (kh,kw,I,O) HWIO -> weight (O,I,kh,kw) OIHW; Dense
kernel (I,O) -> Linear weight (O,I); the CLAM Dense kernels -> 1x1 conv
weights (O,I,1,1); the guided attention's Dense kernels -> Conv1d
weights (O,I,1); GroupNorm scale/bias -> weight/bias. The fused forward
turns the conv weights back to HWIO once, in
``unet_fastdiffsr_fused.prepare_fused_params``.

:func:`optax_state_to_torch` converts the optimizer state of a JAX
checkpoint: optax's moment trees have the params' structure and go
through the same key map.

A reference ``*_gen.pth`` needs no converter: its UNet keys are the
port's names under ``denoise_fn.``. :func:`strip_diffusion_prefix` takes
them out of the diffusion wrapper, and ``python -m
fastdiffsr_tpu_torch.models.convert`` (:func:`main`) writes them as a
state-dict file.
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
    if head == "noise_dense":                            # FastDiffSR
        return f"noise_func.noise_func.0.{_param(rest[1])}"
    if head == "mlp_dense":                              # SR3
        return f"mlp.1.{_param(rest[1])}"
    if head == "res_conv":
        return f"res_conv.{_param(rest[1])}"
    raise KeyError(rest)


def _param(leaf: str) -> str:
    return {"kernel": "weight", "bias": "bias", "scale": "weight"}[leaf]


def _to_torch(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


def _sr3_family_to_torch(params: dict, time_mlp: str
                         ) -> Dict[str, torch.Tensor]:
    """The FastDiffSR and SR3 trees share their layout; they differ in
    the time MLP's torch name and in the leaves a tree holds (CLAM/SLAM
    and ``noise_dense`` for FastDiffSR, ``mlp_dense`` and ``attn`` for
    SR3)."""
    sd: Dict[str, np.ndarray] = {}
    for path, val in _flatten(params):
        val = np.asarray(val, np.float32)
        top, rest = path[0], path[1:]
        is_kernel = rest[-1] == "kernel"
        if top in ("mlp_dense1", "mlp_dense2"):
            idx = {"mlp_dense1": 1, "mlp_dense2": 3}[top]
            sd[f"{time_mlp}.{idx}.{_param(rest[-1])}"] = (
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
            dense = rest[1] in ("noise_dense", "mlp_dense")
            sd[f"{base}.res_block.{key}"] = (
                (_dense_w(val) if dense else _conv_w(val)) if is_kernel
                else val)
        elif rest[0] == "attn":                          # SR3 attention
            sd[f"{base}.attn.{rest[1]}.{_param(rest[2])}"] = (
                _conv_w(val) if is_kernel else val)
        elif rest[0] == "ca":                            # CLAM fc1/fc2
            sd[f"{base}.ca.{rest[1]}.weight"] = _dense_w(val)[:, :, None,
                                                              None]
        elif rest[0] == "sa":                            # SLAM 7x7
            sd[f"{base}.sa.conv1.weight"] = _conv_w(val)
        else:
            raise KeyError(f"unexpected Flax param {'/'.join(path)}")
    return _to_torch(sd)


def flax_params_to_torch(params: dict) -> Dict[str, torch.Tensor]:
    """Convert a Flax FastDiffSR UNet params tree to a torch state dict."""
    return _sr3_family_to_torch(params, "noise_level_mlp")


def flax_sr3_params_to_torch(params: dict) -> Dict[str, torch.Tensor]:
    """Convert a Flax ``SR3UNet`` (ddpm/tesr) params tree to the state
    dict of :class:`~fastdiffsr_tpu_torch.models.unet_sr3.SR3UNet`: the
    inverse of ``torch_unet_to_flax`` on SR3 trees (``time_mlp``,
    ``res_block.mlp.1``, ``attn.{norm,qkv,out}`` as 1x1 convs)."""
    return _sr3_family_to_torch(params, "time_mlp")


# GuidedResBlock / GuidedAttention leaf -> (torch name, layout)
_GUIDED_LEAF = {"in_norm": ("in_layers.0", "norm"),
                "in_conv": ("in_layers.2", "conv"),
                "emb_dense": ("emb_layers.1", "dense"),
                "out_norm": ("out_layers.0", "norm"),
                "out_conv": ("out_layers.3", "conv"),
                "skip": ("skip_connection", "conv"),
                "norm": ("norm", "norm"),
                "qkv": ("qkv", "conv1d"),
                "proj_out": ("proj_out", "conv1d")}
_GUIDED_TOP = {"time_dense1": ("time_embed.0", "dense"),
               "time_dense2": ("time_embed.2", "dense"),
               "out_norm": ("out.0", "norm"),
               "out_conv": ("out.2", "conv"),
               "input_0_0": ("input_blocks.0.0", "conv")}


def _guided_leaf(kind: str, leaf: str, val: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return val
    if kind == "conv":
        return _conv_w(val)
    if kind == "dense":
        return _dense_w(val)
    return _dense_w(val)[:, :, None]                     # conv1d (O, I, 1)


def flax_guided_params_to_torch(params: dict) -> Dict[str, torch.Tensor]:
    """Convert a Flax ``GuidedUNet`` (gdp) params tree to the state dict
    of :class:`~fastdiffsr_tpu_torch.models.unet_guided.GuidedUNet`: the
    inverse of ``torch_guided_unet_to_flax``."""
    sd: Dict[str, np.ndarray] = {}
    for path, val in _flatten(params):
        val = np.asarray(val, np.float32)
        top, leaf = path[0], path[-1]
        if len(path) == 2 and top in _GUIDED_TOP:
            name, kind = _GUIDED_TOP[top]
        else:
            m = re.fullmatch(r"(input|middle|output)_(\d+)(?:_(\d+))?", top)
            if m is None or len(path) != 3 or path[1] not in _GUIDED_LEAF:
                raise KeyError(f"unexpected Flax param {'/'.join(path)}")
            lst, i, j = m.groups()
            block = (f"middle_block.{i}" if lst == "middle"
                     else f"{lst}_blocks.{i}.{j}")
            sub, kind = _GUIDED_LEAF[path[1]]
            name = f"{block}.{sub}"
        sd[f"{name}.{_param(leaf)}"] = _guided_leaf(kind, leaf, val)
    return _to_torch(sd)


def _nafblock_leaf(rest: tuple, val: np.ndarray):
    """(torch name under the block, value) of a Flax NAFBlock leaf."""
    if rest[0] in ("norm1_g", "norm2_g", "beta", "gamma"):
        name = {"norm1_g": "norm1.g", "norm2_g": "norm2.g"}.get(rest[0],
                                                               rest[0])
        return name, val.reshape(1, -1, 1, 1)
    sub = {"time_dense": "mlp.1", "sca_conv": "sca.1"}.get(rest[0], rest[0])
    if rest[-1] != "kernel":
        return f"{sub}.bias", val
    return f"{sub}.weight", (_dense_w(val) if rest[0] == "time_dense"
                             else _conv_w(val))


_NAF_ENHANCE = {"conv1": "rcab.0", "conv2": "rcab.2",
                "ca_fc1": "rcab.3.attention.1",
                "ca_fc2": "rcab.3.attention.3"}


def flax_nafnet_params_to_torch(params: dict) -> Dict[str, torch.Tensor]:
    """Convert a Flax ``ConditionalNAFNet`` params tree to the state dict
    of :class:`~fastdiffsr_tpu_torch.models.nafnet.ConditionalNAFNet`,
    whose names are the reference ``DenoisingNAFNet_arch``'s: the inverse
    of the JAX package's ``torch_nafnet_to_flax``. Both up modes share the
    tree (``up_i`` holds the 1x1 weights)."""
    sd: Dict[str, np.ndarray] = {}
    for path, val in _flatten(params):
        val = np.asarray(val, np.float32)
        top, rest = path[0], path[1:]
        is_kernel = rest[-1] == "kernel"
        m = re.fullmatch(r"(enc|dec)_(\d+)_(\d+)|middle_(\d+)", top)
        if m:
            if m.group(4) is not None:
                base = f"middle_blks.{m.group(4)}"
            else:
                lst = "encoders" if m.group(1) == "enc" else "decoders"
                base = f"{lst}.{m.group(2)}.{m.group(3)}"
            name, v = _nafblock_leaf(rest, val)
            sd[f"{base}.{name}"] = v
            continue
        if top in ("time_dense1", "time_dense2"):
            idx = 1 if top == "time_dense1" else 3
            sd[f"time_mlp.{idx}.{_param(rest[-1])}"] = (
                _dense_w(val) if is_kernel else val)
            continue
        if top == "enhance":
            name = f"enhance.{_NAF_ENHANCE[rest[0]]}"
        elif top in ("intro", "ending"):
            name = top
        else:
            m = re.fullmatch(r"(down|up)_(\d+)", top)
            if m is None:
                raise KeyError(f"unexpected Flax param {'/'.join(path)}")
            name = (f"downs.{m.group(2)}" if m.group(1) == "down"
                    else f"ups.{m.group(2)}.0")
        sd[f"{name}.{_param(rest[-1])}"] = _conv_w(val) if is_kernel else val
    return _to_torch(sd)


_COND_RES = {"time_dense": "mlp.1", "conv1": "block1.proj",
             "conv2": "block2.proj", "res_conv": "res_conv"}
_COND_ATTN = {"norm_g": "fn.norm.g", "to_qkv": "fn.fn.to_qkv",
              "to_out": "fn.fn.to_out.0", "out_norm_g": "fn.fn.to_out.1.g"}


def flax_cond_unet_params_to_torch(params: dict
                                   ) -> Dict[str, torch.Tensor]:
    """Convert a Flax ``ConditionalUNet`` params tree to the state dict of
    :class:`~fastdiffsr_tpu_torch.models.cond_unet.ConditionalUNet`, whose
    names are the reference ``DenoisingUNet_arch``'s. The torch ``ups``
    list holds level depth-1-k at index k (the reference builds it with
    ``insert(0, ...)``)."""
    depth = sum(1 for k in params if re.fullmatch(r"down_\d+_down", k))
    sd: Dict[str, np.ndarray] = {}
    for path, val in _flatten(params):
        val = np.asarray(val, np.float32)
        top, rest = path[0], path[1:]
        m = re.fullmatch(r"(down|up)_(\d+)_(b1|b2|attn|down|up)", top)
        if m:
            lvl = int(m.group(2))
            lst, idx = ("downs", lvl) if m.group(1) == "down" else (
                "ups", depth - 1 - lvl)
            part = m.group(3)
            base = f"{lst}.{idx}." + {"b1": "0", "b2": "1", "attn": "2"}.get(
                part, "3")
            if part == "up" and lvl != 0:
                base += ".1"
        else:
            base = {"mid_b1": "mid_block1", "mid_b2": "mid_block2",
                    "mid_attn": "mid_attn", "final_res": "final_res_block",
                    "init_conv": "init_conv", "final_conv": "final_conv",
                    "time_dense1": "time_mlp.1",
                    "time_dense2": "time_mlp.3"}.get(top)
            if base is None:
                raise KeyError(f"unexpected Flax param {'/'.join(path)}")
            part = top
        if rest[0] in ("norm_g", "out_norm_g"):
            sd[f"{base}.{_COND_ATTN[rest[0]]}"] = val.reshape(1, -1, 1, 1)
            continue
        if len(rest) == 2:                 # a leaf of a block's layer
            sub = (_COND_ATTN if part.endswith("attn") else _COND_RES)[
                rest[0]]
            base = f"{base}.{sub}"
        dense = rest[0] == "time_dense" or top.startswith("time_dense")
        sd[f"{base}.{_param(rest[-1])}"] = (
            val if rest[-1] != "kernel" else
            _dense_w(val) if dense else _conv_w(val))
    return _to_torch(sd)


def _flax_leaf(leaf: str) -> str:
    return {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)


def _msi_to_torch(params: dict, module_key) -> Dict[str, torch.Tensor]:
    """Shared walk of the MSI converters: ``module_key(path)`` names the
    torch module of a Flax module path; 4-D kernels are conv weights,
    2-D kernels Linear weights, every other leaf keeps its layout."""
    sd: Dict[str, np.ndarray] = {}
    for path, val in _flatten(params):
        val = np.asarray(val, np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            val = _conv_w(val) if val.ndim == 4 else _dense_w(val)
        key = module_key(path[:-1])
        sd[f"{key}.{_flax_leaf(leaf)}" if key else _flax_leaf(leaf)] = val
    return _to_torch(sd)


def _unknown(path):
    return KeyError(f"unexpected Flax param {'/'.join(path)}")


# HAB / Swin block parts whose torch names differ from the Flax ones
_SWIN_PART = {"mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2",
              "conv1": "cab.0", "conv2": "cab.2",
              "ca_fc1": "cab.3.attention.1", "ca_fc2": "cab.3.attention.3"}


def _swin_key(path: tuple, upsample: str) -> str:
    top = path[0]
    if top in ("conv_first", "conv_after_body", "conv_last", "norm"):
        return top
    if top == "conv_before_upsample":
        return "conv_before_upsample.0"
    if top == "patch_norm":
        return "patch_embed.norm"
    m = re.fullmatch(r"upsample_conv_(\d+)", top)
    if m:
        return f"{upsample}.{2 * int(m.group(1))}"
    m = re.fullmatch(r"layer_(\d+)", top)
    if m is None:
        raise _unknown(path)
    base = f"layers.{m.group(1)}"
    if path[1:] == ("conv",):
        return f"{base}.conv"
    if path[1] == "overlap_attn":
        base += ".residual_group.overlap_attn"
    else:
        j = re.fullmatch(r"block_(\d+)", path[1])
        if j is None:
            raise _unknown(path)
        base += f".residual_group.blocks.{j.group(1)}"
    return ".".join([base] + [_SWIN_PART.get(p, p) for p in path[2:]])


def flax_swinir_params_to_torch(params: dict) -> Dict[str, torch.Tensor]:
    """Flax ``SwinIR`` tree -> the state dict of the port's
    :class:`~fastdiffsr_tpu_torch.msi.swinir.SwinIR` (the reference
    GeneratorResNet's names): the inverse of the JAX package's
    ``torch_swinir_to_flax``."""
    return _msi_to_torch(params, lambda p: _swin_key(p, "upsample"))


def flax_hat_params_to_torch(params: dict) -> Dict[str, torch.Tensor]:
    """Flax ``HAT`` tree -> the port's :class:`~fastdiffsr_tpu_torch.msi.
    hat.HAT` state dict: the inverse of ``torch_hat_to_flax``."""
    return _msi_to_torch(params,
                         lambda p: _swin_key(p, "upsample.upsampling"))


_HSE_PART = {"head1": "head.0", "head2": "head.1", "tail1": "tail.0",
             "tail2": "tail.1", "hsem": "body.0",
             "base_scale": "base_scale.0", "down_scale": "down_scale.0",
             "nonlocal_base": "NonLocal_base", "head": "head.0",
             "tail": "tail.0", "mb1": "MB.0", "mb2": "MB.1", "ab_nl": "AB.0",
             "ab_conv": "AB.1", "conv": "0"}


def _hsenet_key(path: tuple) -> str:
    top = path[0]
    if path == ("head",):
        return "head.0"
    if path == ("tail",):
        return "tail.1"
    m = re.fullmatch(r"up_conv_(\d+)", top)
    if m:
        return f"tail.0.{2 * int(m.group(1))}"
    m = re.fullmatch(r"bm_(\d+)", top)
    if m is None:
        raise _unknown(path)
    return ".".join([f"body_modulist.{m.group(1)}"]
                    + [_HSE_PART.get(p, p) for p in path[1:]])


def flax_hsenet_params_to_torch(params: dict) -> Dict[str, torch.Tensor]:
    """Flax ``HSENet`` tree -> the port's :class:`~fastdiffsr_tpu_torch.
    msi.hsenet.HSENet` state dict: the inverse of ``torch_hsenet_to_flax``."""
    return _msi_to_torch(params, _hsenet_key)


_TE_TOP = {"head": "head.0", "tail": "tail", "red1": "stage1_conv1x1",
           "red2": "stage2_conv1x1", "red3": "stage3_conv1x1",
           "red_up": "up_conv1x1", "span": "span_conv1x1",
           "emb1": "patch_to_embedding_low1",
           "emb2": "patch_to_embedding_low2",
           "emb3": "patch_to_embedding_low3",
           "emb_up": "patch_to_embedding_high",
           "to_patch": "embedding_to_patch",
           "enc1": "encoder_stage1", "enc2": "encoder_stage2",
           "enc3": "encoder_stage3", "enc_up": "encoder_up",
           "dec1": "decoder1", "dec2": "decoder2", "dec3": "decoder3"}
_TE_SUB = {"to_out": "to_out.0", "fc1": "net.0", "fc2": "net.3"}


def _transenet_key(path: tuple) -> str:
    top = path[0]
    m = re.fullmatch(r"up_conv_(\d+)", top)
    if m:
        return f"upsampler.{2 * int(m.group(1))}"
    m = re.fullmatch(r"stage([123])", top)
    if m:
        rb = re.fullmatch(r"rb_(\d+)", path[1])
        conv = {"conv1": "0", "conv2": "2"}[path[2]]
        return (f"feat_extrat_stage{m.group(1)}.body.{rb.group(1)}.body."
                f"{conv}")
    if top not in _TE_TOP:
        raise _unknown(path)
    if len(path) == 1:
        return _TE_TOP[top]
    m = re.fullmatch(r"(ln_)?(attn|self|cross|mlp)_(\d+)", path[1])
    if m is None:
        raise _unknown(path)
    ln, part, i = m.groups()
    slot = {"attn": 0, "self": 0, "cross": 1,
            "mlp": 2 if top.startswith("dec") else 1}[part]
    base = f"{_TE_TOP[top]}.layers.{i}.{slot}.fn"
    if ln:
        return f"{base}.norm"
    return f"{base}.fn." + ".".join(_TE_SUB.get(p, p) for p in path[2:])


def flax_transenet_params_to_torch(params: dict
                                   ) -> Dict[str, torch.Tensor]:
    """Flax ``TransENet`` tree -> the port's :class:`~fastdiffsr_tpu_torch.
    msi.transenet.TransENet` state dict: the inverse of
    ``torch_transenet_to_flax``."""
    return _msi_to_torch(params, _transenet_key)


def _ndsrgan_key(path: tuple) -> str:
    top = path[0]
    named = {"conv1": "conv1.0", "conv2": "conv2", "head_conv1": "conv3.0",
             "head_conv2": "conv3.2"}
    if len(path) == 1 and top in named:
        return named[top]
    m = re.fullmatch(r"up_conv_(\d+)", top)
    if m:
        return f"upsampling.{3 * int(m.group(1)) + 1}"
    m = re.fullmatch(r"dcrdb_(\d+)", top)
    if m is None:
        raise _unknown(path)
    base = f"DCRDB_block.DRRDB{int(m.group(1)) + 1}"
    if path[1:] == ("conv",):
        return f"{base}.conv"
    rdb = re.fullmatch(r"rdb([123])", path[1])
    cl = re.fullmatch(r"cl_(\d+)", path[2])
    sub = f"CL_blocks.{cl.group(1)}.0" if cl else "conv"
    return f"{base}.RDB{rdb.group(1)}.{sub}"


def flax_ndsrgan_params_to_torch(params: dict) -> Dict[str, torch.Tensor]:
    """Flax ``DRRDBNet`` tree -> the port's :class:`~fastdiffsr_tpu_torch.
    msi.ndsrgan.DRRDBNet` state dict: the inverse of
    ``torch_ndsrgan_to_flax``."""
    return _msi_to_torch(params, _ndsrgan_key)


def _discriminator_key(path: tuple) -> str:
    m = re.fullmatch(r"block_(\d+)_(conv|norm)", path[0])
    if m:
        return f"blocks.{m.group(1)}.{0 if m.group(2) == 'conv' else 1}"
    if path == ("out",):
        return "out"
    raise _unknown(path)


def flax_discriminator_params_to_torch(params: dict
                                       ) -> Dict[str, torch.Tensor]:
    """Flax NDSRGAN ``Discriminator`` tree -> the port's
    :class:`~fastdiffsr_tpu_torch.msi.ndsrgan.Discriminator` state dict
    (no reference layout: the JAX package's critic uses GroupNorm)."""
    return _msi_to_torch(params, _discriminator_key)


def flax_converter(variant: str):
    """The Flax-tree -> torch state dict converter of a variant's net
    (``which_model_G``: a UNet variant of the main framework, or an
    EDiffSR denoiser; or an MSI arch, ``swinir``, ``hat``, ``hsenet``,
    ``transenet``, ``ndsrgan`` and ``ndsrgan_discriminator``)."""
    convs = {"fastdiffsr": flax_params_to_torch,
             "ddpm": flax_sr3_params_to_torch,
             "tesr": flax_sr3_params_to_torch,
             "gdp": flax_guided_params_to_torch,
             "ConditionalNAFNet": flax_nafnet_params_to_torch,
             "ConditionalUNet": flax_cond_unet_params_to_torch,
             "swinir": flax_swinir_params_to_torch,
             "hat": flax_hat_params_to_torch,
             "hsenet": flax_hsenet_params_to_torch,
             "transenet": flax_transenet_params_to_torch,
             "ndsrgan": flax_ndsrgan_params_to_torch,
             "ndsrgan_discriminator": flax_discriminator_params_to_torch}
    if variant not in convs:
        raise ValueError(f"unknown which_model_G: {variant}")
    return convs[variant]


def optax_state_to_torch(opt_state: Sequence, param_names: Sequence[str],
                         variant: str) -> dict:
    """The ``state`` entry of a torch optimizer state dict from an optax
    chain state (a tuple of optax states, e.g. ``(ScaleByAdamState(count,
    mu, nu), EmptyState())``, or stand-ins with the same class names and
    fields). ``param_names`` lists the torch parameter names in the
    optimizer's order; the moment trees go through ``variant``'s
    converter. Adam's moments become ``exp_avg``/``exp_avg_sq`` with
    ``step`` = count, as torch.optim.Adam/AdamW keep them; Lion's
    (``ScaleByLionState(count, mu)``) become ``exp_avg``, the one moment
    :class:`~fastdiffsr_tpu_torch.train.state.Lion` keeps. Any other
    optax state with fields raises, naming it."""
    by_name = {type(s).__name__: s for s in opt_state}
    # a schedule's own count is the step, which the port's train loops
    # read from the checkpoint's ``step`` to set the learning rate
    unknown = sorted(n for n, s in by_name.items()
                     if n not in ("ScaleByAdamState", "ScaleByLionState",
                                  "ScaleByScheduleState")
                     and len(s))
    moments = [n for n in ("ScaleByAdamState", "ScaleByLionState")
               if n in by_name]
    if unknown or len(moments) != 1:
        raise NotImplementedError(
            f"optax state {sorted(by_name)}: only Adam/AdamW or Lion "
            f"moments are converted (not {unknown or moments})")
    convert = flax_converter(variant)
    if moments[0] == "ScaleByLionState":
        _, mu = by_name["ScaleByLionState"]
        mu = convert(mu)
        return {i: {"exp_avg": mu[name]}
                for i, name in enumerate(param_names)}
    count, mu, nu = by_name["ScaleByAdamState"]
    mu, nu = convert(mu), convert(nu)
    step = float(np.asarray(count))
    return {i: {"step": torch.tensor(step), "exp_avg": mu[name],
                "exp_avg_sq": nu[name]}
            for i, name in enumerate(param_names)}


# the GaussianDiffusion wrapper of a reference ``*_gen.pth`` keeps the
# UNet under this prefix, beside its schedule buffers
DIFFUSION_PREFIX = "denoise_fn."
SCHEDULE_BUFFERS = frozenset((
    "betas", "alphas_cumprod", "alphas_cumprod_prev",
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1",
    "posterior_mean_coef2"))


def strip_diffusion_prefix(state_dict: dict,
                           prefix: str = DIFFUSION_PREFIX) -> dict:
    """The UNet entries of a reference GaussianDiffusion state dict
    without ``prefix`` (counterpart of the JAX package's
    ``models/convert.py::strip_diffusion_prefix``). A dict that has no
    key under ``prefix`` is a bare UNet state dict and comes back as it
    is. Schedule buffers (:data:`SCHEDULE_BUFFERS`) are dropped; any
    other key outside ``prefix`` raises, naming it."""
    if not any(k.startswith(prefix) for k in state_dict):
        return dict(state_dict)
    out = {}
    for k, v in state_dict.items():
        if k.startswith(prefix):
            out[k[len(prefix):]] = v
        elif k not in SCHEDULE_BUFFERS:
            raise KeyError(f"{k!r} is neither under {prefix!r} nor a "
                           "schedule buffer of the diffusion wrapper")
    return out


# the first name of every parameter key of each MSI arch (the reference
# GeneratorResNet / HSENET / TransENet names the port's modules keep)
MSI_TOP = {
    "swinir": {"conv_first", "patch_embed", "layers", "norm",
               "conv_after_body", "conv_before_upsample", "upsample",
               "conv_last"},
    "hat": {"conv_first", "patch_embed", "layers", "norm",
            "conv_after_body", "conv_before_upsample", "upsample",
            "conv_last"},
    "hsenet": {"head", "body_modulist", "tail"},
    "transenet": {"head", "tail", "upsampler", "up_conv1x1",
                  "span_conv1x1", "patch_to_embedding_high",
                  "embedding_to_patch", "encoder_up"}
    | {f"{k}{s}" for s in (1, 2, 3) for k in (
        "feat_extrat_stage", "patch_to_embedding_low", "decoder")}
    | {f"stage{s}_conv1x1" for s in (1, 2, 3)}
    | {f"encoder_stage{s}" for s in (1, 2, 3)},
    "ndsrgan": {"conv1", "DCRDB_block", "conv2", "upsampling", "conv3"},
}


def _reference_buffer(key: str) -> bool:
    """Keys a reference MSI state dict holds that are no parameter of
    the port: the relative-position indices and shift masks, the rgb
    ``mean``, the MeanShift convs and BatchNorm's counters (the JAX
    converters drop them too)."""
    return ("relative_position_index" in key or key.endswith("attn_mask")
            or key == "mean" or key.startswith(("sub_mean.", "add_mean."))
            or key.endswith("num_batches_tracked"))


def load_reference_msi_pth(path: str, arch: str) -> Dict[str, torch.Tensor]:
    """The parameter state dict of a reference MSI checkpoint of ``arch``
    (swinir, hat, hsenet, transenet, ndsrgan), on the CPU in float32: a
    ``module.`` prefix (``nn.DataParallel``) goes, and so do the buffers
    of :func:`_reference_buffer`. A key outside the arch's modules raises,
    naming it; the port's net then loads the rest with a strict
    ``load_state_dict``. NDSRGAN's reference builds both of its 2x
    upsampling stages from one Conv2d (ndsrgan.py:180-199), so its
    ``upsampling.1`` and ``upsampling.4`` hold the same tensors; the
    port's two convs each take their copy."""
    if arch not in MSI_TOP:
        raise ValueError(f"unknown MSI arch {arch!r} (want one of "
                         f"{sorted(MSI_TOP)})")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if _reference_buffer(k):
            continue
        if k.split(".", 1)[0] not in MSI_TOP[arch]:
            raise KeyError(f"{k!r} is not a parameter of the {arch} net")
        out[k] = v.float()
    return out


def main(argv=None) -> str:
    """Convert a reference checkpoint to a state-dict file that
    ``cli/infer.py::load_params`` (and ``sr_mfe -p val``, and
    ``ediffsr.train``'s ``pretrain_model_G`` with ``--arch nafnet``, and
    ``msi.main --resume`` with ``--arch swinir|hat|hsenet|transenet|
    ndsrgan``, through :func:`load_reference_msi_pth`) reads:

        python -m fastdiffsr_tpu_torch.models.convert --arch fastdiffsr \\
            I896896_E196_gen.pth unet.pt

    The port's parameter names are the reference's, so no rename is
    needed: the ``denoise_fn.`` prefix and the schedule buffers go, a key
    outside the arch's UNet modules raises, naming it, and the tensors
    are written in float32 (the strict load of ``load_params`` checks the
    rest)."""
    import argparse

    # the first name of every key of each arch's UNet state dict
    sr3 = {"time_mlp", "downs", "mid", "ups", "final_conv"}
    top = {"fastdiffsr": {"noise_level_mlp", "downs", "mid", "ups",
                          "final_conv"},
           "ddpm": sr3, "tesr": sr3,
           "gdp": {"time_embed", "input_blocks", "middle_block",
                   "output_blocks", "out"},
           # EDiffSR's ConditionalNAFNet (a reference *_G.pth is the bare
           # DenoisingNAFNet_arch state dict)
           "nafnet": {"time_mlp", "intro", "enhance", "encoders", "downs",
                      "middle_blks", "ups", "decoders", "ending"}}

    p = argparse.ArgumentParser()
    p.add_argument("ckpt", help="reference *_gen.pth (or a bare UNet "
                                "state dict), or an MSI baseline's .pth")
    p.add_argument("out", help="output state-dict file")
    p.add_argument("--arch", default="fastdiffsr",
                   choices=sorted(top) + sorted(MSI_TOP))
    args = p.parse_args(argv)
    if args.arch in MSI_TOP:
        sd = load_reference_msi_pth(args.ckpt, args.arch)
    else:
        sd = torch.load(args.ckpt, map_location="cpu", weights_only=True)
        sd = strip_diffusion_prefix(sd)
        for k in sd:
            if k.split(".", 1)[0] not in top[args.arch]:
                raise KeyError(f"{k!r} is not a parameter of the "
                               f"{args.arch} UNet")
        sd = {k: v.float() for k, v in sd.items()}
    torch.save(sd, args.out)
    print(f"wrote {args.out} ({len(sd)} tensors)")
    return args.out


if __name__ == "__main__":
    main()
