"""The MSI baselines' CLI: counterpart of ``fastdiffsr_tpu/msi/main.py``
(reference main_<model>.py, one entry point for the five baselines).

    python -m fastdiffsr_tpu_torch.msi.main --model_name SwinIR \\
        --data_dir dataset/Train --test_data_dir dataset/Test \\
        --scale_factor 4 --crop_size 256 --num_epochs 50 \\
        [--mode train|validate|validateByClass|test_single] \\
        [--resume <ckpt dir or .pth>] [--tiny] [--device cuda|cpu]
    torchrun --nproc_per_node=<GPUs> -m fastdiffsr_tpu_torch.msi.main \\
        --launcher pytorch ...

The JAX CLI's flags, plus ``--device`` (CUDA unless ``--device cpu``);
the initial weights come from seed 0, as JAX's from PRNGKey(0). Float32 is
IEEE float32 (``device.use_ieee_float32``); cuDNN times its algorithms
for ``--mode train`` and keeps its heuristics for the evaluation modes
(``device.set_cudnn_autotuning``). ``--tiny`` builds the small variants
of the JAX CLI. ``main`` returns what the mode computed: the training
summary, the validation means, the per-class report or the output path.

``--launcher pytorch`` runs data-parallel under ``torchrun`` (it raises
without torchrun's variables): one process per GPU on
``cuda:{LOCAL_RANK}`` (NCCL; gloo with ``--device cpu``), ``--batch_size``
the global batch, the evaluation modes' batches split over the ranks
(``msi.trainer``); rank 0 writes the logs, checkpoints and plots, and
``test_single`` runs on rank 0.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.nn as nn


def build_model(name: str, args) -> nn.Module:
    name = name.lower()
    tiny = getattr(args, "tiny", False)
    s = args.scale_factor
    if name == "swinir":
        from .swinir import SwinIR
        if tiny:
            return SwinIR(upscale=s, embed_dim=24, depths=(2, 2),
                          num_heads=(3, 3), window_size=4, mlp_ratio=2.0)
        return SwinIR(upscale=s)
    if name == "ndsrgan":
        from .ndsrgan import DRRDBNet
        if tiny:
            return DRRDBNet(scale=s, nf=8, nc=4, n_blocks=2)
        return DRRDBNet(scale=s)
    if name == "hsenet":
        from .hsenet import HSENet
        if tiny:
            return HSENet(scale=s, n_feats=8, n_basic_modules=1)
        return HSENet(scale=s)
    if name == "transenet":
        from .transenet import TransENet
        if tiny:
            return TransENet(scale=s, n_feats=8, en_depth=1, de_depth=1)
        return TransENet(scale=s)
    if name == "hat":
        from .hat import HAT
        if tiny:
            return HAT(upscale=s, embed_dim=24, depths=(2, 2),
                       num_heads=(2, 2), window_size=4, squeeze_factor=4,
                       mlp_ratio=2.0)
        return HAT(upscale=s)
    raise ValueError(f"unknown model {name}")


def init_weights(net: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded initial weights with the JAX package's Flax defaults:
    LeCun-normal convs and linears with zero biases, LayerNorm and
    GroupNorm 1 / 0, relative-position bias tables truncated normal
    (std 0.02), and zeros for the convs marked ``zero_init`` (HSENet's
    non-local output convs)."""
    from ..models.unet_fastdiffsr import init_params

    init_params(net, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.copy_(torch.nn.init.trunc_normal_(
                    torch.empty_like(p), std=0.02, a=-0.04, b=0.04,
                    generator=gen))
        for m in net.modules():
            if getattr(m, "zero_init", False):
                m.weight.zero_()
                m.bias.zero_()
    return net


def parse_args(argv=None):
    p = argparse.ArgumentParser("MSI SR baselines (PyTorch)")
    p.add_argument("--model_name", type=str, default="SwinIR",
                   choices=["SwinIR", "HSENet", "TransENet", "NDSRGAN",
                            "HAT"])
    p.add_argument("--data_dir", type=str, default="dataset/Train")
    p.add_argument("--test_data_dir", type=str, default="dataset/Test")
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--test_crop_size", type=int, default=256)
    p.add_argument("--scale_factor", type=int, default=4)
    p.add_argument("--num_epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--b1", type=float, default=0.9)
    p.add_argument("--b2", type=float, default=0.999)
    p.add_argument("--save_dir", type=str, default="Result")
    p.add_argument("--log_freq", type=int, default=200,
                   help="steps between TB/loss_log.txt rows "
                        "(reference swinir.py:802)")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--eval_batch_size", type=int, default=8,
                   help="validate/validateByClass inference batch (the "
                        "reference evaluates at batch 1; outputs do not "
                        "depend on the grouping)")
    p.add_argument("--tiny", action="store_true",
                   help="small model variants for smoke/debug runs")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint directory (either package) or a "
                        "parameter file (reference .pth, convert output)")
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "validate", "validateByClass",
                            "test_single"])
    p.add_argument("--input", type=str, default=None,
                   help="image path for test_single")
    p.add_argument("--output", type=str, default="sr_out.png")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--launcher", default="none", choices=["none", "pytorch"],
                   help="pytorch: data parallel under torchrun")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    args.save_dir = os.path.join(args.save_dir, args.model_name)

    from ..device import (resolve_device, set_cudnn_autotuning,
                          use_ieee_float32)
    from ..parallel import initialize_from_env, is_main
    from ..utils.logging import setup_logger
    from .trainer import SupervisedSRTrainer

    dist = args.launcher == "pytorch"
    device = (initialize_from_env(args.device, flag="--launcher pytorch")
              if dist else resolve_device(args.device))
    use_ieee_float32()
    set_cudnn_autotuning(args.mode == "train")
    logger = setup_logger("msi", args.save_dir, args.mode, screen=True)
    trainer = SupervisedSRTrainer(build_model(args.model_name, args), args,
                                  logger, device=device)
    if args.resume:
        trainer.load(args.resume)

    if args.mode == "train":
        return trainer.train([args.data_dir], val_dirs=[args.test_data_dir]
                             if os.path.isdir(args.test_data_dir) else None,
                             num_epochs=args.num_epochs,
                             batch_size=args.batch_size,
                             max_steps=args.max_steps)
    if args.mode == "validate":
        return trainer.validate([args.test_data_dir], shard=dist)
    if args.mode == "validateByClass":
        return trainer.validate_by_class([args.test_data_dir], shard=dist)
    if not args.input:
        raise SystemExit("--input is required for --mode test_single")
    return trainer.test_single(args.input, args.output) if is_main() else None


if __name__ == "__main__":
    main()
    from ..parallel import shutdown
    shutdown()
