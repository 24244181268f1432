"""Batch inference CLI: the serving path of the port.

Counterpart of ``fastdiffsr_tpu/cli/infer.py`` (reference
infer.py:17-119), with the val half of ``fastdiffsr_tpu/cli/sr_mfe.py``'s
``build_all``. It reads the val set of a reference-schema config, runs
the T-step ancestral sampler of the ``fastdiffsr`` variant, saves
``{n}_sr.png`` per image and logs the steady-state latency:

    python -m fastdiffsr_tpu_torch.cli.infer -c <config.json> \\
        [--device cuda] [--fused | --plain] [--dtype bf16|f32] [--seed N]

It runs on CUDA unless ``--device cpu`` is given, and raises where CUDA
is asked for but absent. The default forward is the fused one (K3/K2
kernels on CUDA; their plain versions on the CPU). With
``path.resume_state`` set it loads a port checkpoint (a torch state dict
of the UNet); otherwise it uses seeded initial parameters. Experiment
directories go under ``experiments/`` of the working directory.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build_all(opt, device="cuda", dtype=torch.float32, seed: int = 0):
    """(val engine, UNet) of a config: the val half of sr_mfe.build_all."""
    from ..diffusion import DiffusionEngine, DiffusionSpec, ScheduleBuffers
    from ..models.unet_fastdiffsr import unet_from_config

    model_opt = opt["model"]
    variant = model_opt["which_model_G"]
    if variant != "fastdiffsr":
        raise NotImplementedError(
            f"which_model_G={variant!r}: only 'fastdiffsr' is ported "
            "(ROADMAP.md queue 1: variants)")
    spec = DiffusionSpec.for_variant(variant)
    eng_val = DiffusionEngine(
        spec, ScheduleBuffers.create(model_opt["beta_schedule"]["val"],
                                     device=device))
    net = unet_from_config(model_opt["unet"], dtype=dtype, device=device,
                           seed=seed)
    return eng_val, net


def load_params(net, path: str, use_ema: bool = False) -> None:
    """Load a UNet state dict file, or the (EMA) params of a checkpoint
    directory, into ``net``."""
    if os.path.isdir(path):
        from ..train.checkpoint import load_params_only
        sd = load_params_only(path, use_ema=use_ema)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    net.load_state_dict(sd)


def make_denoiser(net, fused: bool, dtype):
    """denoise(x_in, level) of ``net``'s current parameters: the fused
    forward (K3/K2 on CUDA) or the unfused UNet forward, without grad."""
    if fused:
        from ..models.unet_fastdiffsr_fused import (fused_apply,
                                                    prepare_fused_params)
        fparams = prepare_fused_params(net, dtype)

        def denoise(x_in, level):
            return fused_apply(fparams, x_in, level)
        return denoise

    def denoise(x_in, level):
        with torch.no_grad():
            return net(x_in, level)
    return denoise


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-p", "--phase", type=str, choices=["val"],
                        default="val")
    parser.add_argument("-debug", action="store_true")
    parser.add_argument("--device", default="cuda")
    fwd = parser.add_mutually_exclusive_group()
    fwd.add_argument("--fused", dest="fused", action="store_true",
                     default=True, help="fused K3/K2 forward (default)")
    fwd.add_argument("--plain", dest="fused", action="store_false",
                     help="unfused UNet forward (K1 under each "
                          "GroupNorm -> Swish on CUDA)")
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds the initial params and the per-image "
                             "noise generators")
    parser.add_argument("-use_ema", action="store_true",
                        help="load the EMA params of a checkpoint directory")
    args = parser.parse_args(argv)

    from ..config import parse
    from ..device import resolve_device, use_ieee_float32
    from ..utils.logging import setup_logger

    device = resolve_device(args.device)
    use_ieee_float32()
    dtype = DTYPES[args.dtype]
    opt = parse(args.config, "val", debug=args.debug)
    logger = setup_logger("base", opt["path"]["log"], "infer", screen=True)

    from .. import metrics as M
    from ..data import create_dataloader, create_dataset
    from ..train import make_sample_fn, pad_batch_with_keys

    eng_val, net = build_all(opt, device=device, dtype=dtype, seed=args.seed)
    if opt["path"]["resume_state"]:
        load_params(net, opt["path"]["resume_state"], args.use_ema)
        logger.info(f"loaded {'EMA ' if args.use_ema else ''}params from "
                    f"{opt['path']['resume_state']}")
    denoise = make_denoiser(net, args.fused, dtype)
    logger.info(f"infer: device={device} forward="
                f"{'fused' if args.fused else 'plain'} dtype={args.dtype}")

    val_set = create_dataset(opt["datasets"]["val"], "val")
    val_loader = create_dataloader(val_set, opt["datasets"]["val"], "val")
    diff_opt = (opt.get("model") or {}).get("diffusion") or {}
    sample_fn = make_sample_fn(eng_val, denoise,
                               sampler=diff_opt.get("sampler") or "ancestral")

    result_path = opt["path"]["results"]
    os.makedirs(result_path, exist_ok=True)
    times = []
    n = 0
    full_b = val_loader.batch_size
    first_batch = True
    t_start = time.time()
    for batch in val_loader:
        b = batch["SR"].shape[0]
        cond, gens = pad_batch_with_keys(batch["SR"], full_b, args.seed, n,
                                         device=device)
        t0 = time.time()
        sr = sample_fn(cond, gens).cpu().numpy()   # .cpu() waits for it
        dt_img = (time.time() - t0) / full_b
        if not np.isfinite(sr).all():
            raise FloatingPointError(f"non-finite SR output in images "
                                     f"{n}..{n + b - 1}")
        # the first batch includes one-time set-up (kernel build, cuDNN
        # plans): excluded from the steady-state latency
        dt_note = " incl. set-up" if first_batch else ""
        if not first_batch:
            times.extend([dt_img] * b)
        first_batch = False
        for j in range(b):
            M.save_img(M.tensor2img(sr[j]),
                       os.path.join(result_path, f"{n}_sr.png"))
            logger.info(f"image {n}: {dt_img:.3f}s{dt_note}")
            n += 1
    summary = {"images": n, "seconds": time.time() - t_start,
               "results": result_path,
               "mean_latency_s": float(np.mean(times)) if times else None,
               "steady_images": len(times)}
    if times:
        logger.info(f"mean latency: {summary['mean_latency_s']:.4f}s over "
                    f"{len(times)} images")
    return summary


if __name__ == "__main__":
    main()
