"""Batch inference CLI: the serving path of the port.

Counterpart of ``fastdiffsr_tpu/cli/infer.py`` (reference
infer.py:17-119), with the val half of ``fastdiffsr_tpu/cli/sr_mfe.py``'s
``build_all``. It reads the val set of a reference-schema config, builds
the UNet of ``model.which_model_G`` (fastdiffsr, ddpm, tesr or gdp), runs
the sampler that ``model.diffusion`` names (``sampler``: ancestral (the
default), ddim or dpm, with ``ddim_steps`` and ``ddim_eta``), saves
``{n}_sr.png`` per image and logs the steady-state latency:

    python -m fastdiffsr_tpu_torch.cli.infer -c <config.json> \\
        [--device cuda] [--fused | --plain] [--dtype f32|bf16] [--seed N] \\
        [-enable_wandb] [-log_infer]
    torchrun --nproc_per_node=<GPUs> -m fastdiffsr_tpu_torch.cli.infer \\
        -dist -c <config.json> ...

It runs on CUDA unless ``--device cpu`` is given, and raises where CUDA
is asked for but absent. It samples in float32, as the JAX CLI and the
reference do; ``--dtype bf16`` is the opt-in serving mode (the UNet's
activations in bfloat16, K3 on the tensor cores), whose output is not
the reference's within the port's tolerance. Float32 is full float32,
and cuDNN picks its algorithms by its heuristics
(``device.set_cudnn_autotuning``). The fused forward (K3/K2 kernels on
CUDA; their plain versions on the CPU) exists for FastDiffSR only and is
its default; the other variants run their plain UNet forward (K1 under
each GroupNorm -> Swish), and ``--fused`` with them raises. With
``FASTDIFFSR_TPU_QUANT=w8a8|w8a8s`` FastDiffSR's UNet runs its wide
stages' convs in int8 (kernel Q1, ``ops/quant.py``) on the plain forward,
which becomes its default: the fused forward has no quantized form, and
``--fused`` with a quant mode raises. With
``path.resume_state`` set it loads a checkpoint (a UNet state dict file,
a reference ``*_gen.pth``, or a checkpoint directory of either package);
otherwise it uses seeded initial parameters. ``-enable_wandb`` logs to
Weights & Biases where ``wandb`` imports (a no-op otherwise), with
``-log_infer`` each SR image too. Experiment directories go under
``experiments/`` of the working directory.

``-dist`` runs under ``torchrun`` (it raises without torchrun's
variables): one process per GPU on ``cuda:{LOCAL_RANK}`` (NCCL; gloo
with ``--device cpu``), each val batch's images split over the ranks
(``parallel.sample_rows``, the counterpart of JAX's ``auto_mesh`` over
local devices: the largest divisor of the batch that fits the ranks),
each rank sampling its images with their own generators and writing
them under the one-process names. Rank 0 logs. The dynamic int8
activation scale (``w8a8``) is the maximum over the sampling ranks
(``parallel.sample_group``), as over JAX's global batch, so the images
are the one-process images.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build_unet(model_opt, dtype=torch.float32, device="cuda",
               seed: int = 0):
    """The UNet of ``model_opt['which_model_G']`` with seeded initial
    parameters, in eval mode on ``device`` (JAX cli/sr_mfe.py:99-109)."""
    variant = model_opt["which_model_G"]
    kw = dict(dtype=dtype, device=device, seed=seed)
    if variant == "fastdiffsr":
        from ..models.unet_fastdiffsr import unet_from_config
        return unet_from_config(model_opt["unet"], **kw)
    image_size = int(model_opt["diffusion"]["image_size"])
    if variant in ("ddpm", "tesr"):
        from ..models.unet_sr3 import sr3_unet_from_config
        return sr3_unet_from_config(model_opt["unet"], image_size, **kw)
    if variant == "gdp":
        from ..models.unet_guided import guided_unet_from_config
        return guided_unet_from_config(model_opt["unet"], image_size, **kw)
    raise ValueError(f"unknown which_model_G: {variant}")


def build_all(opt, device="cuda", dtype=torch.float32, seed: int = 0):
    """(val engine, UNet) of a config: the val half of sr_mfe.build_all."""
    from ..diffusion import DiffusionEngine, DiffusionSpec, ScheduleBuffers

    model_opt = opt["model"]
    net = build_unet(model_opt, dtype=dtype, device=device, seed=seed)
    eng_val = DiffusionEngine(
        DiffusionSpec.for_variant(model_opt["which_model_G"]),
        ScheduleBuffers.create(model_opt["beta_schedule"]["val"],
                               device=device))
    return eng_val, net


def sampler_options(opt) -> dict:
    """make_sample_fn's sampler options from ``model.diffusion``
    (``sampler``, ``ddim_steps``, ``ddim_eta``)."""
    diff_opt = (opt.get("model") or {}).get("diffusion") or {}
    steps = diff_opt.get("ddim_steps")
    return {"sampler": diff_opt.get("sampler") or "ancestral",
            "ddim_steps": int(steps) if steps else None,
            "ddim_eta": float(diff_opt.get("ddim_eta") or 0.0)}


def resolve_fused(variant: str, fused) -> bool:
    """The forward to run: ``fused`` None picks the variant's default
    (fused for FastDiffSR, plain otherwise); the fused forward exists
    for FastDiffSR only, and has no int8 form: with
    ``FASTDIFFSR_TPU_QUANT`` set FastDiffSR's default is the plain
    forward, and ``fused`` True raises."""
    from ..ops.quant import default_quant
    quant = default_quant() if variant == "fastdiffsr" else ""
    if fused is None:
        return variant == "fastdiffsr" and not quant
    if fused and variant != "fastdiffsr":
        raise ValueError(f"--fused: the fused forward exists for "
                         f"'fastdiffsr' only, not {variant!r}; run --plain")
    if fused and quant:
        raise ValueError(f"--fused with FASTDIFFSR_TPU_QUANT={quant!r}: the "
                         "fused forward (K3/K2) has no int8 form; run --plain "
                         "or unset FASTDIFFSR_TPU_QUANT")
    return bool(fused)


def load_params(net, path: str, use_ema: bool = False, *,
                variant: str) -> None:
    """Load into ``net``, strictly: the (EMA) params of a checkpoint
    directory of either package, or a UNet state-dict file (the port's,
    one that ``models.convert`` wrote, or a reference ``*_gen.pth``,
    whose ``denoise_fn.`` prefix and schedule buffers are dropped)."""
    from ..train.checkpoint import load_params_only, load_reference_gen_pth
    if os.path.isdir(path):
        sd = load_params_only(path, use_ema=use_ema, variant=variant)
    else:
        sd = load_reference_gen_pth(path, variant=variant)
    net.load_state_dict(sd, strict=True)


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
                     default=None, help="fused K3/K2 forward (FastDiffSR "
                                        "only; its default)")
    fwd.add_argument("--plain", dest="fused", action="store_false",
                     help="unfused UNet forward (K1 under each "
                          "GroupNorm -> Swish on CUDA; the default of "
                          "ddpm, tesr and gdp)")
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="f32",
                        help="f32 (the reference's) or bf16 (opt-in "
                             "serving mode)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds the initial params and the per-image "
                             "noise generators")
    parser.add_argument("-use_ema", action="store_true",
                        help="load the EMA params of a checkpoint directory")
    parser.add_argument("-enable_wandb", action="store_true")
    parser.add_argument("-log_infer", action="store_true",
                        help="with -enable_wandb, log each SR image")
    parser.add_argument("-dist", action="store_true",
                        help="split the images over the ranks of torchrun")
    args = parser.parse_args(argv)

    from ..config import parse
    from ..device import (resolve_device, set_cudnn_autotuning,
                          use_ieee_float32)
    from ..ops.quant import shared_activation_scale
    from ..parallel import (broadcast_from_main, initialize_from_env,
                            is_main, rank, sample_group, sample_rows,
                            world_size)
    from ..utils.logging import setup_logger

    device = (initialize_from_env(args.device) if args.dist
              else resolve_device(args.device))
    use_ieee_float32()
    set_cudnn_autotuning(False)
    dtype = DTYPES[args.dtype]
    opt = parse(args.config, "val", debug=args.debug,
                enable_wandb=args.enable_wandb)
    logger = setup_logger("base", opt["path"]["log"], "infer", screen=True)
    wandb_logger = None
    if args.enable_wandb and is_main():
        from ..utils.wandb_logger import WandbLogger
        wandb_logger = WandbLogger(opt)

    from .. import metrics as M
    from ..data import create_dataloader, create_dataset
    from ..train import make_sample_fn, pad_batch_with_keys

    variant = opt["model"]["which_model_G"]
    fused = resolve_fused(variant, args.fused)
    eng_val, net = build_all(opt, device=device, dtype=dtype, seed=args.seed)
    if opt["path"]["resume_state"]:
        load_params(net, opt["path"]["resume_state"], args.use_ema,
                    variant=variant)
        logger.info(f"loaded {'EMA ' if args.use_ema else ''}params from "
                    f"{opt['path']['resume_state']}")
    broadcast_from_main(net)            # -dist: every rank samples rank 0's
    denoise = make_denoiser(net, fused, dtype)
    samp = sampler_options(opt)
    logger.info(f"infer: {variant} device={device} forward="
                f"{'fused' if fused else 'plain'} dtype={args.dtype} "
                f"sampler={samp['sampler']} steps={samp['ddim_steps']} "
                f"eta={samp['ddim_eta']}")

    val_set = create_dataset(opt["datasets"]["val"], "val")
    val_loader = create_dataloader(val_set, opt["datasets"]["val"], "val")
    sample_fn = make_sample_fn(eng_val, denoise, **samp)

    result_path = opt["path"]["results"]
    os.makedirs(result_path, exist_ok=True)
    times = []
    first_s = None
    n = 0
    full_b = val_loader.batch_size
    rows = (sample_rows(full_b, rank(), world_size()) if args.dist
            else slice(0, full_b))
    group = sample_group(full_b) if args.dist else None
    first_batch = True
    t_start = time.time()
    for batch in val_loader:
        b = batch["SR"].shape[0]
        cond, gens = pad_batch_with_keys(batch["SR"], full_b, args.seed, n,
                                         device=device)
        t0 = time.time()
        with shared_activation_scale(group):
            sr = (sample_fn(cond[rows], gens[rows]).cpu().numpy()   # waits
                  if rows.stop > rows.start else np.zeros((0,)))
        dt_img = (time.time() - t0) / full_b
        if not np.isfinite(sr).all():
            raise FloatingPointError(f"non-finite SR output in images "
                                     f"{n}..{n + b - 1}")
        # the first batch includes one-time set-up (kernel build, cuDNN
        # plans): excluded from the steady-state latency
        dt_note = " incl. set-up" if first_batch else ""
        if first_batch:
            first_s = dt_img
        else:
            times.extend([dt_img] * b)
        first_batch = False
        for j in range(b):
            if rows.start <= j < rows.stop:
                img = M.tensor2img(sr[j - rows.start])
                M.save_img(img, os.path.join(result_path, f"{n}_sr.png"))
                if wandb_logger is not None and args.log_infer:
                    wandb_logger.log_image(f"infer/{n}_sr", img)
            logger.info(f"image {n}: {dt_img:.3f}s{dt_note}")
            n += 1
    summary = {"images": n, "seconds": time.time() - t_start,
               "results": result_path,
               "mean_latency_s": float(np.mean(times)) if times else None,
               "latencies_s": times,
               "steady_images": len(times),
               "first_batch_s_per_image": first_s}
    if times:
        logger.info(f"mean latency: {summary['mean_latency_s']:.4f}s over "
                    f"{len(times)} images")
        if wandb_logger is not None:
            wandb_logger.log_metrics(
                {"infer/mean_latency_s": summary["mean_latency_s"]})
    return summary


if __name__ == "__main__":
    main()
    from ..parallel import shutdown
    shutdown()
