"""Train/val CLI of the port: counterpart of ``fastdiffsr_tpu/cli/sr_mfe.py``
(reference sr_mfe.py:20-386).

    python -m fastdiffsr_tpu_torch.cli.sr_mfe -p train -c <config.json> \\
        [-debug] [--device cuda|cpu] [--seed N]
    python -m fastdiffsr_tpu_torch.cli.sr_mfe -p val -c <config.json> \\
        [-use_ema] [--device cuda|cpu] [--seed N]

It runs on CUDA unless ``--device cpu`` is given. Training runs the UNet
forward in float32 (TF32 off, ``device.use_ieee_float32``) with dropout;
every GroupNorm -> Swish of it runs kernel K1. The loop reads
the data loader, or a uint8 copy of the train set on the device with
``datasets.train.device_cache: true``; prints l_pix with its windowed
mean every ``print_freq`` steps, validates every ``val_freq`` steps,
saves ``I{iter}_E{epoch}`` checkpoints every ``save_checkpoint_freq``
steps and at the end, and resumes from ``path.resume_state``. Validation
samples with the fused forward (kernels K3 and K2 on CUDA), built as in
``cli/infer.py``, and logs PSNR, SSIM, MSE and ERGAS per image. The val
phase loads a checkpoint directory of either package.

``--seed`` seeds the initial parameters, the train steps' draws
(``train.step_generator``) and the per-image sampling noise. ``-debug``
shrinks the run as the reference does and writes a synthetic 6-image
npy pack for any dataroot that does not exist. ``-gpu`` is accepted and
logged; ``-dist`` and ``-enable_wandb`` are not ported.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def ensure_debug_data(opt, logger=None, seed: int = 0) -> None:
    """``-debug``: point every absent dataroot at a synthetic 6-image npy
    pack under the run's experiment dir (``data.synth.write_pack``)."""
    from ..data import write_pack

    exp_root = os.path.dirname(opt["path"]["results"])
    cache = {}
    for ds in opt["datasets"].values():
        root = ds.get("dataroot")
        if not root or os.path.isdir(root):
            continue
        key = (int(ds["l_resolution"]), int(ds["r_resolution"]))
        if key not in cache:
            cache[key] = write_pack(
                os.path.join(exp_root, f"synth_{key[0]}_{key[1]}"), 6, seed,
                *key)
            if logger is not None:
                logger.info(f"-debug: dataroot {root!r} absent, synthesized "
                            f"a 6-image set at {cache[key]}")
        ds["dataroot"] = cache[key]
        ds["datatype"] = "npy"


def build_all(opt, device, seed: int = 0):
    """(train engine, val engine, UNet in float32) of a config."""
    from ..diffusion import DiffusionEngine, DiffusionSpec, ScheduleBuffers
    from .infer import build_all as build_val

    eng_val, net = build_val(opt, device=device, dtype=torch.float32,
                             seed=seed)
    model_opt = opt["model"]
    eng_train = DiffusionEngine(
        DiffusionSpec.for_variant(model_opt["which_model_G"]),
        ScheduleBuffers.create(model_opt["beta_schedule"]["train"],
                               device=device),
        aux_ssim_weight=float((model_opt.get("diffusion") or {})
                              .get("aux_ssim_weight") or 0.0))
    return eng_train, eng_val, net


def run_validation(opt, engine_val, denoise, result_path, logger, *,
                   seed: int, device, scale: int = 4,
                   save_images: bool = True) -> dict:
    """Sample the val set with ``denoise`` and log per-image PSNR, SSIM,
    MSE and ERGAS and their means. The first batch holds one-time set-up
    and is left out of ``avg_time``."""
    from .. import metrics as M
    from ..data import create_dataloader, create_dataset
    from ..train import make_sample_fn, pad_batch_with_keys

    diff_opt = (opt.get("model") or {}).get("diffusion") or {}
    if int(diff_opt.get("n_samples") or 1) != 1:
        raise NotImplementedError("model.diffusion.n_samples > 1 is not "
                                  "ported yet (ROADMAP.md queue 2)")
    val_set = create_dataset(opt["datasets"]["val"], "val")
    val_loader = create_dataloader(val_set, opt["datasets"]["val"], "val")
    full_b = val_loader.batch_size
    sample_fn = make_sample_fn(engine_val, denoise,
                               sampler=diff_opt.get("sampler") or "ancestral")
    sums = {"psnr": 0.0, "ssim": 0.0, "mse": 0.0, "ergas": 0.0}
    n = n_steady = 0
    t_steady = 0.0
    for batch in val_loader:
        b = batch["SR"].shape[0]
        cond, gens = pad_batch_with_keys(batch["SR"], full_b, seed, n,
                                         device=device)
        t0 = time.time()
        sr = sample_fn(cond, gens).cpu().numpy()   # .cpu() waits for it
        dt = time.time() - t0
        if not np.isfinite(sr).all():
            raise FloatingPointError(f"non-finite SR output in images "
                                     f"{n}..{n + b - 1}")
        note = " incl. set-up" if n == 0 else ""
        if n:
            t_steady += dt
            n_steady += b
        for j in range(b):
            sr_img = M.tensor2img(sr[j])
            hr_img = M.tensor2img(batch["HR"][j])
            m = {"psnr": M.calculate_psnr(sr_img, hr_img),
                 "ssim": M.calculate_ssim(sr_img, hr_img),
                 "mse": M.calculate_mse(sr_img, hr_img),
                 "ergas": M.calculate_ergas(sr_img, hr_img, scale=scale)}
            for k in sums:
                sums[k] += m[k]
            if save_images:
                M.save_img(sr_img, os.path.join(result_path, f"{n}_sr.png"))
                M.save_img(hr_img, os.path.join(result_path, f"{n}_hr.png"))
                M.save_img(M.tensor2img(batch["SR"][j]),
                           os.path.join(result_path, f"{n}_inf.png"))
            logger.info(f"img {n}: psnr {m['psnr']:.4f} ssim {m['ssim']:.4f}"
                        f" mse {m['mse']:.1f} ergas {m['ergas']:.4f} "
                        f"({dt / full_b:.3f}s{note})")
            n += 1
    if n == 0:
        return {}
    res = {k: v / n for k, v in sums.items()}
    if n_steady:
        res["avg_time"] = t_steady / n_steady
    logger.info("# Validation # " + " ".join(f"{k}: {v:.4e}"
                                              for k, v in res.items()))
    return res


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-gpu", "--gpu_ids", type=str, default=None,
                        help="reference-CLI compatibility (sr_mfe.py:26): "
                             "accepted and logged; --device selects the card")
    parser.add_argument("-p", "--phase", type=str, choices=["train", "val"],
                        default="train")
    parser.add_argument("-debug", action="store_true")
    parser.add_argument("-enable_wandb", action="store_true")
    parser.add_argument("-use_ema", action="store_true",
                        help="validate the EMA params instead of the raw "
                             "params")
    parser.add_argument("-dist", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if args.dist:
        raise NotImplementedError("-dist (multi-process data parallel) is "
                                  "not ported yet (ROADMAP.md queue 4)")
    if args.enable_wandb:
        raise NotImplementedError("-enable_wandb is not ported yet "
                                  "(ROADMAP.md queue 9, tooling)")

    from ..config import dict2str, infer_scale, parse
    from ..device import resolve_device, use_ieee_float32
    from ..train import (create_train_state, make_cached_train_step,
                         make_optimizer, make_train_step, step_generator)
    from ..train.checkpoint import load_state, save_state
    from ..utils.logging import make_tb_writer, setup_logger
    from .infer import load_params, make_denoiser

    device = resolve_device(args.device)
    use_ieee_float32()
    opt = parse(args.config, args.phase, debug=args.debug)
    logger = setup_logger("base", opt["path"]["log"], "train", screen=True)
    val_logger = setup_logger("val", opt["path"]["log"], "val")
    if args.debug:
        ensure_debug_data(opt, logger, args.seed)
    logger.info(dict2str(opt))
    if args.gpu_ids is not None:
        logger.info(f"-gpu {args.gpu_ids} accepted; running on {device}")
    tb = make_tb_writer(opt["path"]["tb_logger"])
    scale = infer_scale(opt)
    eng_train, eng_val, net = build_all(opt, device, args.seed)
    logger.info(f"device {device}, float32 without TF32, scale x{scale}")

    if args.phase == "val":
        if opt["path"]["resume_state"]:
            load_params(net, opt["path"]["resume_state"], args.use_ema)
            logger.info(f"loaded {'EMA ' if args.use_ema else ''}params "
                        f"from {opt['path']['resume_state']}")
        result_path = opt["path"]["results"]
        os.makedirs(result_path, exist_ok=True)
        return run_validation(opt, eng_val, make_denoiser(net, True,
                                                          torch.float32),
                              result_path, val_logger, seed=args.seed,
                              device=device, scale=scale)

    from ..data import create_dataloader, create_dataset
    from ..models.unet_fastdiffsr import unet_from_config

    train_opt = opt["train"]
    state = create_train_state(
        net, make_optimizer(net.parameters(), train_opt["optimizer"]))
    ema_cfg = train_opt.get("ema_scheduler") or {}
    ema = dict(ema_decay=float(ema_cfg.get("ema_decay", 0.9999)),
               ema_start=int(ema_cfg.get("step_start_ema", 5000)))
    if opt["path"]["resume_state"]:
        load_state(opt["path"]["resume_state"], state)
        logger.info(f"resumed from {opt['path']['resume_state']} at step "
                    f"{state.step}")
    # the val forward reads its own copy of the (EMA) params
    val_net = unet_from_config(opt["model"]["unet"], device=device)
    current_step, current_epoch = state.step, state.epoch
    train_set = create_dataset(opt["datasets"]["train"], "train")
    bsz = int(opt["datasets"]["train"]["batch_size"] or 1)
    n_iter = int(train_opt["n_iter"])
    steps_per_epoch = max(len(train_set) // max(bsz, 1), 1)
    use_cache = bool(opt["datasets"]["train"].get("device_cache"))
    if use_cache:
        device_data = {k: torch.from_numpy(np.array(v)).to(device)
                       for k, v in train_set.raw_uint8().items()}
        cached_step = make_cached_train_step(eng_train, bsz, **ema)
        logger.info(f"device-resident dataset: {len(train_set)} tiles "
                    "(batches drawn WITH replacement; '<epoch:N>' counts "
                    f"{steps_per_epoch}-step windows)")
    else:
        train_loader = create_dataloader(train_set, opt["datasets"]["train"],
                                         "train")
        step_fn = make_train_step(eng_train, **ema)

    def checkpoint():
        state.epoch = current_epoch
        path = save_state(state, opt["path"]["checkpoint"], it=current_step,
                          epoch=current_epoch)
        logger.info(f"saved checkpoint {path}")
        return path

    loss_window, losses = [], []
    steps_done = 0
    t_first = None
    paused = 0.0      # seconds spent in validation and saves after step 1
    while current_step < n_iter:
        if use_cache:
            inner = [None] * steps_per_epoch
        else:
            current_epoch += 1
            inner = train_loader
        for batch in inner:
            if current_step >= n_iter:
                break
            if use_cache:
                state, metrics = cached_step(state, device_data, args.seed)
            else:
                batch = {k: torch.from_numpy(batch[k]).to(device)
                         for k in ("HR", "SR")}
                state, metrics = step_fn(
                    state, batch,
                    step_generator(args.seed, current_step, device))
            current_step += 1
            steps_done += 1
            if use_cache:
                current_epoch = current_step // steps_per_epoch
            loss_window.append(metrics["l_pix"])
            losses.append(metrics["l_pix"])
            if steps_done == 1:
                _sync(device)
                t_first = time.time()

            if current_step % int(train_opt["print_freq"]) == 0:
                window = torch.stack(loss_window).float().cpu().numpy()
                loss_window.clear()
                l_pix, l_avg = float(window[-1]), float(window.mean())
                logger.info(f"<epoch:{current_epoch:3d}, iter:"
                            f"{current_step:8,d}> l_pix: {l_pix:.4e} "
                            f"(avg {l_avg:.4e})")
                if tb:
                    tb.add_scalar("l_pix", l_pix, current_step)
                    tb.add_scalar("l_pix_avg", l_avg, current_step)
            val_now = current_step % int(train_opt["val_freq"]) == 0
            save_now = current_step % int(
                train_opt["save_checkpoint_freq"]) == 0
            if val_now or save_now:
                _sync(device)
                t_pause = time.time()
                if val_now:
                    val_net.load_state_dict(state.ema_or_params(args.use_ema))
                    result_path = os.path.join(opt["path"]["results"],
                                               str(current_epoch))
                    os.makedirs(result_path, exist_ok=True)
                    res = run_validation(
                        opt, eng_val,
                        make_denoiser(val_net, True, torch.float32),
                        result_path, val_logger, seed=args.seed,
                        device=device, scale=scale)
                    if tb:
                        for k, v in res.items():
                            tb.add_scalar(f"val/{k}", v, current_step)
                if save_now:
                    checkpoint()
                _sync(device)
                if steps_done > 1:
                    paused += time.time() - t_pause
                else:
                    t_first = time.time()

    _sync(device)
    t_end = time.time()
    path = checkpoint()
    rate = ((steps_done - 1) / (t_end - t_first - paused)
            if steps_done > 1 else None)
    if rate is not None:
        logger.info(f"train: {steps_done} steps, steady {rate:.4f} steps/s "
                    "(the first step, validation and saves left out)")
    logger.info("training complete")
    return {"steps": steps_done, "step": current_step, "checkpoint": path,
            "steady_steps_per_s": rate,
            "l_pix": torch.stack(losses).tolist() if losses else []}


if __name__ == "__main__":
    main()
