"""Train/val CLI of the port: counterpart of ``fastdiffsr_tpu/cli/sr_mfe.py``
(reference sr_mfe.py:20-386).

    python -m fastdiffsr_tpu_torch.cli.sr_mfe -p train -c <config.json> \\
        [-debug] [--device cuda|cpu] [--seed N] [-enable_wandb] \\
        [-log_wandb_ckpt] [-log_eval]
    python -m fastdiffsr_tpu_torch.cli.sr_mfe -p val -c <config.json> \\
        [-use_ema] [--device cuda|cpu] [--seed N] [-enable_wandb]

It runs on CUDA unless ``--device cpu`` is given, for the UNet of
``model.which_model_G``: fastdiffsr, ddpm or tesr (SR3) or gdp (guided).
Training runs the UNet forward in float32 (TF32 off,
``device.use_ieee_float32``; cuDNN's algorithms autotuned for ``-p
train``, its heuristics for ``-p val``, ``device.set_cudnn_autotuning``)
with dropout; every GroupNorm -> Swish of it
that is K1's function runs kernel K1. The loop reads
the data loader, or a uint8 copy of the train set on the device with
``datasets.train.device_cache: true``; prints l_pix with its windowed
mean every ``print_freq`` steps, validates every ``val_freq`` steps,
saves ``I{iter}_E{epoch}`` checkpoints every ``save_checkpoint_freq``
steps and at the end, and resumes from ``path.resume_state``. Validation
samples as ``cli/infer.py`` does: the fused forward (kernels K3 and K2 on
CUDA) for FastDiffSR, the plain UNet forward (K1) for the others, with
the sampler ``model.diffusion`` names (ancestral, ddim or dpm) and, with
``model.diffusion.n_samples`` K > 1, the mean of K samples per image; it
logs PSNR, SSIM, MSE, ERGAS and, where an LPIPS weight pack is found
(``FASTDIFFSR_TPU_LPIPS``), LPIPS on the same device per image. The
validation inside ``-p train`` runs with cuDNN's heuristics, the
training steps around it with timed algorithms. The val phase loads a
checkpoint directory of either package, or a UNet state-dict file
(a reference ``*_gen.pth`` too), and writes a ``{idx}_panel.png``
comparison per image where matplotlib imports. ``-enable_wandb`` logs to
Weights & Biases where ``wandb`` imports and is a no-op otherwise.

``--seed`` seeds the initial parameters, the train steps' draws
(``train.step_generator``) and the per-image sampling noise (pass k of
the K-sample average from ``train.pass_seed``). ``-debug``
shrinks the run as the reference does and writes a synthetic 6-image
npy pack for any dataroot that does not exist. ``-gpu`` is accepted and
logged; ``-dist`` is not ported.
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
                   save_images: bool = True, wandb_logger=None,
                   save_plots: bool = False) -> dict:
    """Sample the val set with ``denoise`` and log per-image PSNR, SSIM,
    MSE, ERGAS and LPIPS (where its weight pack is found; computed on
    ``device``) and their means; ``lpips`` is in the result when at least
    one image had it. ``save_plots`` writes ``{idx}_panel.png`` per image
    (the bicubic image's own PSNR/SSIM/ERGAS beside the SR's), or logs
    once that it skips them where matplotlib does not import.
    ``wandb_logger`` gets each image's metrics. ``model.diffusion`` picks
    the sampler
    (``sampler``, ``ddim_steps``, ``ddim_eta``) and ``n_samples`` K: the
    metrics are taken on the mean of K samples per image, pass k drawing
    from the per-image generators of ``pass_seed(seed, k)``. Times are
    per output image (all K passes); the first batch holds one-time
    set-up and is left out of ``avg_time`` (with one batch only,
    ``avg_time_incl_setup`` holds its time)."""
    from .. import metrics as M
    from ..data import create_dataloader, create_dataset
    from ..train import make_sample_fn, pad_batch_with_keys, pass_seed
    from .infer import sampler_options

    diff_opt = (opt.get("model") or {}).get("diffusion") or {}
    n_samp = int(diff_opt.get("n_samples") or 1)
    if n_samp < 1:
        raise ValueError(f"model.diffusion.n_samples={n_samp} (want >= 1)")
    val_set = create_dataset(opt["datasets"]["val"], "val")
    val_loader = create_dataloader(val_set, opt["datasets"]["val"], "val")
    full_b = val_loader.batch_size
    sample_fn = make_sample_fn(engine_val, denoise, **sampler_options(opt))
    if save_plots:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            logger.warning("matplotlib does not import: the comparison "
                           "panels ({idx}_panel.png) are skipped")
            save_plots = False
    sums = {"psnr": 0.0, "ssim": 0.0, "mse": 0.0, "ergas": 0.0}
    lpips_sum, lpips_n = 0.0, 0
    n = n_steady = 0
    t_steady = 0.0
    t_first = None
    for batch in val_loader:
        b = batch["SR"].shape[0]
        t0 = time.time()
        sr = None
        for k in range(n_samp):
            cond, gens = pad_batch_with_keys(batch["SR"], full_b,
                                             pass_seed(seed, k), n,
                                             device=device)
            out = sample_fn(cond, gens)
            sr = out if sr is None else sr + out
        sr = (sr / n_samp).cpu().numpy()           # .cpu() waits for it
        dt = time.time() - t0
        if not np.isfinite(sr).all():
            raise FloatingPointError(f"non-finite SR output in images "
                                     f"{n}..{n + b - 1}")
        note = " incl. set-up" if n == 0 else ""
        if n_samp > 1:
            note += (f", mean of {n_samp} samples, "
                     f"{dt / full_b / n_samp:.3f}s per pass")
        if n:
            t_steady += dt
            n_steady += b
        else:
            t_first = dt / full_b
        for j in range(b):
            sr_img = M.tensor2img(sr[j])
            hr_img = M.tensor2img(batch["HR"][j])
            bic_img = M.tensor2img(batch["SR"][j])
            m = {"psnr": M.calculate_psnr(sr_img, hr_img),
                 "ssim": M.calculate_ssim(sr_img, hr_img),
                 "mse": M.calculate_mse(sr_img, hr_img),
                 "ergas": M.calculate_ergas(sr_img, hr_img, scale=scale)}
            for k in sums:
                sums[k] += m[k]
            lp = M.calculate_lpips(sr_img, hr_img, device=device)
            if lp is not None:
                lpips_sum += lp
                lpips_n += 1
            if save_images:
                M.save_img(sr_img, os.path.join(result_path, f"{n}_sr.png"))
                M.save_img(hr_img, os.path.join(result_path, f"{n}_hr.png"))
                M.save_img(bic_img, os.path.join(result_path, f"{n}_inf.png"))
            if save_plots:
                M.plot_img(os.path.join(result_path, f"{n}_panel.png"),
                           bic_img, sr_img, hr_img, m["psnr"], m["ssim"],
                           m["ergas"], lp, M.calculate_psnr(bic_img, hr_img),
                           M.calculate_ssim(bic_img, hr_img),
                           M.calculate_ergas(bic_img, hr_img, scale=scale),
                           None)
            if wandb_logger is not None:
                wandb_logger.log_eval_data(sr_img, m["psnr"], m["ssim"],
                                           hr_img)
            logger.info(f"img {n}: psnr {m['psnr']:.4f} ssim {m['ssim']:.4f}"
                        f" mse {m['mse']:.1f} ergas {m['ergas']:.4f} lpips "
                        f"{'n/a' if lp is None else f'{lp:.4f}'} "
                        f"({dt / full_b:.3f}s{note})")
            n += 1
    if n == 0:
        return {}
    res = {k: v / n for k, v in sums.items()}
    if n_steady:
        res["avg_time"] = t_steady / n_steady
    else:
        res["avg_time_incl_setup"] = t_first
    if lpips_n:
        res["lpips"] = lpips_sum / lpips_n
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
    parser.add_argument("-log_wandb_ckpt", action="store_true")
    parser.add_argument("-log_eval", action="store_true")
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

    from ..config import dict2str, infer_scale, parse
    from ..device import (resolve_device, set_cudnn_autotuning,
                          use_ieee_float32)
    from ..train import (create_train_state, make_cached_train_step,
                         make_optimizer, make_train_step, step_generator)
    from ..train.checkpoint import load_state, save_state
    from ..utils.logging import make_tb_writer, setup_logger
    from .infer import build_unet, load_params, make_denoiser, resolve_fused

    device = resolve_device(args.device)
    use_ieee_float32()
    set_cudnn_autotuning(args.phase == "train")
    opt = parse(args.config, args.phase, debug=args.debug,
                enable_wandb=args.enable_wandb,
                log_wandb_ckpt=args.log_wandb_ckpt, log_eval=args.log_eval)
    logger = setup_logger("base", opt["path"]["log"], "train", screen=True)
    val_logger = setup_logger("val", opt["path"]["log"], "val")
    if args.debug:
        ensure_debug_data(opt, logger, args.seed)
    logger.info(dict2str(opt))
    if args.gpu_ids is not None:
        logger.info(f"-gpu {args.gpu_ids} accepted; running on {device}")
    tb = make_tb_writer(opt["path"]["tb_logger"])
    wandb_logger = None
    if opt["enable_wandb"]:
        from ..utils.wandb_logger import WandbLogger
        wandb_logger = WandbLogger(opt)
    scale = infer_scale(opt)
    variant = opt["model"]["which_model_G"]
    eng_train, eng_val, net = build_all(opt, device, args.seed)
    fused = resolve_fused(variant, None)
    logger.info(f"{variant}: device {device}, float32 without TF32, scale "
                f"x{scale}, validation on the "
                f"{'fused' if fused else 'plain'} forward")

    if args.phase == "val":
        if opt["path"]["resume_state"]:
            load_params(net, opt["path"]["resume_state"], args.use_ema,
                        variant=variant)
            logger.info(f"loaded {'EMA ' if args.use_ema else ''}params "
                        f"from {opt['path']['resume_state']}")
        result_path = opt["path"]["results"]
        os.makedirs(result_path, exist_ok=True)
        res = run_validation(opt, eng_val, make_denoiser(net, fused,
                                                         torch.float32),
                             result_path, val_logger, seed=args.seed,
                             device=device, scale=scale,
                             wandb_logger=wandb_logger, save_plots=True)
        if wandb_logger is not None:
            wandb_logger.log_eval_table(commit=True)
        return res

    from ..data import create_dataloader, create_dataset

    train_opt = opt["train"]
    state = create_train_state(
        net, make_optimizer(net.parameters(), train_opt["optimizer"]))
    ema_cfg = train_opt.get("ema_scheduler") or {}
    ema = dict(ema_decay=float(ema_cfg.get("ema_decay", 0.9999)),
               ema_start=int(ema_cfg.get("step_start_ema", 5000)))
    if opt["path"]["resume_state"]:
        load_state(opt["path"]["resume_state"], state, variant)
        logger.info(f"resumed from {opt['path']['resume_state']} at step "
                    f"{state.step}")
    # the val forward reads its own copy of the (EMA) params, built at the
    # first validation
    val_net, val_res = None, None
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
        if wandb_logger is not None and opt["log_wandb_ckpt"]:
            wandb_logger.log_checkpoint(current_epoch, current_step,
                                        ckpt_path=path)
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
                    if val_net is None:
                        val_net = build_unet(opt["model"], device=device)
                    val_net.load_state_dict(state.ema_or_params(args.use_ema))
                    result_path = os.path.join(opt["path"]["results"],
                                               str(current_epoch))
                    os.makedirs(result_path, exist_ok=True)
                    # batch-1 evaluation on cuDNN's heuristics, as -p val;
                    # its shapes are new to the process, so this holds
                    set_cudnn_autotuning(False)
                    res = val_res = run_validation(
                        opt, eng_val,
                        make_denoiser(val_net, fused, torch.float32),
                        result_path, val_logger, seed=args.seed,
                        device=device, scale=scale,
                        wandb_logger=wandb_logger)
                    set_cudnn_autotuning(True)
                    if tb:
                        for k, v in res.items():
                            tb.add_scalar(f"val/{k}", v, current_step)
                    if wandb_logger is not None and res:
                        wandb_logger.log_metrics(
                            {f"val/{k}": v for k, v in res.items()})
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
            "l_pix": torch.stack(losses).tolist() if losses else [],
            "last_validation": val_res}


if __name__ == "__main__":
    main()
