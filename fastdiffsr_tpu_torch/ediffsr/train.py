"""EDiffSR train/test CLI of the port: counterpart of
``fastdiffsr_tpu/ediffsr/train.py`` (reference EDiffSR/codes/config/sisr/
train.py and test.py).

    python -m fastdiffsr_tpu_torch.ediffsr.train -opt <yml> [--test] \\
        [--device cuda|cpu] [--max_iters N] [--val_images N] [--use_ema] \\
        [--sampler sde|ode|rk45] [--batch N]

It runs on CUDA unless ``--device cpu`` is given, in float32 without TF32
(``device.use_ieee_float32``), the denoiser named by
``network_G.which_model_G`` (ConditionalNAFNet or ConditionalUNet).

Training, per step: mu = ``deg.upscale`` of the LQ batch on the device,
random IR-SDE states and the matching loss (``diffusion/sde.py``), the
backward, AdamW/Adam/Lion with the option file's betas (AdamW with
optax's weight decay 1e-4; Lion's 1e-3) at the rate the LR schedule
gives for that step (``schedulers.make_lr_schedule``, warmup included,
set in the param group before each update as optax evaluates it), and an
EMA of the parameters at ``0.995 ** (1/10)`` per step (the reference's
beta 0.995 every 10 steps). A step's draws (t and the noise) come from
``train.step_generator(manual_seed, step)``. Every ``val_freq`` steps it
validates (PSNR of the full T-step reverse SDE per image, best-PSNR
checkpoint and ``best.txt``, the SR images under ``val_images/<step>``);
it saves ``I{iter}_E0`` every ``save_checkpoint_freq`` steps and at the
end, and resumes from ``path.resume_state`` (a checkpoint directory of
either package; a JAX ``state.pkl`` brings its AdamW moments). cuDNN
times its algorithms for the training steps and keeps its heuristics for
every restore (``device.set_cudnn_autotuning``).

``--test`` restores the test set (``path.pretrain_model_G``: a checkpoint
directory of either package, with ``--use_ema`` its EMA params, or a
state-dict file such as a reference ``*_G.pth``; seeded initial weights
without it) and logs PSNR, SSIM, ERGAS and, where an LPIPS weight pack is
found (``FASTDIFFSR_TPU_LPIPS``), LPIPS per image and their means, the
latency per image after the first batch, the SR PNGs and, where
matplotlib imports, a comparison panel. The restore is the reverse SDE
(``sde``), its Euler probability-flow ODE (``ode``) or adaptive RK45 on
that ODE (``rk45``, whose accepted and trial step counts are logged).
It works per image: x_T = mu + max_sigma * eps and the SDE's noise come
from each image's own generator (``train.image_generator`` of the
manual seed and the image's index), so ``--batch N`` gives the images of
a batch-1 run.

``-launcher`` other than ``none`` (multi-process data parallel) is not
ported: it raises, naming its ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

# reference ema_pytorch.EMA(beta=0.995, update_every=10): the per-step
# equivalent decay is 0.995^(1/10)
EMA_BETA = 0.995
EMA_UPDATE_EVERY = 10
EMA_DECAY_PER_STEP = EMA_BETA ** (1.0 / EMA_UPDATE_EVERY)


def build(opt, device, seed: int = 0):
    """(IR-SDE with its buffers on ``device``, the float32 denoiser with
    seeded initial parameters, its ``which_model_G``)."""
    from ..diffusion.sde import IRSDE, IRSDEBuffers
    from ..models.cond_unet import cond_unet_from_config
    from ..models.nafnet import nafnet_from_config

    sde_cfg = opt["sde"]
    sde = IRSDE(IRSDEBuffers.create(
        max_sigma=float(sde_cfg["max_sigma"]), T=int(sde_cfg["T"]),
        schedule=sde_cfg["schedule"], eps=float(sde_cfg["eps"]),
        device=device))
    which = (opt["network_G"] or {}).get("which_model_G",
                                         "ConditionalNAFNet")
    setting = opt["network_G"]["setting"] or {}
    if which == "ConditionalUNet":
        net = cond_unet_from_config(setting, device=device, seed=seed)
    elif which == "ConditionalNAFNet":
        net = nafnet_from_config(setting, device=device, seed=seed,
                                 **naf_modes())
    else:
        raise ValueError(f"unknown which_model_G: {which}")
    return sde, net, which


def naf_modes() -> dict:
    """The NAFNet formulations the JAX package reads from the
    environment: ``FASTDIFFSR_TPU_NAF_UP`` ('tconv' by default, or '' for
    the literal 1x1 conv + PixelShuffle; the same function), and
    ``FASTDIFFSR_TPU_NAF_DW`` / ``FASTDIFFSR_TPU_NAF_FOLD``, whose
    non-default values raise in the port (not ported)."""
    return {"up_mode": os.environ.get("FASTDIFFSR_TPU_NAF_UP", "tconv"),
            "dw_mode": os.environ.get("FASTDIFFSR_TPU_NAF_DW", ""),
            "fold_mode": os.environ.get("FASTDIFFSR_TPU_NAF_FOLD", "")}


def make_optimizer_ediffsr(params, train_opt) -> torch.optim.Optimizer:
    """AdamW/Adam/Lion with the option file's betas and optax's other
    defaults (eps 1e-8; AdamW weight decay 1e-4, not torch's 1e-2; Lion's
    1e-3). The rate is set per step from the schedule."""
    from ..train.state import Lion

    lr = float(train_opt.get("lr_G", 4e-5))
    betas = (float(train_opt.get("beta1", 0.9)),
             float(train_opt.get("beta2", 0.99)))
    kind = str(train_opt.get("optimizer", "AdamW")).lower()
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                 weight_decay=1e-4)
    if kind == "adam":
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    if kind == "lion":
        return Lion(params, lr=lr, betas=betas, weight_decay=1e-3)
    raise ValueError(kind)


def make_train_step(sde, scale: int, sched, loss_type: str = "l1",
                    weight: float = 1.0):
    """train_step(state, batch, generator) -> (state, loss): one update
    of ``state.net`` at rate ``sched(state.step)``, then the EMA.
    ``batch`` holds 'GT' and 'LQ' (B,H,W,C) in [0, 1] on the net's
    device; ``generator`` draws t and the noise of the SDE states."""
    from .deg import upscale

    def train_step(state, batch, generator):
        net = state.net
        net.train()
        for group in state.optimizer.param_groups:
            group["lr"] = sched(state.step)
        mu = upscale(batch["LQ"], scale)
        loss = weight * sde.matching_loss(net, batch["GT"], mu, generator,
                                          loss_type=loss_type)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        named = list(net.named_parameters())
        with torch.no_grad():
            ema = [state.ema_params[k] for k, _ in named]
            torch._foreach_mul_(ema, EMA_DECAY_PER_STEP)
            torch._foreach_add_(ema, [p.detach() for _, p in named],
                                alpha=1.0 - EMA_DECAY_PER_STEP)
        state.step += 1
        return state, loss.detach()

    return train_step


@torch.no_grad()
def restore(net, sde, lq: torch.Tensor, generators, scale: int,
            sampler: str = "sde"):
    """SR batch of an LQ batch (B,h,w,C) in [0, 1]: mu = upscale(LQ),
    x_T = mu + max_sigma * eps, then the reverse SDE, its Euler ODE or
    RK45 (reference test.py:84-131). Returns (SR, info): info holds the
    RK45 step counts."""
    from .deg import upscale

    net.eval()
    mu = upscale(lq, scale)
    xt = sde.noise_state(mu, generators)
    if sampler == "rk45":
        x, n_acc, n_trial = sde.ode_sampler(net, xt, mu)
        return x, {"rk45_accepted": n_acc, "rk45_trials": n_trial}
    if sampler not in ("sde", "ode"):
        raise ValueError(f"sampler={sampler!r} (want sde, ode or rk45)")
    return sde.reverse_sde(net, xt, mu, generators,
                           ode=sampler == "ode"), {}


def iter_sample_batches(loader, batch_size: int, max_images=None):
    """Group a batch-1 loader's samples into lists of ``batch_size``.
    Yields (start_index, [sample, ...])."""
    buf, start, n = [], 0, 0
    for batch in loader:
        if max_images is not None and n >= max_images:
            break
        buf.append(batch)
        n += 1
        if len(buf) == batch_size:
            yield start, buf
            start += len(buf)
            buf = []
    if buf:
        yield start, buf


def restore_batched(net, sde, samples, full_b: int, seed: int,
                    start_idx: int, scale: int, sampler: str, device):
    """Restore a list of batch-1 samples as one batch padded to
    ``full_b`` rows, image ``start_idx + i`` drawing from its own
    generator; returns ((n,H,W,C) numpy SR of the real images, info)."""
    from ..train import pad_batch_with_keys

    lq = np.concatenate([np.asarray(s["LQ"]) for s in samples], axis=0)
    lq, gens = pad_batch_with_keys(lq, full_b, seed, start_idx,
                                   device=device)
    out, info = restore(net, sde, lq, gens, scale, sampler)
    out = out[:len(samples)].cpu().numpy()        # waits for the device
    if not np.isfinite(out).all():
        last = start_idx + len(samples) - 1
        raise FloatingPointError(f"non-finite SR output in images "
                                 f"{start_idx}..{last}")
    return out, info


def to_u8(img) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def run_val(net, sde, val_loader, seed: int, scale: int, device,
            img_dir=None, max_images=None, batch_size: int = 1) -> dict:
    """PSNR over the val set (reference train.py:270-296), uint8 PSNR
    of the full reverse SDE against GT, with per-image generators of
    ``seed``. Returns {psnr, images, seconds}."""
    from .. import metrics as M

    psnrs = []
    t0 = time.time()
    for start, samples in iter_sample_batches(val_loader, batch_size,
                                              max_images):
        out, _ = restore_batched(net, sde, samples, batch_size, seed, start,
                                 scale, "sde", device)
        for j, s in enumerate(samples):
            sr8, gt8 = to_u8(out[j]), to_u8(s["GT"][0])
            psnrs.append(M.calculate_psnr(sr8, gt8))
            if img_dir is not None:
                M.save_img(sr8, os.path.join(img_dir, f"{start + j:03d}.png"))
    return {"psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
            "images": len(psnrs), "seconds": time.time() - t0}


def derived_seed(seed: int, stream: int, k: int) -> int:
    """A seed apart from the train steps' and the test images' streams
    (the validation of step k: stream 3)."""
    return int(np.random.SeedSequence([int(seed), int(stream), int(k)])
               .generate_state(1, np.uint32)[0])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_test(opt, args, net, sde, which, loaders, logger, device, seed,
             scale) -> dict:
    from .. import metrics as M
    from ..cli.infer import load_params
    from .deg import upscale

    if opt["path"]["pretrain_model_G"]:
        load_params(net, opt["path"]["pretrain_model_G"], args.use_ema,
                    variant=which)
        logger.info(f"loaded {'EMA ' if args.use_ema else ''}params from "
                    f"{opt['path']['pretrain_model_G']}")
    vb = int(args.batch
             or (opt["datasets"].get("val") or {}).get("batch_size") or 1)
    results_dir = opt["path"].get("results_root") or opt["path"]["log"]
    os.makedirs(results_dir, exist_ok=True)
    plots = True
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        logger.warning("matplotlib does not import: the comparison panels "
                       "({name}_plot.png) are skipped")
        plots = False
    ms = {"psnr": [], "ssim": [], "ergas": [], "lpips": []}
    t_steady, n_steady, t_first = 0.0, 0, None
    rk45 = []
    for start, samples in iter_sample_batches(loaders["val"], vb):
        t0 = time.time()
        out, info = restore_batched(net, sde, samples, vb, seed, start,
                                    scale, args.sampler, device)
        dt = time.time() - t0
        if info:
            rk45.append(info)
        if start == 0:                  # the first batch holds set-up
            t_first = dt
        else:
            t_steady += dt
            n_steady += vb              # padded rows compute too
        for j, s in enumerate(samples):
            i = start + j
            sr8, gt8 = to_u8(out[j]), to_u8(s["GT"][0])
            name = os.path.splitext(os.path.basename(
                s.get("LQ_path", [f"{i:03d}"])[0]))[0]
            M.save_img(sr8, os.path.join(results_dir, f"{name}.png"))
            p, q = M.calculate_psnr(sr8, gt8), M.calculate_ssim(sr8, gt8)
            e = M.calculate_ergas(sr8, gt8, scale=scale)
            lp = M.calculate_lpips(sr8, gt8, device=device)
            for k, v in (("psnr", p), ("ssim", q), ("ergas", e),
                         ("lpips", lp)):
                if v is not None:
                    ms[k].append(v)
            if plots:
                bc8 = to_u8(upscale(torch.from_numpy(
                    np.asarray(s["LQ"])), scale)[0].numpy())
                M.plot_img(os.path.join(results_dir, f"{name}_plot.png"),
                           bc8, sr8, gt8, p, q, e, lp)
            note = " incl. set-up" if start == 0 else ""
            steps = (f", rk45 {info['rk45_accepted']} accepted of "
                     f"{info['rk45_trials']} trial steps" if info else "")
            logger.info(f"img {i}: psnr {p:.3f} ssim {q:.4f} ergas {e:.4f} "
                        f"lpips {'n/a' if lp is None else f'{lp:.4f}'} "
                        f"({dt / vb:.3f}s/img{note}{steps})")
    res = {k: float(np.mean(v)) for k, v in ms.items() if v}
    res["images"] = len(ms["psnr"])
    res["sampler"] = args.sampler
    res["first_batch_s"] = t_first
    if n_steady:
        res["avg_time"] = t_steady / n_steady
    if rk45:
        res["rk45"] = rk45
    if ms["psnr"]:
        lp_part = f", mean lpips {res['lpips']:.4f}" if "lpips" in res else ""
        lat = (f"mean latency {res['avg_time']:.3f}s/img (the first batch, "
               f"{t_first:.1f}s incl. set-up, excluded)" if n_steady else
               f"latency {t_first:.3f}s incl. set-up")
        logger.info(f"# mean psnr {res['psnr']:.4f}, mean ssim "
                    f"{res['ssim']:.4f}, mean ergas {res['ergas']:.4f}"
                    f"{lp_part}, {lat}")
    return res


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True)
    parser.add_argument("--test", action="store_true",
                        help="run the test/eval path instead of training")
    parser.add_argument("--max_iters", type=int, default=None,
                        help="override niter (smoke runs)")
    parser.add_argument("--val_images", type=int, default=None,
                        help="cap in-train validation to N images")
    parser.add_argument("--use_ema", action="store_true",
                        help="test with the EMA params")
    parser.add_argument("--sampler", default="sde",
                        choices=["sde", "ode", "rk45"],
                        help="test-time sampler: reverse SDE, Euler "
                             "probability-flow ODE, or adaptive RK45")
    parser.add_argument("--batch", type=int, default=None,
                        help="eval batch size for --test and in-train "
                             "validation (default 1); per-image "
                             "generators keep results those of batch 1")
    parser.add_argument("-launcher", default="none",
                        choices=["none", "pytorch"])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.launcher != "none":
        raise NotImplementedError(
            f"-launcher {args.launcher} (multi-process data parallel) is "
            "not ported yet (ROADMAP.md queue 1 item 2)")

    from ..device import (resolve_device, set_cudnn_autotuning,
                          use_ieee_float32)
    from ..utils.logging import setup_logger
    from .data import create_ediffsr_loaders
    from .options import check_resume, parse_options

    device = resolve_device(args.device)
    use_ieee_float32()
    opt = parse_options(args.opt, is_train=not args.test)
    logger = setup_logger("ediffsr", opt["path"]["log"],
                          "test" if args.test else "train", screen=True)
    if not args.test:
        check_resume(opt)
    seed = int((opt["train"] or {}).get("manual_seed", 0) or 0)
    sde, net, which = build(opt, device, seed)
    scale = int((opt["degradation"] or {}).get("scale", 4))
    loaders = create_ediffsr_loaders(opt)
    logger.info(f"{which}: device {device}, float32 without TF32, scale "
                f"x{scale}, T={sde.b.T}")

    if args.test:
        set_cudnn_autotuning(False)
        return run_test(opt, args, net, sde, which, loaders, logger, device,
                        seed, scale)
    return run_train(opt, args, net, sde, which, loaders, logger, device,
                     seed, scale)


def run_train(opt, args, net, sde, which, loaders, logger, device, seed,
              scale) -> dict:
    from ..device import set_cudnn_autotuning
    from ..train import create_train_state, step_generator
    from ..train.checkpoint import load_state, save_state
    from ..utils.logging import setup_logger
    from .schedulers import make_lr_schedule

    train_opt = opt["train"]
    niter = args.max_iters or int(train_opt["niter"])
    sched = make_lr_schedule(train_opt, niter)
    state = create_train_state(net, make_optimizer_ediffsr(net.parameters(),
                                                           train_opt))
    if opt["path"]["resume_state"]:
        load_state(opt["path"]["resume_state"], state, which)
        logger.info(f"resumed from {opt['path']['resume_state']} at step "
                    f"{state.step}")
    step_fn = make_train_step(sde, scale, sched,
                              train_opt.get("loss_type", "l1"),
                              float(train_opt.get("weight", 1.0)))
    val_logger = setup_logger("ediffsr_val", opt["path"]["log"], "val")
    vb = int(args.batch or 1)
    print_freq = int((opt["logger"] or {}).get("print_freq", 100))
    save_freq = int((opt["logger"] or {}).get("save_checkpoint_freq",
                                              10_000))
    val_freq = int(train_opt.get("val_freq") or 0)
    best_psnr, best_iter = -1.0, 0
    losses, vals = [], []
    steps_done, t_first, paused = 0, None, 0.0
    last_ckpt = None
    set_cudnn_autotuning(True)
    while state.step < niter:
        for batch in loaders["train"]:
            if state.step >= niter:
                break
            b = {k: torch.from_numpy(batch[k]).to(device)
                 for k in ("GT", "LQ")}
            state, loss = step_fn(state, b, step_generator(seed, state.step,
                                                           device))
            step = state.step
            steps_done += 1
            losses.append(loss)
            if steps_done == 1:
                _sync(device)
                t_first = time.time()
            if step % print_freq == 0:
                logger.info(f"iter {step:8,d} lr {sched(step):.3e} "
                            f"loss {float(loss):.4e}")
            val_now = bool(val_freq) and step % val_freq == 0 \
                and "val" in loaders
            save_now = step % save_freq == 0 or step == niter
            if not (val_now or save_now):
                continue
            _sync(device)
            t_pause = time.time()
            if val_now:
                img_dir = os.path.join(opt["path"]["val_images"], str(step))
                os.makedirs(img_dir, exist_ok=True)
                set_cudnn_autotuning(False)      # restores: heuristics
                res = run_val(net, sde, loaders["val"],
                              derived_seed(seed, 3, step), scale, device,
                              img_dir=img_dir, max_images=args.val_images,
                              batch_size=vb)
                set_cudnn_autotuning(True)
                res["step"] = step
                vals.append(res)
                if res["psnr"] > best_psnr:
                    best_psnr, best_iter = res["psnr"], step
                    best = save_state(state, opt["path"]["models"], it=step,
                                      epoch=0)
                    with open(os.path.join(opt["path"]["models"],
                                           "best.txt"), "w") as f:
                        f.write(best + "\n")
                logger.info(f"# Validation # PSNR: {res['psnr']:.6f}, "
                            f"Best PSNR: {best_psnr:.6f}| Iter: {best_iter}"
                            f" ({res['seconds'] / max(res['images'], 1):.3f}"
                            " s per image)")
                val_logger.info(f"<iter:{step:8,d}, psnr: {res['psnr']:.6f}")
            if save_now:
                last_ckpt = save_state(state, opt["path"]["models"], it=step,
                                       epoch=0)
                logger.info(f"saved {last_ckpt}")
            _sync(device)
            if steps_done > 1:
                paused += time.time() - t_pause
            else:
                t_first = time.time()
    _sync(device)
    t_end = time.time()
    rate = ((steps_done - 1) / (t_end - t_first - paused)
            if steps_done > 1 else None)
    if rate is not None:
        logger.info(f"train: {steps_done} steps, steady {rate:.4f} steps/s "
                    "(the first step, validation and saves left out)")
    logger.info("training done")
    return {"steps": steps_done, "step": state.step, "checkpoint": last_ckpt,
            "steady_steps_per_s": rate,
            "loss": torch.stack(losses).tolist() if losses else [],
            "validations": vals}


if __name__ == "__main__":
    main()
