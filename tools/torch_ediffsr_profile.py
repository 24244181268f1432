#!/usr/bin/env python3
"""Where EDiffSR's time goes on one GPU: the full-width NAFNet train step
and one reverse-SDE step of a restore.

    python3 tools/torch_ediffsr_profile.py [--seed 0] [--steps 10]
        [--evals 20] [--eval-cudnn heuristics|timed]

Builds the paper's ConditionalNAFNet (setting_mfe_Train_x4.yml: width
64, enc [14,1,1,1], T=100) with seeded weights and runs, as
``fastdiffsr_tpu_torch.ediffsr.train`` does (IEEE float32):

- ``--steps`` train steps at batch 2, 256x256 (matching loss, AdamW,
  EMA; cuDNN timing its algorithms): steps/s and peak memory, then the
  same steps under torch.profiler;
- ``--evals`` reverse-SDE steps of a 64->256 restore at batch 1 (one
  NAFNet forward each), with cuDNN on its heuristics (what ``--test``
  and the in-run validation use) or, with ``--eval-cudnn timed``, timing
  its algorithms: ms per step, then the same steps under torch.profiler.

For each profiled window it prints the device busy time and idle share,
the kernel time by class and the top kernels. PyTorch keeps the first
cuDNN plan it made for a shape, so compare the two ``--eval-cudnn``
settings in two processes. Every line carries the card's name and power
limit; the numbers also go to build/ediffsr_profile.json. It needs a
CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile_window(card, label, fn, n, per):
    """Run ``fn`` ``n`` times under torch.profiler; print and return the
    busy time, idle share, kernel classes and top kernels per ``per``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch_train_profile import classify, union_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        print(f"[profile] {card} | {label}: device time not measured (the "
              "profiler saw no device events)", flush=True)
        return None
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    window = max(s[1] for s in spans) - min(s[0] for s in spans)
    busy = union_us((e.time_range.start, e.time_range.end) for e in kern)
    by_cls, by_name = {}, {}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        by_cls[classify(e.name)] = by_cls.get(classify(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    cls = {k: v / n / 1e3 for k, v in by_cls.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"window_ms": window / n / 1e3, "busy_ms": busy / n / 1e3,
           "idle_share": 1 - busy / window, "kernels": len(kern) / n,
           "ms_by_class": cls,
           "top_kernels_ms": {k: v / n / 1e3 for k, v in top}}
    print(f"[profile] {card} | {label}: window {out['window_ms']:.2f} ms/"
          f"{per}, device busy {out['busy_ms']:.2f} ms/{per}, idle share "
          f"{out['idle_share']:.3f}, {out['kernels']:.0f} kernels/{per} | "
          f"ms/{per} by class: " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(cls.items(),
                                                key=lambda kv: -kv[1])),
          flush=True)
    for name, us in top:
        print(f"[profile]   {us / n / 1e3:8.3f} ms/{per}  {name[:110]}",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--evals", type=int, default=20)
    ap.add_argument("--eval-cudnn", choices=["heuristics", "timed"],
                    default="heuristics")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_ediffsr_profile: no CUDA device visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from torch_train_profile import card_line

    from fastdiffsr_tpu_torch.device import (set_cudnn_autotuning,
                                             use_ieee_float32)
    from fastdiffsr_tpu_torch.diffusion.sde import IRSDE, IRSDEBuffers
    from fastdiffsr_tpu_torch.ediffsr import train as etrain
    from fastdiffsr_tpu_torch.ediffsr.deg import upscale
    from fastdiffsr_tpu_torch.ediffsr.options import load_yaml
    from fastdiffsr_tpu_torch.ediffsr.schedulers import make_lr_schedule
    from fastdiffsr_tpu_torch.models.nafnet import nafnet_from_config
    from fastdiffsr_tpu_torch.train import create_train_state, step_generator
    from fastdiffsr_tpu_torch.train.steps import image_generator

    use_ieee_float32()
    card = card_line()
    dev = torch.device("cuda")
    with open(os.path.join(ROOT, "fastdiffsr_tpu_torch", "ediffsr",
                           "options_yml", "setting_mfe_Train_x4.yml")) as f:
        opt = load_yaml(f.read())
    sde_cfg, train_opt = opt["sde"], opt["train"]
    sde = IRSDE(IRSDEBuffers.create(sde_cfg["max_sigma"], sde_cfg["T"],
                                    sde_cfg["schedule"], sde_cfg["eps"],
                                    device=dev))
    net = nafnet_from_config(opt["network_G"]["setting"], device=dev,
                             seed=args.seed, **etrain.naf_modes())
    B = int(opt["datasets"]["train"]["batch_size"])
    gt_size = int(opt["datasets"]["train"]["GT_size"])
    scale = int(opt["degradation"]["scale"])
    g = torch.Generator(device=dev).manual_seed(args.seed)
    batch = {"GT": torch.rand((B, gt_size, gt_size, 3), generator=g,
                              device=dev),
             "LQ": torch.rand((B, gt_size // scale, gt_size // scale, 3),
                              generator=g, device=dev)}
    state = create_train_state(net, etrain.make_optimizer_ediffsr(
        net.parameters(), train_opt))
    step = etrain.make_train_step(sde, scale, make_lr_schedule(
        train_opt, int(train_opt["niter"])))
    out = {"card": card, "torch": torch.__version__, "batch": B,
           "eval_cudnn": args.eval_cudnn}

    def train_step():
        step(state, batch, step_generator(args.seed, state.step, dev))

    set_cudnn_autotuning(True)
    for _ in range(3):
        train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for _ in range(args.steps):
        train_step()
    torch.cuda.synchronize()
    rate = args.steps / (time.time() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[train] {card} | NAFNet width 64 enc [14,1,1,1], B={B} "
          f"{gt_size}x{gt_size}, f32 (no TF32), cuDNN timed: {rate:.3f} "
          f"steps/s over {args.steps} steps | peak {peak:.2f} GiB",
          flush=True)
    out["train"] = {"steps_per_s": rate, "peak_gib": peak,
                    "profile": profile_window(card, "train step",
                                              train_step, args.steps,
                                              "step")}

    # one reverse-SDE step of a batch-1 restore (a fresh shape for cuDNN)
    set_cudnn_autotuning(args.eval_cudnn == "timed")
    net.eval()
    lq = batch["LQ"][:1]
    mu = upscale(lq, scale)
    gens = [image_generator(args.seed, 0, dev)]
    x = [sde.noise_state(mu, gens)]
    t_now = [sde.b.T]

    @torch.no_grad()
    def sde_step():
        t = t_now[0]
        pred = net(x[0], mu, torch.full((1,), float(t), device=dev))
        score = sde.get_score_from_noise(pred, t)
        eps = torch.randn(x[0].shape, generator=gens[0], device=dev)
        x[0] = sde.reverse_sde_step(x[0], mu, score, t, eps)
        t_now[0] = t - 1 if t > 1 else sde.b.T

    for _ in range(3):
        sde_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for _ in range(args.evals):
        sde_step()
    torch.cuda.synchronize()
    ms = (time.time() - t0) / args.evals * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[restore] {card} | one reverse-SDE step (a NAFNet forward) at "
          f"B=1 {mu.shape[1]}x{mu.shape[2]}, f32, cuDNN {args.eval_cudnn}: "
          f"{ms:.3f} ms over {args.evals} steps ({ms * sde.b.T / 1e3:.3f} s "
          f"per T={sde.b.T} image) | peak {peak:.2f} GiB", flush=True)
    out["restore"] = {"ms_per_step": ms, "peak_gib": peak,
                      "profile": profile_window(card, "restore step",
                                                sde_step, args.evals,
                                                "eval")}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build",
                           f"ediffsr_profile_{args.eval_cudnn}.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
