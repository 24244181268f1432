#!/usr/bin/env python3
"""Train-step rate and device-time breakdown of the PyTorch port on one GPU.

    python3 tools/torch_train_profile.py [--steps 10] [--seed 0]

Runs the full-width FastDiffSR train step (the port's
configs/sr_fastdiffsr_train_64_256.json: inner 64, mults [1,2,4,4], 2 res
blocks, dropout 0.2, 256x256, batch 4, f32, Adam, EMA) through
``train.make_train_step``, in two arms: the product path, whose Blocks
run kernel K1, and the same step with the Blocks on gn_swish_reference
(``chip_smoke.reference_norm``). The arms take turns ('reference', 'k1',
'k1', 'reference'), ``--steps`` timed steps per block after two warm-up
steps, and it prints steps/s and the peak device memory per block. Then
it profiles ``--steps`` steps of each arm with torch.profiler and prints
the device time by kernel class, the share of the window in which the
device ran no kernel (idle share), and the top kernels. TF32 is off, as
in the CLIs (``device.use_ieee_float32``).
Every line carries the card's name and power limit; the numbers also go
to build/train_profile.json. It needs a CUDA device and exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel-name fragments -> class (first match wins)
CLASSES = (
    ("K1 pass 2 (gn_swish_apply)", ("gn_swish_apply",)),
    ("K1 pass 1 (channel stats)", ("channel_stats_kernel",
                                   "reduce_partials")),
    ("conv / matmul", ("conv", "cudnn", "xmma", "implicit", "wgrad",
                       "dgrad", "gemm", "cutlass", "sm90_")),
    ("optimizer / EMA (foreach)", ("multi_tensor", "foreach")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where",
                     "copy", "fill")),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def make(cfg, seed, dev):
    import torch

    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.train import (create_train_state,
                                            make_optimizer, make_train_step)
    net = unet_from_config(cfg["model"]["unet"], device=dev, seed=seed)
    state = create_train_state(net, make_optimizer(
        net.parameters(), cfg["train"]["optimizer"]))
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(
                              cfg["model"]["beta_schedule"]["train"],
                              device=dev))
    step = make_train_step(eng, ema_start=0)
    return state, step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import reference_norm
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.device import use_ieee_float32
    from fastdiffsr_tpu_torch.train import step_generator
    use_ieee_float32()
    torch.backends.cudnn.benchmark = True
    card = card_line()
    dev = torch.device("cuda")
    cfg = load_json_config(os.path.join(
        ROOT, "fastdiffsr_tpu_torch", "configs",
        "sr_fastdiffsr_train_64_256.json"))
    B = int(cfg["datasets"]["train"]["batch_size"])
    r = int(cfg["datasets"]["train"]["r_resolution"])
    g = torch.Generator(device=dev).manual_seed(args.seed)
    batch = {k: torch.rand((B, r, r, 3), generator=g, device=dev) * 2 - 1
             for k in ("HR", "SR")}
    arms = ("reference", "k1")
    runs = {a: make(cfg, args.seed, dev) for a in arms}

    def steps(arm, n):
        state, step = runs[arm]
        with (reference_norm() if arm == "reference"
              else contextlib.nullcontext()):
            for _ in range(n):
                step(state, batch, step_generator(args.seed, state.step,
                                                  dev))

    out = {"card": card, "torch": torch.__version__, "batch": B,
           "steps": args.steps, "blocks": [], "profiles": {}}
    for arm in arms:
        steps(arm, 2)
    torch.cuda.synchronize()
    for arm in ("reference", "k1", "k1", "reference"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        steps(arm, args.steps)
        torch.cuda.synchronize()
        rate = args.steps / (time.time() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out["blocks"].append({"arm": arm, "steps_per_s": rate,
                              "peak_gib": peak})
        print(f"[rate] {card} | {arm}: {rate:.4f} steps/s "
              f"({rate * B:.2f} img/s) over {args.steps} steps, B={B}, "
              f"{r}x{r}, f32 | peak {peak:.2f} GiB (both arms' nets and "
              "optimizer states are resident)", flush=True)
    for arm in arms:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps(arm, args.steps)
            torch.cuda.synchronize()
        events = prof.events()
        kern = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = [(e.time_range.start, e.time_range.end) for e in events]
        window = max(s[1] for s in spans) - min(s[0] for s in spans)
        if not kern:
            print(f"[profile] {card} | {arm}: device time not "
                  "measured (the profiler saw no device events)", flush=True)
            continue
        busy = union_us((e.time_range.start, e.time_range.end) for e in kern)
        by_cls, by_name = {}, {}
        for e in kern:
            us = e.time_range.end - e.time_range.start
            by_cls[classify(e.name)] = by_cls.get(classify(e.name), 0.0) + us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
        per_step = {k: v / args.steps / 1e3 for k, v in by_cls.items()}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        prof_out = {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
                    "idle_share": 1 - busy / window,
                    "ms_per_step_by_class": per_step,
                    "top_kernels_ms_per_step": {
                        n: us / args.steps / 1e3 for n, us in top}}
        out["profiles"][arm] = prof_out
        print(f"[profile] {card} | {arm}, {args.steps} steps: "
              f"window {window / 1e3 / args.steps:.2f} ms/step, device busy "
              f"{busy / 1e3 / args.steps:.2f} ms/step, idle share "
              f"{1 - busy / window:.3f} | ms/step by class: " + ", ".join(
                  f"{k} {v:.2f}" for k, v in sorted(
                      per_step.items(), key=lambda kv: -kv[1])), flush=True)
        for n, us in top:
            print(f"[profile]   {us / args.steps / 1e3:8.3f} ms/step  "
                  f"{n[:110]}", flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "train_profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
