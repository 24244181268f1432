#!/usr/bin/env python3
"""Where the MSI baselines' time goes on one GPU: one full-width train
step and one batch-1 validation forward of each model.

    python3 tools/torch_msi_profile.py [--models SwinIR,HAT,...]
        [--steps 10] [--evals 20]

Builds each model at full width (JAX ``msi/main.py`` defaults, x4) with
the seeded initial weights and runs, as ``msi.main`` does (IEEE float32):

- ``--steps`` train steps of ``SupervisedSRTrainer.train_step`` at batch
  1, crop 256 (LR 64x64) on a batch that stays on the device (cuDNN
  timing its algorithms): steps/s and peak memory, then the same steps
  under torch.profiler;
- ``--evals`` forwards at batch 1 on an LR 64x64 tile under
  ``torch.no_grad`` (cuDNN on its heuristics; PyTorch keeps the plans
  the train steps timed for the same shapes): ms per forward, then the
  same forwards under torch.profiler.

For each profiled window it prints the device busy time, the idle share
of the window and of the unprofiled time per step, the kernels per step,
the kernel time by class (convolutions, GEMMs, softmax/attention, norms,
elementwise, reductions, optimizer) and the top kernels. Every line carries the card's name and power limit; the numbers
also go to build/msi_profile.json. It needs a CUDA device and exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel-name fragments -> class (first match wins)
CLASSES = (
    ("convolutions", ("conv", "fprop", "dgrad", "wgrad", "winograd",
                      "implicit", "cudnn", "im2col", "col2im")),
    ("GEMMs", ("gemm", "gemv", "cublas", "cutlass", "xmma")),
    ("softmax/attention", ("softmax", "attention", "fmha", "flash")),
    ("norms", ("norm", "gammabeta")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where",
                     "copy", "fill", "cat", "index", "upsample",
                     "gelu", "pad", "roll")),
)


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def profile_window(card, label, fn, n, per, plain_ms):
    """Run ``fn`` ``n`` times under torch.profiler; print and return the
    busy time, the idle share of the profiled window and of ``plain_ms``
    (the time per call measured without the profiler, whose host
    overhead stretches the window), kernels and kernel classes per
    ``per``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch_train_profile import union_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    # device activity without the ranges record_function marks on the
    # device (Optimizer.step's), which are no kernels
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"window_ms": window / n / 1e3, "busy_ms": busy / n / 1e3,
           "idle_share": 1 - busy / window, "kernels": len(kern) / n,
           "idle_share_unprofiled": 1 - busy / n / 1e3 / plain_ms,
           "ms_by_class": cls,
           "top_kernels_ms": {k: v / n / 1e3 for k, v in top}}
    print(f"[profile] {card} | {label}: window {out['window_ms']:.2f} ms/"
          f"{per}, device busy {out['busy_ms']:.2f} ms/{per}, idle share "
          f"{out['idle_share']:.3f} (of the {plain_ms:.2f} ms unprofiled: "
          f"{out['idle_share_unprofiled']:.3f}), {out['kernels']:.0f} "
          f"kernels/{per} | "
          f"ms/{per} by class: " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(cls.items(),
                                                key=lambda kv: -kv[1])),
          flush=True)
    for name, us in top:
        print(f"[profile]   {us / n / 1e3:8.3f} ms/{per}  {name[:110]}",
              flush=True)
    return out


def profile_model(card, name, steps, evals, dev):
    import torch

    from fastdiffsr_tpu_torch.device import set_cudnn_autotuning
    from fastdiffsr_tpu_torch.msi.main import build_model
    from fastdiffsr_tpu_torch.msi.trainer import SupervisedSRTrainer
    from fastdiffsr_tpu_torch.train import step_generator

    args = types.SimpleNamespace(
        scale_factor=4, tiny=False, lr=2e-4, b1=0.9, b2=0.999,
        save_dir=os.path.join(ROOT, "build", "msi_profile", name))
    tr = SupervisedSRTrainer(build_model(name, args), args, device=dev)
    n_params = sum(p.numel() for p in tr.net.parameters())
    g = torch.Generator(device=dev).manual_seed(0)
    lr = torch.rand((1, 64, 64, 3), generator=g, device=dev)
    hr = torch.rand((1, 256, 256, 3), generator=g, device=dev)
    out = {"params": n_params}

    def train_step():
        tr.train_step(lr, hr, step_generator(1, tr.state.step, dev))

    set_cudnn_autotuning(True)
    for _ in range(3):
        train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for _ in range(steps):
        train_step()
    torch.cuda.synchronize()
    rate = steps / (time.time() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[train {name}] {card} | full width ({n_params / 1e6:.2f} M "
          f"params), x4, B=1, LR 64x64 -> 256x256, f32 (no TF32), cuDNN "
          f"timed, batch on the device: {rate:.3f} steps/s over {steps} "
          f"steps | peak {peak:.2f} GiB", flush=True)
    out["train"] = {"steps_per_s": rate, "peak_gib": peak,
                    "profile": profile_window(card, f"{name} train step",
                                              train_step, steps, "step",
                                              1e3 / rate)}

    set_cudnn_autotuning(False)
    tr.net.eval()

    @torch.no_grad()
    def forward():
        tr.net(lr)

    for _ in range(3):
        forward()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(evals):
        forward()
    torch.cuda.synchronize()
    ms = (time.time() - t0) / evals * 1e3
    print(f"[eval {name}] {card} | batch-1 forward, LR 64x64: {ms:.3f} ms "
          f"over {evals} forwards", flush=True)
    out["eval"] = {"ms_per_forward": ms,
                   "profile": profile_window(card, f"{name} eval forward",
                                             forward, evals, "forward",
                                             ms)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="SwinIR,HAT,HSENet,TransENet,NDSRGAN")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--evals", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_msi_profile: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from torch_train_profile import card_line

    from fastdiffsr_tpu_torch.device import use_ieee_float32

    use_ieee_float32()
    card = card_line()
    dev = torch.device("cuda")
    out = {"card": card, "torch": torch.__version__}
    for name in args.models.split(","):
        out[name] = profile_model(card, name, args.steps, args.evals, dev)
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "msi_profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
