#!/usr/bin/env python3
"""Per-image device busy time and idle share of 128->512 inference on one GPU.

    python3 tools/torch_infer_trace.py [--seed 0]

Runs ``fastdiffsr_tpu_torch.cli.infer`` of the port's
configs/sr_fastdiffsr_infer_x4.json (full width, 128->512, T=20, batch 1,
fused forward, seeded weights) on a synthetic pack of IMAGES 128->512
images from ``--seed``, in bf16 and then f32, twice each: once as the
CLI runs, for its per-image latencies, and once under torch.profiler
with each image's
sampling marked (up to a device synchronize). For every image of the
profiled run it prints the wall time, the device busy time (the union of
the kernels that started in the image's window), the idle share of the
window, the kernel count, the host time spent in CUDA launch calls, and
the wall and thread CPU time the host took to enqueue the image's work;
then, per type, how the wall time moves with the busy time, the idle
time and the enqueue CPU time (Pearson r). The
first image of each run is set-up and is left out of the summaries.
Every line carries the card's name and power limit; the numbers also go
to build/infer_trace.json. It needs a CUDA device and exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARK = "infer_image"
IMAGES = 24     # per run; the first is set-up


def spread(xs) -> str:
    s = sorted(xs)
    return f"min {s[0]:.4f}, median {s[len(s) // 2]:.4f}, max {s[-1]:.4f}"


def pearson(xs, ys) -> float:
    import numpy as np
    if np.std(xs) == 0 or np.std(ys) == 0:
        return float("nan")
    return float(np.corrcoef(xs, ys)[0, 1])


def per_image(events, device_type):
    """One row per marked image: host wall, device busy, kernels and the
    host's launch-call time within the image's window (ms)."""
    from torch_train_profile import union_us
    marks = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == MARK and e.device_type != device_type)
    kern = [(e.time_range.start, e.time_range.end) for e in events
            if e.device_type == device_type and e.name != MARK]
    launch = [(e.time_range.start, e.time_range.end) for e in events
              if e.name.startswith(("cudaLaunch", "cuLaunch"))]
    rows = []
    for s, e in marks:
        ks = [k for k in kern if s <= k[0] <= e]
        busy = union_us(ks)
        rows.append({"wall_ms": (e - s) / 1e3, "busy_ms": busy / 1e3,
                     "idle_share": 1 - busy / (e - s), "kernels": len(ks),
                     "launch_call_ms": sum(b - a for a, b in launch
                                           if s <= a <= e) / 1e3})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_infer_trace: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import card_line, variant_cfg
    from fastdiffsr_tpu_torch import train
    from fastdiffsr_tpu_torch.cli import infer
    from fastdiffsr_tpu_torch.data import write_pack
    card = card_line()
    cfg = variant_cfg("fastdiffsr", "infer_x4")
    ds = cfg["datasets"]["val"]
    l_res, r_res = int(ds["l_resolution"]), int(ds["r_resolution"])
    work = os.path.join(ROOT, "build", "trace")
    pack = write_pack(os.path.join(work, f"pack_{l_res}_{r_res}_{args.seed}"),
                      IMAGES, args.seed + 13, l_res, r_res)
    ds.update(dataroot=pack, datatype="npy", batch_size=1, data_len=IMAGES)
    make = train.make_sample_fn
    host = []

    def marked(*a, **kw):
        fn = make(*a, **kw)

        def sample(*b, **kwb):
            with record_function(MARK):
                t0, c0 = time.perf_counter(), time.thread_time()
                y = fn(*b, **kwb)
                host.append({"enqueue_wall_ms": 1e3 * (time.perf_counter()
                                                      - t0),
                             "enqueue_cpu_ms": 1e3 * (time.thread_time()
                                                     - c0)})
                torch.cuda.synchronize()
            return y
        return sample

    out = {"card": card, "torch": torch.__version__, "images": IMAGES,
           "runs": {}}
    for dt in ("bf16", "f32"):
        cfg["name"] = f"infer_trace_{r_res}_{dt}"
        path = os.path.join(work, f"{cfg['name']}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        cli_args = ["-c", path, "--device", "cuda", "--dtype", dt,
                    "--seed", str(args.seed)]
        plain = infer.main(cli_args)["latencies_s"]
        print(f"[latency] {card} | cli.infer {l_res}->{r_res} {dt}, batch 1, "
              f"{len(plain)} steady images, no profiler: mean "
              f"{sum(plain) / len(plain):.4f} s/img ({spread(plain)})",
              flush=True)
        train.make_sample_fn = marked
        host.clear()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                infer.main(cli_args)
                torch.cuda.synchronize()
        finally:
            train.make_sample_fn = make
        rows = [dict(r, **h) for r, h in zip(
            per_image(prof.events(), torch.autograd.DeviceType.CUDA), host)]
        for i, r in enumerate(rows):
            print(f"[image] {card} | {dt} {i}{' (set-up)' if i == 0 else ''}: "
                  f"wall {r['wall_ms']:.2f} ms, device busy "
                  f"{r['busy_ms']:.2f} ms, idle share {r['idle_share']:.3f}, "
                  f"{r['kernels']} kernels, launch calls "
                  f"{r['launch_call_ms']:.2f} ms, enqueue wall "
                  f"{r['enqueue_wall_ms']:.2f} ms, enqueue CPU "
                  f"{r['enqueue_cpu_ms']:.2f} ms", flush=True)
        steady = rows[1:]
        if not steady or not any(r["kernels"] for r in steady):
            print(f"[trace] {card} | {dt}: device time not measured (the "
                  "profiler saw no device events)", flush=True)
            out["runs"][dt] = {"latencies_s": plain, "images": rows}
            continue
        wall = [r["wall_ms"] for r in steady]
        busy = [r["busy_ms"] for r in steady]
        idle = [w - b for w, b in zip(wall, busy)]
        cpu = [r["enqueue_cpu_ms"] for r in steady]
        summary = {"wall_ms": spread(wall), "busy_ms": spread(busy),
                   "idle_ms": spread(idle),
                   "idle_share": spread([r["idle_share"] for r in steady]),
                   "launch_call_ms": spread([r["launch_call_ms"]
                                             for r in steady]),
                   "enqueue_wall_ms": spread([r["enqueue_wall_ms"]
                                              for r in steady]),
                   "enqueue_cpu_ms": spread(cpu),
                   "r_wall_busy": pearson(wall, busy),
                   "r_wall_idle": pearson(wall, idle),
                   "r_wall_enqueue_cpu": pearson(wall, cpu)}
        print(f"[trace] {card} | {dt}, {len(steady)} steady images under the "
              f"profiler: wall ms {summary['wall_ms']}; device busy ms "
              f"{summary['busy_ms']}; idle ms {summary['idle_ms']}; idle "
              f"share {summary['idle_share']}; launch calls ms "
              f"{summary['launch_call_ms']}; enqueue wall ms "
              f"{summary['enqueue_wall_ms']}; enqueue CPU ms "
              f"{summary['enqueue_cpu_ms']} | wall against busy r = "
              f"{summary['r_wall_busy']:.3f}, against idle r = "
              f"{summary['r_wall_idle']:.3f}, against enqueue CPU r = "
              f"{summary['r_wall_enqueue_cpu']:.3f}", flush=True)
        out["runs"][dt] = {"latencies_s": plain, "images": rows,
                           "summary": summary}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "infer_trace.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
