#!/usr/bin/env python3
"""Chained train steps (``train.steps_per_call``) against eager steps on one
GPU: whether a CUDA-graph replay of n steps computes the eager steps' bits,
and what decides it.

    python3 tools/torch_chain_check.py [--config sr_fastdiffsr_train_64_256]
        [--free-gib 8] [--json OUT]

Each arm is a process of its own (cuDNN keeps the plan of a convolution
shape for the life of a process). In every arm two states are built alike
from seed 0 (``cli.sr_mfe.build_all``, Adam as the config has it, 64
seeded device-cache tiles) on cuDNN's deterministic algorithms; one takes
8 eager steps (``make_cached_train_step``), the other a chain of 4
(warm-up and capture, then one replay of steps 4-7); the EMA starts at
step 6. Arms:

- ``capture_first`` / ``eager_first``: which of the two runs first, with
  cuDNN timing its candidates (``cudnn.benchmark``, chip_smoke's own
  regime);
- ``capture_first_heuristics``: cuDNN's heuristics (benchmark off);
- ``full_cache`` / ``full_cache_emptied`` (heuristics): just before the
  capture the allocator's cache is filled until ``--free-gib`` GiB of the
  card are free, and then left so (as a long process leaves it) or emptied
  (as ``_CapturedSteps`` does before it captures).

Per arm: max|d| of parameters, EMA and l_pix after step 8, bit-equal or
not; the out-of-memory errors the allocator raised during the chain's
first call (``num_ooms``: PyTorch's convolution catches them and takes
another plan); the device kernels of the replay and of eager steps 4-7
(torch.profiler), in all, with "fft" in their name, and the kernel names
whose counts differ. Ends with one JSON line; writes it to ``--json`` too.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = {"capture_first": ("capture", True, None),
        "eager_first": ("eager", True, None),
        "capture_first_heuristics": ("capture", False, None),
        "full_cache": ("capture", False, "keep"),
        "full_cache_emptied": ("capture", False, "empty")}
N = 4
TILES = 64
EMA_START = 6


def device_kernels(fn):
    """Counter of the device events' names over one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)


def setup(cfg_name, dev):
    import torch

    from fastdiffsr_tpu_torch.cli.sr_mfe import build_all
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.train import create_train_state, make_optimizer
    cfg = load_json_config(os.path.join(REPO, "fastdiffsr_tpu_torch",
                                        "configs", f"{cfg_name}.json"))
    eng, _, net = build_all(cfg, dev, 0)
    state = create_train_state(net, make_optimizer(
        net.parameters(), cfg["train"]["optimizer"]))
    r = int(cfg["datasets"]["train"]["r_resolution"])
    g = torch.Generator(device=dev).manual_seed(47)
    data = {k: torch.randint(0, 256, (TILES, r, r, 3), generator=g,
                             device=dev, dtype=torch.uint8)
            for k in ("HR", "SR")}
    return cfg, eng, state, data


def fill_cache(free_gib):
    """Allocate 1 GiB blocks until ``free_gib`` GiB of the card are free,
    then free them into the allocator's cache."""
    import torch
    blocks = []
    while torch.cuda.mem_get_info()[0] > (free_gib + 1) * 2 ** 30:
        blocks.append(torch.empty(2 ** 30, dtype=torch.uint8, device="cuda"))
    n = len(blocks)
    del blocks
    return n


def arm(name, cfg_name, free_gib):
    import torch

    from fastdiffsr_tpu_torch.train import make_cached_train_step
    order, timed, cache = ARMS[name]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = timed
    cfg, eng, _, data = setup(cfg_name, dev)
    bsz = int(cfg["datasets"]["train"]["batch_size"])
    out = {"arm": name}

    def eager_run():
        st = setup(cfg_name, dev)[2]
        step = make_cached_train_step(eng, bsz, ema_start=EMA_START)
        losses = [step(st, data, 0)[1]["l_pix"] for _ in range(N)]
        kinds = device_kernels(
            lambda: losses.extend(step(st, data, 0)[1]["l_pix"]
                                  for _ in range(N)))
        return st, torch.stack(losses[N:]), kinds

    def chained_run():
        st = setup(cfg_name, dev)[2]
        step = make_cached_train_step(eng, bsz, ema_start=EMA_START, n_sub=N)
        real = torch.cuda.empty_cache
        filled = []
        if cache is not None:
            def hook():
                filled.append(fill_cache(free_gib))
                if cache == "empty":
                    real()
            torch.cuda.empty_cache = hook
        ooms = torch.cuda.memory_stats().get("num_ooms", 0)
        try:
            step(st, data, 0)
        finally:
            torch.cuda.empty_cache = real
        out["ooms_first_call"] = (torch.cuda.memory_stats().get("num_ooms", 0)
                                  - ooms)
        out["filled_gib"] = filled[0] if filled else 0
        res = {}
        kinds = device_kernels(
            lambda: res.update(l=step(st, data, 0)[1]["l_pix"]))
        return st, res["l"], kinds

    try:
        if order == "capture":
            ch, lc, kc = chained_run()
            ea, le, ke = eager_run()
        else:
            ea, le, ke = eager_run()
            ch, lc, kc = chained_run()
    except Exception as e:       # an arm that fails is reported, not hidden
        out["error"] = f"{type(e).__name__}: {e}"[:400]
        return out
    pe = dict(ea.net.named_parameters())
    d_param = max((p - pe[k]).abs().max().item()
                  for k, p in ch.net.named_parameters())
    d_ema = max((v - ea.ema_params[k]).abs().max().item()
                for k, v in ch.ema_params.items())
    d_loss = (lc - le).abs().max().item()
    diff = {k: (kc.get(k, 0), ke.get(k, 0)) for k in set(kc) | set(ke)
            if kc.get(k, 0) != ke.get(k, 0)}
    top = sorted(diff.items(), key=lambda kv: -abs(kv[1][0] - kv[1][1]))[:8]
    out.update(
        max_abs_param=d_param, max_abs_ema=d_ema, max_abs_l_pix=d_loss,
        bit_equal=d_param == 0 and d_ema == 0 and d_loss == 0,
        kernels_replay=sum(kc.values()), kernels_eager=sum(ke.values()),
        fft_replay=sum(v for k, v in kc.items() if "fft" in k.lower()),
        fft_eager=sum(v for k, v in ke.items() if "fft" in k.lower()),
        names_differing=len(diff),
        top_differences=[[k[:160], a, b] for k, (a, b) in top],
        top_eager=[[k[:160], v] for k, v in ke.most_common(6)])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="sr_fastdiffsr_train_64_256")
    ap.add_argument("--free-gib", type=float, default=8.0,
                    help="what the full_cache arms leave free, GiB")
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--arm", help="run one arm in this process")
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    if args.arm:
        print("ARM " + json.dumps(arm(args.arm, args.config, args.free_gib)),
              flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    rows = []
    for name in args.arms.split(","):
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--arm", name,
             "--config", args.config, "--free-gib", str(args.free_gib)],
            capture_output=True, text=True, timeout=900)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("ARM ")]
        row = (json.loads(lines[-1][4:]) if lines else
               {"arm": name, "error": f"rc {p.returncode}: "
                + p.stderr[-600:]})
        rows.append(row)
        print(f"[{name}] {card} | " + json.dumps(row), flush=True)
    result = {"card": card, "config": args.config, "chain": N,
              "free_gib": args.free_gib, "arms": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
