#!/usr/bin/env python3
"""Readings that the limits of the output check are set from, for one
cell, in one process on the card:

    python3 perfbench/tools/controls.py --workload <cell> \\
        --seeds 1,2,... --control-seeds 1,2,3 [--w8a8] [--out FILE]

- ``program``: the cell's run with a short window (``--seconds``) on each
  of ``--seeds``: the compared numbers of sound runs (the lower reading);
- ``control``: the reference in the precision below the cell's (fp8 for
  bf16, TF32 for float32) put in the program's place, held to the
  float32 reference by the same comparison (the upper reading);
- ``w8a8`` (sampling, with ``--w8a8``): the program with its own int8
  path on (``FASTDIFFSR_TPU_QUANT=w8a8``, the plain forward);
- ``half_batch`` (training): the reference on half of each batch, the
  mean over that half, against the whole batch;
- ``ema_decay`` (training): the reference with the EMA's decay 0.999 in
  place of the configuration's 0.9999.

One JSON line per reading, to standard output and to ``--out``.
"""

import argparse
import dataclasses
import json
import math
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONTROL = {"bf16": "fp8", "f32": "tf32"}


def sample_control(cell, seed, device, precision):
    """sr_gap of the reference in ``precision`` against the float32 one on
    the images a run would check."""
    import torch

    from perfbench.harness import cells, inputs
    from perfbench.reference import diffusion as rd
    from perfbench.reference import unets
    tr, model = cell.traffic, cell.config["model"]
    bsz = int(tr["batch"])
    size = int(model["diffusion"]["image_size"])
    _, sr_pool = inputs.make_tiles(seed, int(tr["pool_tiles"]), size,
                                   int(cell.config["scale"]), device)
    pool = sr_pool.cpu().numpy()
    order = inputs.order(seed, int(tr["max_batches"]), bsz, len(pool))
    net = unets.build_unet(model, precision, device)
    net.load_state_dict(inputs.make_weights(model, seed, device))
    tab = rd.tables(model["beta_schedule"]["val"], device)
    conditioning, residual = rd.VARIANTS[model["which_model_G"]]
    done = []
    for k in range(max(1, math.ceil(int(tr["check_images"]) / bsz))):
        cond = torch.from_numpy(pool[order[k]]).to(device)
        gens = [torch.Generator(device=device).manual_seed(
            rd.image_seed(seed, k * bsz + j)) for j in range(bsz)]
        done.append((k * bsz, rd.sample_ancestral(
            net, tab, cond, gens, conditioning, residual).cpu()))
    del net
    return cells.load_runner("sample_closed_loop").check(
        cell, seed, device, pool, order, done, bsz)


def train_control(cell, seed, device, precision, rows=None, ema_decay=None):
    import torch

    from perfbench.harness import cells, inputs
    from perfbench.harness.check import train_gaps
    train = cells.load_runner("train_steps")
    tr, opt = cell.traffic, cell.config
    model = opt["model"]
    size = int(model["diffusion"]["image_size"])
    bsz = int(tr["batch"])
    hr, sr = inputs.make_tiles(seed, int(tr["pool_tiles"]), size,
                               int(opt["scale"]), device)
    order = torch.from_numpy(inputs.order(seed, int(tr["max_steps"]), bsz,
                                          hr.shape[0])).to(device)
    ref = train.reference_readings(model, opt["train"], seed, device, hr, sr,
                                   order, bsz)
    low = train.reference_readings(model, opt["train"], seed, device, hr, sr,
                                   order, bsz, precision, rows=rows,
                                   ema_decay=ema_decay)
    return train_gaps(low, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--w8a8", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import cells
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cells.load_cell(args.workload)
    drive = cells.load_runner(cell.runner).run
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None

    def emit(**row):
        row = {"cell": cell.name, "card": torch.cuda.get_device_name(0),
               **row}
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in seeds:
        t = time.perf_counter()
        o = drive(cell, seed, args.seconds, False, device, t)
        emit(kind="program", seed=seed, **o.checks, failed=o.failed,
             attempted=o.attempted, **o.e2e)
    for seed in cseeds:
        if cell.runner == "sample_closed_loop":
            emit(kind="control", seed=seed, sr_gap=sample_control(
                cell, seed, device, CONTROL[cell.traffic["dtype"]]))
            if args.w8a8:
                os.environ["FASTDIFFSR_TPU_QUANT"] = "w8a8"
                plain = dataclasses.replace(
                    cell, traffic=dict(cell.traffic, fused=False))
                o = drive(plain, seed, args.seconds, False, device,
                          time.perf_counter())
                del os.environ["FASTDIFFSR_TPU_QUANT"]
                emit(kind="w8a8", seed=seed, **o.checks)
        else:
            emit(kind="control", seed=seed,
                 **train_control(cell, seed, device, "tf32"))
            half = slice(0, int(cell.traffic["batch"]) // 2)
            emit(kind="half_batch", seed=seed,
                 **train_control(cell, seed, device, "f32", rows=half))
            emit(kind="ema_decay", seed=seed,
                 **train_control(cell, seed, device, "f32", ema_decay=0.999))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
