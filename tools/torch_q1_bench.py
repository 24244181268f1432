#!/usr/bin/env python3
"""Time Q1 (the W8A8 3x3 conv, ``csrc/quant_conv.cu``) on one GPU at the
quantized shapes of the FastDiffSR UNet, alone: ``chip_smoke.py``'s phase
22 without its serving, inference, training and export runs.

    python3 tools/torch_q1_bench.py [--root DIR] [--reps 10] [--json OUT]

The shapes come from hooks on a full-width w8a8 forward (``q1_shapes``),
and each is checked and timed by ``chip_smoke.phase_q1``: bit-equal to
the plain version in f32/bf16 x w8a8/w8a8s, one launch per call, then the
CUDA-graph device time of Q1, its abs-max scale, its plain version and
the ``_int_mm`` and cuDNN yardsticks. ``--root`` imports
``fastdiffsr_tpu_torch`` from another checkout (its kernels are built
there), so two trees are timed by the same harness, one process each, in
turns on one card. Ends with one JSON line of the rows and the per-eval
sums; exits non-zero if a check failed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose fastdiffsr_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=None,
                    help="calls per timed CUDA graph (chip_smoke's REPS)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_q1_bench: no CUDA device")
    # this tree's harness, whatever chip_smoke.py the other root holds
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if args.reps:
        cs.REPS = args.reps
    card = cs.card_line()
    sigs, extra, _, ok = cs.q1_shapes(card, args.seed)
    rows, q_ok = cs.phase_q1(sigs, cs.B_KERNEL, card, args.seed)
    rows_512, q512_ok = cs.phase_q1(extra, 1, card, args.seed)
    tot = cs.q1_per_eval(rows, card)
    ok &= q_ok and q512_ok
    out = {"card": card, "root": root, "per_eval": tot, "rows": rows,
           "rows_512": rows_512, "ok": ok}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
