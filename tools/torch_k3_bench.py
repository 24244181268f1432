#!/usr/bin/env python3
"""Time K3 alone on one NVIDIA GPU: the K3 phase of chip_smoke.py at the
shapes of one full-width UNet eval, without the rest of the smoke.

    python3 tools/torch_k3_bench.py [--shapes 3,16,18]

Builds the kernels, records the K3 call signatures of one fused forward
at batch 16 (49 calls in 23 shapes), holds each kernel against its plain
version at every shape (or at those of ``--shapes``, indices into the
sorted signatures) in bf16 and f32 at batch 16 and in f32 at batch 1 (the
validation batch), and prints chip_smoke's line per shape, type and
batch, then the per-eval totals. A failed comparison exits non-zero.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default=None,
                    help="comma list of indices into the sorted shapes")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr_fused import (
        prepare_fused_params)
    if not torch.cuda.is_available():
        print("torch_k3_bench: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    card, dev, B = cs.card_line(), torch.device("cuda"), cs.B_KERNEL
    cfg = load_json_config(os.path.join(
        cs.ROOT, "fastdiffsr_tpu_torch", "configs",
        "sr_fastdiffsr_test_64_256.json"))
    net = unet_from_config(cfg["model"]["unet"], device=dev, seed=0)
    gx = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, 256, 256, 6), generator=gx, device=dev)
    level = torch.rand((B,), generator=gx, device=dev)
    sigs, _ = cs.record_calls(prepare_fused_params(net, torch.bfloat16), x,
                              level)
    del net, x
    if args.shapes:
        keep = sorted(sigs)
        sigs = {keep[int(k)]: sigs[keep[int(k)]]
                for k in args.shapes.split(",")}
    rows, ok = cs.phase_k3(sigs, B, cs.REPS, card, 0)
    rows_b1, ok_b1 = cs.phase_k3(sigs, 1, cs.REPS, card, 0, dtypes=("f32",))
    cs.print_k3_totals(rows, card)
    cs.print_k3_totals(rows_b1, card)
    return 0 if ok and ok_b1 else 1


if __name__ == "__main__":
    sys.exit(main())
