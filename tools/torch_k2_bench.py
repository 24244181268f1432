#!/usr/bin/env python3
"""Time K2 (channel statistics) and K1 (GroupNorm -> Swish, whose pass 1 is
K2's kernel) alone on one NVIDIA GPU, at the main path's shapes, without
the rest of chip_smoke.py.

    python3 tools/torch_k2_bench.py [--blocks-per-sm 1,2,4] [--max-blocks 64,128]

Builds the kernels, times the launch floor (a one-element in-place add
in chip_smoke's CUDA-graph harness), then runs chip_smoke's K2 phase at the 4 K2 calls of one UNet eval at
256^2 (batch 16 in bf16 and f32, batch 1 in f32, the ``-p val`` shape)
and at 512^2 (batch 1, the 128->512 eval), once per pair of values of
``--blocks-per-sm`` and ``--max-blocks`` (the grid K2's launch plan aims
at and its cap per image and slab, ``ops/groupnorm.py::K2_BLOCKS_PER_SM``
and ``K2_MAX_BLOCKS``; without the options, the shipped values), and
chip_smoke's K1 phase at the 14 K1 shapes of one training
forward (batch 4 in f32 and bf16, batch 1 in f32). It prints chip_smoke's
line per shape, then ``[K2 total ...]`` and ``[K1 total ...]`` lines per
eval and per forward beside the bound and the floor. A failed comparison
exits non-zero.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

# (H, W, C) -> calls of the K2 calls of one UNet eval (chip_smoke records
# the same from a fused forward)
K2_SIGS = {256: {(128, 128, 64): 1, (64, 64, 128): 1, (32, 32, 256): 2},
           512: {(256, 256, 64): 1, (128, 128, 128): 1, (64, 64, 256): 2}}


def totals(rows, key_calls, label, card, floor):
    """Per eval (or forward) totals of each type of ``rows``."""
    for dt in sorted({r["dtype"] for r in rows}):
        sel = [r for r in rows if r["dtype"] == dt]
        ms = sum(r["ms"] * r[key_calls] for r in sel)
        wall = sum(r["wall_ms"] * r[key_calls] for r in sel)
        bnd = sum(r["bound_ms"] * r[key_calls] for r in sel)
        calls = sum(r[key_calls] for r in sel)
        if all("launches_per_call" in r for r in sel):
            n = sum(r["launches_per_call"] * r[key_calls] for r in sel)
            launches = (f"{n} launches, at the floor {floor:.4f} ms: "
                        f"{n * floor:.4f} ms")
        else:      # a tree whose smoke does not count them
            launches = f"launches not counted, floor {floor:.4f} ms"
        print(f"[{label} {dt} B={sel[0]['B']}] {card} | {calls} calls | "
              f"device: kernel {ms:.4f} ms ({bnd / ms:.2f} of bound) | wall "
              f"{wall:.4f} ms | bound {bnd:.4f} ms | {launches}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks-per-sm", default=None,
                    help="comma list of K2_BLOCKS_PER_SM values to time")
    ap.add_argument("--max-blocks", default=None,
                    help="comma list of K2_MAX_BLOCKS values to time")
    ap.add_argument("--reps", type=int, default=None,
                    help="calls per timed CUDA-graph replay (default: "
                         "chip_smoke.REPS)")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.device import use_ieee_float32
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.ops import groupnorm, kernels
    if not torch.cuda.is_available():
        print("torch_k2_bench: no CUDA device visible", file=sys.stderr)
        return 2
    use_ieee_float32()
    cs.own_phases_regime()
    card, dev = cs.card_line(), torch.device("cuda")
    reps = args.reps or cs.REPS
    lib_path = kernels.build()
    kernels.load()
    log = (lib_path.parent / "build.log").read_text().splitlines()
    print(f"[build] {card} | {log[0]} | " + " ; ".join(
        r for r in cs.ptxas_report(log) if "channel_stats" in r), flush=True)
    one = torch.zeros(1, device=dev)
    floor = cs.device_ms(lambda: one.add_(1.0), reps)
    print(f"[floor] {card} | one-element in-place add, device {floor:.4f} "
          f"ms per call", flush=True)

    ok = True

    def values(opt, name):
        shipped = getattr(groupnorm, name, None)
        return ([int(v) for v in opt.split(",")]
                if opt and shipped is not None else [shipped])

    shipped = (getattr(groupnorm, "K2_BLOCKS_PER_SM", None),
               getattr(groupnorm, "K2_MAX_BLOCKS", None))
    for bps in values(args.blocks_per_sm, "K2_BLOCKS_PER_SM"):
        for cap in values(args.max_blocks, "K2_MAX_BLOCKS"):
            if bps is not None:
                groupnorm.K2_BLOCKS_PER_SM, groupnorm.K2_MAX_BLOCKS = bps, cap
            tag = f"K2 total bps={bps} max={cap}"
            for res, B, dtypes in ((256, cs.B_KERNEL, ("bf16", "f32")),
                                   (256, 1, ("f32",)),
                                   (512, 1, ("f32", "bf16"))):
                kw = {"dtypes": dtypes} if bps is not None else {}
                rows, r_ok = cs.phase_k2(K2_SIGS[res], B, reps, card, 0,
                                         **kw)
                ok &= r_ok
                totals(rows, "calls_per_eval", f"{tag} {res}x{res}", card,
                       floor)
    if shipped[0] is not None:
        groupnorm.K2_BLOCKS_PER_SM, groupnorm.K2_MAX_BLOCKS = shipped

    cfg = load_json_config(os.path.join(
        cs.ROOT, "fastdiffsr_tpu_torch", "configs",
        "sr_fastdiffsr_train_64_256.json"))
    net = unet_from_config(cfg["model"]["unet"], device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((cs.B_TRAIN, 256, 256, 6), generator=g, device=dev)
    level = torch.rand((cs.B_TRAIN,), generator=g, device=dev)
    sigs, _ = cs.record_k1(net, x, level)
    del net, x
    torch.cuda.empty_cache()
    for B, dtypes in ((cs.B_TRAIN, ("f32", "bf16")), (1, ("f32",))):
        rows, r_ok = cs.phase_k1(sigs, B, reps, card, 0, dtypes=dtypes)
        ok &= r_ok
        totals(rows, "calls_per_forward", "K1 total", card, floor)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
