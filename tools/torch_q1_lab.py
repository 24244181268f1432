#!/usr/bin/env python3
"""Where Q1's time goes: time knock-out variants of ``csrc/quant_conv.cu``
on one GPU.

    python3 tools/torch_q1_lab.py [--json OUT] [--sass OUT]

Each variant is the kernel's source with some of its phases cut out
(``no_quant``: the arithmetic that quantizes a staged chunk; ``no_mma``:
the wgmmas; ``no_epilogue``: the dequantize and the stores; ``no_load``:
the copies of the raw chunks, TMA or cp.async; ``no_stores``: the
epilogue computes y but stores nothing; ``*_only``: every phase but
one), built with the port's nvcc flags into a library of its own under
``build/q1_lab/`` and bound and called as the port calls Q1
(``kernels.bind_quant_conv3``, ``quant.launch_args``). The cuts are exact
lines of the kernel's source as it stands: an edit of those lines, even a
reformat, stops the lab with the name of the cut to update. A variant's outputs are wrong by construction but
``full``'s: only the times mean anything. Each is timed at the two
shapes that carry most of a 64->256 eval (batch 16: 256x256 64->64 and
128x128 128->128), bfloat16 in and out, on ``chip_smoke.py``'s operands
and in its timer (``q1_operands``, ``device_ms``: one replay of a CUDA
graph of 20 calls). ``--sass`` writes the full variant's
SASS (cuobjdump) there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = [(16, 256, 256, 64, 64), (16, 128, 128, 128, 128)]
# source text -> its replacement: each a verbatim piece of
# csrc/quant_conv.cu, so these follow the kernel's text
CUTS = {
    "quant": ("q[e] = quant1(f[e], s_a, rcp, lim);",
              "q[e] = __float_as_uint(f[e]);"),
    "mma": ("        multiply(i, c == 0);\n", ""),
    "epilogue": ("      epilogue(i - 1);\n", ""),
    "load": ("      if (it >= n_items) return;\n      int b, y0, x0;\n"
             "      origin(it, b, y0, x0);\n      const int c0",
             "      if (it >= 0) return;\n      int b, y0, x0;\n"
             "      origin(it, b, y0, x0);\n      const int c0"),
    "store": ("store2(yrow + 8 * j + 2 * t, y_at(j, 0), y_at(j, 1));",
              "if (left < -(1 << 30)) "
              "store2(yrow + 8 * j + 2 * t, y_at(j, 0), y_at(j, 1));"),
    "tma": ("      mbar_expect_tx(smem_u32(&raw_full[r]), G::VECS * G::VB);\n"
            "      tma_load4(",
            "      mbar_expect_tx(smem_u32(&raw_full[r]), 0u);\n"
            "      if (false) tma_load4("),
}
VARIANTS = {"full": (), "no_quant": ("quant",), "no_mma": ("mma",),
            "no_epilogue": ("epilogue",), "no_load": ("load", "tma"),
            "loads_only": ("quant", "mma", "epilogue"),
            "quant_only": ("load", "tma", "mma", "epilogue"),
            "mma_only": ("load", "tma", "quant", "epilogue"),
            "epilogue_only": ("load", "tma", "quant", "mma"),
            "no_stores": ("store",)}


def build_all(out_dir):
    from fastdiffsr_tpu_torch.ops import kernels
    nvcc = kernels._find_nvcc()
    src = open(os.path.join(kernels.CSRC, "quant_conv.cu")).read()
    procs = {}
    for name, cuts in VARIANTS.items():
        text = src
        for c in cuts:
            old, new = CUTS[c]
            if old not in text:
                sys.exit(f"torch_q1_lab: cut {c!r} (variant {name}) is not "
                         "in csrc/quant_conv.cu any more: update CUTS to "
                         "the kernel's text")
            text = text.replace(old, new)
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(kernels.CSRC, "common.cuh"), d)
        with open(os.path.join(d, "quant_conv.cu"), "w") as f:
            f.write(text)
        lib = os.path.join(d, "libq1.so")
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", lib,
               os.path.join(d, "quant_conv.cu")]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{out[-4000:]}")
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_q1_lab: no CUDA device")
    from chip_smoke import card_line, device_ms, q1_operands
    from fastdiffsr_tpu_torch.ops import kernels, quant
    card = card_line()
    libs = build_all(os.path.join(ROOT, "build", "q1_lab"))
    if args.sass:
        with open(args.sass, "w") as f:
            subprocess.run([os.path.join(os.path.dirname(
                kernels._find_nvcc()), "cuobjdump"), "-sass", libs["full"]],
                stdout=f, stderr=subprocess.STDOUT)
    rows = []
    for name, path in libs.items():
        lib = kernels.bind_quant_conv3(ctypes.CDLL(path))
        row = {"variant": name}
        for B, H, W, ci, co in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(0)
            _, b, _, s_w, packed, x = q1_operands(B, H, W, ci, co, g)
            h = x.to(torch.bfloat16)
            s_a = quant.activation_scale(h, False)
            y = torch.empty((B, H, W, co), dtype=torch.bfloat16,
                            device="cuda")

            def call():
                code = lib.fdsr_quant_conv3(*quant.launch_args(
                    h, packed, s_w, s_a, b, y, None))
                assert code == 0, code

            row[f"{H}x{W} {ci}->{co}"] = device_ms(call, 20)
            del packed, x, h, y
        rows.append(row)
        print(f"[q1 lab] {card} | {name}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in row.items() if k != "variant"),
            flush=True)
    out = {"card": card, "rows": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
