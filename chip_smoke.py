#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fastdiffsr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the repository root. It needs one CUDA device and the CUDA
toolkit (nvcc); without a device it exits non-zero and prints no result.
Phases, one line each, every number beside the card's name and power
limit:

1. build the kernels from fastdiffsr_tpu_torch/csrc with nvcc (sm_90a)
   and print each kernel's registers and spill bytes;
2. K3 (fused GroupNorm->Swish->conv3x3) against its plain PyTorch version
   at every distinct K3 shape of one full-width UNet eval at batch 16
   (recorded from a fused forward), in bf16 (the wgmma kernel) and f32
   (the CUDA-core kernel; each row names the kernel that ran), with the
   kernel's, the plain version's and one F.conv2d's times and the least
   time the card could take; then f32 again at batch 1, the validation
   batch, where the f32 kernel takes smaller tiles;
3. the same for K2 (channel statistics) at its shapes;
4. one full-width UNet eval at 256x256, fused forward against the plain
   UNet (its Blocks on gn_swish_reference), f32 (and bf16 fused against
   f32 plain);
5. the serving path end to end: a synthetic 64->256 npy pack from
   --seed, then ``fastdiffsr_tpu_torch.cli.infer`` on CUDA at full width,
   T=20, with launch counters that must show 49 K3 launches, all on the
   wgmma kernel, and 4 K2 launches per UNet eval;
6. K1 (GroupNorm -> Swish) against its plain version at every distinct
   K1 shape of one full-width training forward at batch 4, in f32 and
   bf16, with the kernel's, the plain version's and the two library calls'
   (F.group_norm then F.silu) times and the least time the card could take;
7. a wiring check of gn_swish_custom at the largest K1 shape: K1 has no
   backward kernel, and its gradients (the VJP of gn_swish_reference)
   must match autograd of gn_swish_plain, K1's own formulation;
8. one full-width train step from the same weights, batch, noise level
   and noise, dropout off, with the Blocks on K1 and on gn_swish_reference:
   loss, gradient norm, gradients and the parameters after one Adam step
   (eps raised to STEP_ADAM_EPS) must agree, and the K1 step must launch
   K1 45 times;
9. training end to end: ``fastdiffsr_tpu_torch.cli.sr_mfe -p train`` on
   CUDA with the train config at full width, batch 4, T=20, on a
   synthetic pack from --seed (45 K1 launches per step, steady steps/s
   and peak memory), a checkpoint that reloads bit-equal, then ``-p val``
   from it on a few images (PSNR/SSIM, 49 K3 and 4 K2 launches per UNet
   eval, seconds per image).

Kernel times: ``ms`` is device time per call, the CUDA-event time of one
replay of a CUDA graph that holds REPS calls (no host time between the
launches); ``wall_ms`` is the CUDA-event time of REPS calls made from
Python, host gaps included. The plain versions and library calls are
timed the same two ways. (torch.profiler is not used here: after it has
run, kernel launches in the same process cost more host time.)

The line before the last is one JSON object of per-kernel numbers (K3
has two entries, one per hand-written kernel; ``kernel_route`` names the
kernel), every number of it measured in this run or, for ``bound_ms``,
computed from this run's shapes; the last line is {"ok": true, "device":
{...}}. Per-shape details go to build/chip_smoke.json. Any failed check
exits non-zero. The ``[time]`` line says how long the run took, the
kernel build included: about two minutes on an H100.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
# K3 |dy|: f32 atol (summation order); bf16 two bf16 steps of |y| + 2e-3
# (a sum that differs in its last float32 bits rounds to the neighbouring
# bf16 value; a normalised input that rounds the other way shifts the sum)
K3_TOL = {"f32": 2e-3, "bf16": (2 ** -6, 2e-3)}
STATS_RTOL = 2e-5          # |dstats| <= rtol * max(sum y^2) + 1e-3
# fused vs plain UNet eval: f32 atol; bf16 relative to max|y| (every block
# rounds its input to bf16, 2^-8 relative, through ~25 blocks)
UNET_TOL = {"f32": 2e-3, "bf16": 0.05}
# K1 |dy|: f32 atol (statistics summed in another order move mean and
# 1/std by a few float32 steps); bf16 one bf16 step of |y| + 1e-5
K1_TOL = {"f32": 1e-4, "bf16": (2 ** -7, 1e-5)}
K1_GRAD_RTOL = 1e-4        # |dgrad| <= rtol * max|grad|
# one train step, K1 vs gn_swish_reference: relative loss / gradient-norm
# / per-tensor gradient gaps, and updated parameters in units of lr.
# Adam's first step moves an element by lr * g / (|g| + eps): with the
# config's eps 1e-8 that is lr * sign(g), which a float32-rounding gap
# flips wherever g is ~0. With eps raised to STEP_ADAM_EPS the step is
# smooth in g (slope <= lr / eps), so every element must move the same
# within 1e-2 lr.
STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "grad": 1e-3, "param": 1e-2}
STEP_ADAM_EPS = 1e-2
B_KERNEL = 16       # batch of the kernel checks (phases 2-3)
B_UNET = 4          # batch of the UNet check (phase 4)
SERVE_BATCH = 16    # phase 5: batches of 16, the first one is set-up
SERVE_BATCHES = 2
REPS = 10           # timed launches per kernel shape
B_TRAIN = 4         # phases 6-9: the train config's batch
TRAIN_STEPS = 24    # phase 9
TRAIN_IMAGES = 16
VAL_IMAGES = 2
K1_PER_FORWARD = 45  # 44 ResnetBlock Blocks + the final Block


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_of(mangled):
    """'name<template args>' of a kernel from its mangled name. The name
    is the one whose length prefix says it ends in '_kernel' (the prefix
    may follow the digits of a namespace hash directly)."""
    import re
    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):
            n = int(mangled[i:m.end()])
            name = mangled[m.end():m.end() + n]
            if re.fullmatch(r"[a-z][a-z0-9_]*_kernel", name):
                rest = mangled[m.end() + n:]      # template args, params
                ends = [k for k in (rest.find("Ev"), rest.find("EP")) if k >= 0]
                rest = rest[:min(ends)] if ends else rest
                args = re.findall(r"Li(\d+)E|I(f|13__nv_bfloat16)", rest)
                return name + "<" + ",".join(
                    a or ("f32" if t == "f" else "bf16") for a, t in args) + ">"
    return "?"


def ptxas_report(log):
    """One string per kernel from nvcc's ``-Xptxas -v`` lines: its name,
    registers, and the bytes it spills."""
    import re
    out, name, spill = [], "?", ""
    for ln in log:
        m = re.search(r"Compiling entry function '(_ZN4fdsr\S*)'", ln)
        if m:
            name = kernel_of(m.group(1))
        elif "spill stores" in ln:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", ln).groups()
            spill = f"spill {st}/{ld} B"
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} regs, {spill}")
    return out


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: CUDA-event time of one replay of a
    CUDA graph that holds ``reps`` calls, so no host time falls between
    the launches. ``fn`` is warmed up first (kernel build, cuDNN plans)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn, reps: int):
    """(device ms, CUDA-event wall ms) per call of ``fn``."""
    return device_ms(fn, reps), time_ms(fn, reps)


@contextlib.contextmanager
def reference_norm():
    """Within the block, every UNet Block runs gn_swish_reference (plain
    PyTorch, autograd) in place of K1's gn_swish_custom."""
    from fastdiffsr_tpu_torch.models import unet_fastdiffsr as un
    from fastdiffsr_tpu_torch.ops.groupnorm import gn_swish_reference
    orig = un.gn_swish_custom
    un.gn_swish_custom = gn_swish_reference
    try:
        yield
    finally:
        un.gn_swish_custom = orig


def bound(flops: float, nbytes: float, dt: str):
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def record_calls(fp, x, level):
    """Run one fused forward and return the distinct K3 and K2 call
    signatures with their call counts."""
    from fastdiffsr_tpu_torch.models import unet_fastdiffsr_fused as uf
    k3, k2 = {}, {}
    orig_k3, orig_k2 = uf.fused_gn_swish_conv3x3, uf.channel_stats

    def rec_k3(x, gs, gb, st, w, b, shift=None, res=None, groups=32,
               eps=1e-5, apply_norm=True, want_stats=True):
        xs = x if isinstance(x, tuple) else (x,)
        sig = (tuple(t.shape[-1] for t in xs), *xs[0].shape[1:3],
               w.shape[-1], apply_norm, want_stats, shift is not None,
               res is not None, groups)
        k3[sig] = k3.get(sig, 0) + 1
        return orig_k3(x, gs, gb, st, w, b, shift=shift, res=res,
                       groups=groups, eps=eps, apply_norm=apply_norm,
                       want_stats=want_stats)

    def rec_k2(x):
        sig = tuple(x.shape[1:])
        k2[sig] = k2.get(sig, 0) + 1
        return orig_k2(x)

    uf.fused_gn_swish_conv3x3, uf.channel_stats = rec_k3, rec_k2
    try:
        uf.fused_apply(fp, x, level)
    finally:
        uf.fused_gn_swish_conv3x3, uf.channel_stats = orig_k3, orig_k2
    return k3, k2


def phase_k3(sigs, B, reps, card, seed, dtypes=("bf16", "f32")):
    """K3 against its plain version at every signature of ``sigs`` at batch
    ``B`` in each of ``dtypes``, then the device and wall times of the
    kernel, the plain version and F.conv2d."""
    import torch
    import torch.nn.functional as F

    from fastdiffsr_tpu_torch.ops import fused_conv
    from fastdiffsr_tpu_torch.ops.fused_conv import (
        fused_gn_swish_conv3x3, fused_gn_swish_conv3x3_plain)
    from fastdiffsr_tpu_torch.ops.groupnorm import channel_stats_plain
    dev = torch.device("cuda")
    rows, ok = [], True
    g = torch.Generator(device=dev).manual_seed(seed)
    for sig, count in sorted(sigs.items()):
        Cs, H, W, Co, norm, want_stats, has_shift, has_res, groups = sig
        C = sum(Cs)
        for dt_name in dtypes:
            dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dt_name]

            def rnd(*shape, s=1.0):
                return torch.randn(shape, generator=g, device=dev) * s
            xs = tuple(rnd(B, H, W, c).to(dt) for c in Cs)
            stats = tuple(channel_stats_plain(x) for x in xs)
            w = rnd(3, 3, C, Co, s=(9 * C) ** -0.5)
            args = (xs if len(xs) > 1 else xs[0],
                    rnd(C, s=0.1) + 1 if norm else None,
                    rnd(C, s=0.1) if norm else None,
                    (stats if len(xs) > 1 else stats[0]) if norm else None,
                    w, rnd(Co, s=0.1))
            kw = dict(groups=groups, apply_norm=norm, want_stats=want_stats,
                      shift=rnd(B, Co, s=0.1) if has_shift else None,
                      res=rnd(B, H, W, Co).to(dt) if has_res else None)
            taken = dict(fused_conv.ROUTE_TAKEN)
            got = fused_gn_swish_conv3x3(*args, **kw)
            torch.cuda.synchronize()
            route = [r for r, n in fused_conv.ROUTE_TAKEN.items()
                     if n == taken[r] + 1][0]
            want = fused_gn_swish_conv3x3_plain(*args, **kw)
            if not want_stats:
                got, want = (got,), (want,)
            y, yw = got[0].float(), want[0].float()
            dy = (y - yw).abs()
            err = dy.max().item()
            if dt_name == "f32":
                y_ok = err <= K3_TOL["f32"]
            else:
                rel, atol = K3_TOL["bf16"]
                y_ok = bool((dy <= yw.abs() * rel + atol).all())
            st_err = st_tol = 0.0
            if want_stats:
                st_err = (got[1] - want[1]).abs().max().item()
                st_tol = (STATS_RTOL * want[1][:, 1].abs().max().item()
                          + 1e-3)
            row_ok = bool(y_ok and st_err <= st_tol
                          and torch.isfinite(y).all())
            ok &= row_ok
            del got, want, y, yw, dy

            ms, wall_ms = timed(
                lambda: fused_gn_swish_conv3x3(*args, **kw), reps)
            plain_ms, plain_wall_ms = timed(
                lambda: fused_gn_swish_conv3x3_plain(*args, **kw),
                max(1, reps // 2))
            xcat = (torch.cat(xs, dim=-1) if len(xs) > 1 else xs[0])
            x_nchw = xcat.permute(0, 3, 1, 2)     # channels-last view
            w_oihw = w.permute(3, 2, 0, 1).to(dt).contiguous()
            b_lib = args[5].to(dt)
            lib_ms, lib_wall_ms = timed(
                lambda: F.conv2d(x_nchw, w_oihw, b_lib, padding=1), reps)
            del xcat, x_nchw
            es = 2 if dt_name == "bf16" else 4
            flops = 2.0 * 9 * C * Co * B * H * W
            nbytes = (B * H * W * (C + Co * (2 if has_res else 1)) * es
                      + 9 * C * Co * es + (8 * B * Co if want_stats else 0))
            b_ms, b_by = bound(flops, nbytes, dt_name)
            row = {"Cs": list(Cs), "H": H, "W": W, "Co": Co, "norm": norm,
                   "stats": want_stats, "shift": has_shift, "res": has_res,
                   "calls_per_eval": count, "dtype": dt_name, "B": B,
                   "kernel_route": route, "max_abs_err_y": err,
                   "max_abs_err_stats": st_err,
                   "stats_tol": st_tol, "ok": row_ok, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "wall_ms": wall_ms, "plain_wall_ms": plain_wall_ms,
                   "library_wall_ms": lib_wall_ms,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "tflops": flops / ms / 1e9}
            rows.append(row)
            shape = (f"{dt_name} B={B} {H}x{W} C={'+'.join(map(str, Cs))} "
                     f"Co={Co} norm={int(norm)} x{count}/eval")
            print(f"[K3] {card} | {shape} {route} | max|dy|={err:.3g} "
                  f"max|dstats|={st_err:.3g} (tol {st_tol:.3g}) "
                  f"{'ok' if row_ok else 'FAIL'} | device: kernel {ms:.3f} "
                  f"ms ({row['tflops']:.1f} TFLOP/s, {b_ms / ms:.2f} of bound)"
                  f" plain {plain_ms:.3f} ms F.conv2d {lib_ms:.3f} ms | "
                  f"wall: kernel {wall_ms:.3f} ms plain "
                  f"{plain_wall_ms:.3f} ms F.conv2d {lib_wall_ms:.3f} ms"
                  f" | bound {b_ms:.3f} ms ({b_by})", flush=True)
            del xs, stats, args, kw
    return rows, ok


def total(rows, key, dt="bf16", per="calls_per_eval"):
    """Sum of ``key`` over the rows of type ``dt``, weighted by calls."""
    return sum(r[key] * r[per] for r in rows if r["dtype"] == dt)


def print_k3_totals(rows, card):
    """One ``[K3 total ...]`` line per type of ``rows`` (one batch)."""
    for dt in sorted({r["dtype"] for r in rows}):
        B = rows[0]["B"]
        routes = {r["kernel_route"] for r in rows if r["dtype"] == dt}
        calls = sum(r["calls_per_eval"] for r in rows if r["dtype"] == dt)
        print(f"[K3 total {dt} B={B}] {card} | per UNet eval ({calls} calls) on "
              f"{'/'.join(sorted(routes))}, device: kernel "
              f"{total(rows, 'ms', dt):.3f} ms, plain "
              f"{total(rows, 'plain_ms', dt):.3f} ms, F.conv2d "
              f"{total(rows, 'library_ms', dt):.3f} ms | wall: kernel "
              f"{total(rows, 'wall_ms', dt):.3f} ms | bound "
              f"{total(rows, 'bound_ms', dt):.3f} ms", flush=True)


def phase_k2(sigs, B, reps, card, seed):
    import torch

    from fastdiffsr_tpu_torch.ops.groupnorm import (channel_stats,
                                                    channel_stats_plain)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    rows, ok = [], True
    for (H, W, C), count in sorted(sigs.items()):
        for dt_name, dt in (("bf16", torch.bfloat16),
                            ("f32", torch.float32)):
            x = torch.randn((B, H, W, C), generator=g, device=dev).to(dt)
            got = channel_stats(x)
            torch.cuda.synchronize()
            want = channel_stats_plain(x)
            err = (got - want).abs().max().item()
            tol = STATS_RTOL * want[:, 1].abs().max().item() + 1e-3
            row_ok = err <= tol
            ok &= row_ok
            ms, wall_ms = timed(lambda: channel_stats(x), reps)
            plain_ms, plain_wall_ms = timed(lambda: channel_stats_plain(x),
                                            reps)
            es = 2 if dt_name == "bf16" else 4
            b_ms, b_by = bound(3.0 * B * H * W * C,
                               B * H * W * C * es + 8 * B * C, dt_name)
            rows.append({"H": H, "W": W, "C": C, "calls_per_eval": count,
                         "dtype": dt_name, "B": B, "max_abs_err": err,
                         "tol": tol, "ok": row_ok, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": None,
                         "wall_ms": wall_ms, "plain_wall_ms": plain_wall_ms,
                         "bound_ms": b_ms, "bound_by": b_by})
            print(f"[K2] {card} | {dt_name} B={B} {H}x{W} C={C} x{count}/eval"
                  f" | max|d|={err:.3g} (tol {tol:.3g})"
                  f" {'ok' if row_ok else 'FAIL'} | device: kernel {ms:.4f} "
                  f"ms plain {plain_ms:.4f} ms | wall: kernel {wall_ms:.4f} "
                  f"ms plain {plain_wall_ms:.4f} ms | bound {b_ms:.4f} ms "
                  f"({b_by})",
                  flush=True)
    return rows, ok


def record_k1(net, x, level):
    """Run one forward of ``net`` and return the distinct K1 call
    signatures (H, W, C, groups) of its Blocks with their call counts,
    and how many Blocks saw a non-contiguous NHWC view."""
    import torch

    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import Block
    sigs, strided = {}, [0]

    def hook(mod, args):
        h = args[0]
        sig = (h.shape[2], h.shape[3], h.shape[1], mod.block[0].num_groups)
        sigs[sig] = sigs.get(sig, 0) + 1
        strided[0] += not h.permute(0, 2, 3, 1).is_contiguous()

    hooks = [m.register_forward_pre_hook(hook) for m in net.modules()
             if isinstance(m, Block)]
    try:
        with torch.no_grad():
            net(x, level)
    finally:
        for h in hooks:
            h.remove()
    return sigs, strided[0]


def phase_k1(sigs, B, reps, card, seed):
    import torch
    import torch.nn.functional as F

    from fastdiffsr_tpu_torch.ops.groupnorm import (gn_swish, gn_swish_plain,
                                                    gn_swish_reference)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    rows, ok = [], True
    for (H, W, C, G), count in sorted(sigs.items()):
        for dt_name, dt in (("f32", torch.float32),
                            ("bf16", torch.bfloat16)):
            x = (torch.randn((B, H, W, C), generator=g, device=dev) * 2
                 + 0.5).to(dt)
            scale = torch.randn(C, generator=g, device=dev) * 0.1 + 1
            bias = torch.randn(C, generator=g, device=dev) * 0.1
            got = gn_swish(x, scale, bias, G)
            torch.cuda.synchronize()
            want = gn_swish_plain(x, scale, bias, G)
            dy = (got.float() - want.float()).abs()
            err = dy.max().item()
            if dt_name == "f32":
                row_ok = err <= K1_TOL["f32"]
            else:
                rel, atol = K1_TOL["bf16"]
                row_ok = bool((dy <= want.float().abs() * rel + atol).all())
            row_ok &= bool(torch.isfinite(got).all())
            ok &= row_ok
            del got, want, dy
            ms, wall_ms = timed(lambda: gn_swish(x, scale, bias, G), reps)
            plain_ms, plain_wall_ms = timed(
                lambda: gn_swish_plain(x, scale, bias, G), reps)
            # the backward of gn_swish_custom recomputes this forward
            ref_ms, ref_wall_ms = timed(
                lambda: gn_swish_reference(x, scale, bias, G), reps)
            x_nchw = x.permute(0, 3, 1, 2)           # channels-last view
            s_lib, b_lib = scale.to(dt), bias.to(dt)
            lib_ms, lib_wall_ms = timed(
                lambda: F.silu(F.group_norm(x_nchw, G, s_lib, b_lib, 1e-5)),
                reps)
            es = 2 if dt_name == "bf16" else 4
            n = B * H * W * C
            # x read once, y written once; ~11 float32 operations per
            # element on the CUDA cores (statistics, normalise, affine,
            # swish), whatever the storage type
            b_ms, b_by = bound(11.0 * n, 2.0 * n * es + 8 * C, "f32")
            rows.append({"H": H, "W": W, "C": C, "groups": G,
                         "calls_per_forward": count, "dtype": dt_name,
                         "B": B, "max_abs_err": err, "ok": row_ok, "ms": ms,
                         "plain_ms": plain_ms, "two_call_library_ms": lib_ms,
                         "reference_ms": ref_ms, "wall_ms": wall_ms,
                         "plain_wall_ms": plain_wall_ms,
                         "two_call_library_wall_ms": lib_wall_ms,
                         "reference_wall_ms": ref_wall_ms,
                         "bound_ms": b_ms, "bound_by": b_by})
            print(f"[K1] {card} | {dt_name} B={B} {H}x{W} C={C} G={G} "
                  f"x{count}/forward | max|dy|={err:.3g} "
                  f"{'ok' if row_ok else 'FAIL'} | device: kernel {ms:.4f} "
                  f"ms plain {plain_ms:.4f} ms F.group_norm+F.silu (two "
                  f"library calls) {lib_ms:.4f} ms gn_swish_reference "
                  f"{ref_ms:.4f} ms | wall: kernel {wall_ms:.4f} ms plain "
                  f"{plain_wall_ms:.4f} ms two calls {lib_wall_ms:.4f} ms "
                  f"reference {ref_wall_ms:.4f} ms | bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
            del x, x_nchw
    return rows, ok


def phase_k1_grad(sig, B, card, seed):
    """Wiring check of the autograd Function around K1 (there is no
    backward kernel; the CPU tests hold the gradient against JAX)."""
    import torch

    from fastdiffsr_tpu_torch.ops.groupnorm import (gn_swish_custom,
                                                    gn_swish_plain)
    H, W, C, G = sig
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    x = torch.randn((B, H, W, C), generator=g, device=dev)
    s = torch.randn(C, generator=g, device=dev) * 0.1 + 1
    b = torch.randn(C, generator=g, device=dev) * 0.1
    cot = torch.randn(x.shape, generator=g, device=dev)
    grads = []
    for fn in (gn_swish_custom, gn_swish_plain):
        leaves = [t.clone().requires_grad_() for t in (x, s, b)]
        (fn(*leaves, G) * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    errs = [((a - r).abs().max() / r.abs().max()).item()
            for a, r in zip(*grads)]
    ok = max(errs) <= K1_GRAD_RTOL
    print(f"[K1 grad wiring] {card} | f32 B={B} {H}x{W} C={C} G={G} | "
          f"gn_swish_custom (K1 forward, VJP of gn_swish_reference) vs "
          f"autograd of gn_swish_plain: max|d|/max|g|"
          f" x {errs[0]:.3g} scale {errs[1]:.3g} bias {errs[2]:.3g} "
          f"(tol {K1_GRAD_RTOL}) {'ok' if ok else 'FAIL'}", flush=True)
    return {"shape": [B, H, W, C], "groups": G, "rel_err": errs,
            "ok": ok}, ok


def phase_train_parity(cfg, B, card, seed):
    """One full-width train step with the Blocks on K1 and on
    gn_swish_reference, from the same weights, batch and injected draws,
    dropout off, Adam with eps STEP_ADAM_EPS."""
    import torch

    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.ops import kernels
    from fastdiffsr_tpu_torch.train import create_train_state, make_train_step
    dev = torch.device("cuda")
    unet_opt = dict(cfg["model"]["unet"], dropout=0.0)
    lr = float(cfg["train"]["optimizer"]["lr"])
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(
                              cfg["model"]["beta_schedule"]["train"],
                              device=dev))
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    r = int(cfg["datasets"]["train"]["r_resolution"])
    batch = {k: torch.rand((B, r, r, 3), generator=g, device=dev) * 2 - 1
             for k in ("HR", "SR")}
    gamma, _ = eng.sample_gammas(g, B)
    noise = torch.randn((B, r, r, 3), generator=g, device=dev)
    step = make_train_step(eng, ema_start=0)
    out = {}
    for arm in ("reference", "k1"):
        net = unet_from_config(unet_opt, device=dev, seed=seed)
        state = create_train_state(net, torch.optim.Adam(
            net.parameters(), lr=lr, betas=(0.9, 0.999), eps=STEP_ADAM_EPS))
        kernels.reset_launch_counts()
        with (reference_norm() if arm == "reference"
              else contextlib.nullcontext()):
            _, m = step(state, batch, None, noise=noise, gamma=gamma)
        torch.cuda.synchronize()
        out[arm] = {"loss": m["l_pix"].item(),
                    "grad_norm": m["grad_norm"].item(),
                    "k1": kernels.LAUNCHES["gn_swish"],
                    "grads": {k: p.grad for k, p in net.named_parameters()},
                    "params": {k: p.detach()
                               for k, p in net.named_parameters()}}
        del state, net
    a, b = out["reference"], out["k1"]
    d_loss = abs(a["loss"] - b["loss"]) / abs(a["loss"])
    d_gn = abs(a["grad_norm"] - b["grad_norm"]) / a["grad_norm"]
    d_grad = max(((a["grads"][k] - b["grads"][k]).abs().max()
                  / a["grads"][k].abs().max().clamp_min(1e-30)).item()
                 for k in a["grads"])
    dg_abs = max((a["grads"][k] - b["grads"][k]).abs().max().item()
                 for k in a["grads"])
    d_par = max((a["params"][k] - b["params"][k]).abs().max().item()
                for k in a["params"])
    # how far the step moved the parameters, so the tolerance has a scale
    n_el = sum(p.numel() for p in a["grads"].values())
    moved = sum(int((gr.abs() / (gr.abs() + STEP_ADAM_EPS)
                     > STEP_TOL["param"]).sum())
                for gr in a["grads"].values()) / n_el
    ok = (d_loss <= STEP_TOL["loss"] and d_gn <= STEP_TOL["grad_norm"]
          and d_grad <= STEP_TOL["grad"] and d_par <= STEP_TOL["param"] * lr
          and a["k1"] == 0 and b["k1"] == K1_PER_FORWARD)
    print(f"[train step] {card} | full width B={B} {r}x{r} f32, dropout off,"
          f" injected gamma+noise, Blocks on gn_swish_reference vs K1: loss "
          f"{a['loss']:.6f} vs {b['loss']:.6f} (rel {d_loss:.3g}), grad_norm "
          f"{a['grad_norm']:.6g} vs {b['grad_norm']:.6g} (rel {d_gn:.3g}), "
          f"max per-tensor |dgrad|/max|g| {d_grad:.3g} (max |dgrad| "
          f"{dg_abs:.3g}), params after one Adam step (eps {STEP_ADAM_EPS}) "
          f"max |d| {d_par / lr:.3g} lr (tol {STEP_TOL['param']} lr; slope "
          f"bound lr*max|dgrad|/eps = {dg_abs / STEP_ADAM_EPS:.3g} lr; "
          f"{moved:.3g} of elements moved by more than the tol) | K1 "
          f"launches {a['k1']} / {b['k1']} (want 0 / {K1_PER_FORWARD}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    del out, a, b
    torch.cuda.empty_cache()
    return {"rel_loss": d_loss, "rel_grad_norm": d_gn,
            "rel_grad": d_grad, "max_abs_grad_gap": dg_abs,
            "adam_eps": STEP_ADAM_EPS, "param_max_over_lr": d_par / lr,
            "share_moved_over_tol": moved, "ok": ok}, ok


def phase_train(cfg, card, seed):
    """cli.sr_mfe -p train then -p val, on CUDA at full width."""
    import torch

    from fastdiffsr_tpu_torch.cli import sr_mfe
    from fastdiffsr_tpu_torch.data import write_pack
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.ops import fused_conv, kernels
    from fastdiffsr_tpu_torch.train import create_train_state, make_optimizer
    from fastdiffsr_tpu_torch.train.checkpoint import load_state
    dev = torch.device("cuda")
    work = os.path.join(ROOT, "build", "smoke")
    ds = cfg["datasets"]["train"]
    droot = write_pack(os.path.join(work, f"train_pack_{seed}"),
                       TRAIN_IMAGES, seed + 7, int(ds["l_resolution"]),
                       int(ds["r_resolution"]))
    cfg = json.loads(json.dumps(cfg))
    cfg["name"] = "chip_smoke_train"
    cfg["datasets"]["train"].update(dataroot=droot, datatype="npy",
                                    batch_size=B_TRAIN)
    cfg["datasets"]["val"].update(dataroot=droot, datatype="npy",
                                  data_len=VAL_IMAGES)
    cfg["train"].update(n_iter=TRAIN_STEPS, val_freq=10 ** 9,
                        save_checkpoint_freq=10 ** 9, print_freq=8)
    T = int(cfg["model"]["beta_schedule"]["val"]["n_timestep"])
    run_cfg = os.path.join(work, "chip_smoke_train.json")
    with open(run_cfg, "w") as f:
        json.dump(cfg, f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    summary = sr_mfe.main(["-p", "train", "-c", run_cfg, "--device", "cuda",
                           "--seed", str(seed)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = summary["l_pix"]
    want_k1 = K1_PER_FORWARD * TRAIN_STEPS
    ckpt = summary["checkpoint"]
    payload = torch.load(os.path.join(ckpt, "state.pt"), map_location=dev,
                         weights_only=True)
    init = unet_from_config(cfg["model"]["unet"], device=dev,
                            seed=seed).state_dict()
    changed = sum(not torch.equal(init[k], payload["params"][k])
                  for k in init)
    net = unet_from_config(cfg["model"]["unet"], device=dev, seed=seed + 1)
    state = load_state(ckpt, create_train_state(
        net, make_optimizer(net.parameters(), cfg["train"]["optimizer"])))
    opt_sd = state.optimizer.state_dict()["state"]
    bit_equal = (
        state.step == TRAIN_STEPS == payload["step"]
        and all(torch.equal(v, payload["params"][k])
                for k, v in net.state_dict().items())
        and all(torch.equal(v, payload["ema_params"][k])
                for k, v in state.ema_params.items())
        and all(torch.equal(opt_sd[i][n], payload["opt_state"]["state"][i][n])
                for i in opt_sd for n in ("exp_avg", "exp_avg_sq")))
    del state, net, payload, init
    rate = summary["steady_steps_per_s"]
    train_ok = (summary["steps"] == TRAIN_STEPS and len(losses) == TRAIN_STEPS
                and all(map(math.isfinite, losses)) and changed > 0
                and bit_equal and launches["gn_swish"] == want_k1
                and launches["fused_gn_swish_conv3x3"] == 0
                and launches["channel_stats"] == 0 and rate is not None)
    print(f"[train] {card} | cli.sr_mfe -p train cuda f32 full width, B="
          f"{B_TRAIN}, T={T}, TF32 off, {TRAIN_STEPS} steps: l_pix "
          f"first {losses[0]:.4f} last {losses[-1]:.4f} mean "
          f"{sum(losses) / len(losses):.4f}, {changed} param tensors changed,"
          f" checkpoint {os.path.basename(ckpt)} reloads bit-equal "
          f"{bit_equal} | K1 launches {launches['gn_swish']} (want {want_k1}"
          f"), K3 {launches['fused_gn_swish_conv3x3']}, K2 "
          f"{launches['channel_stats']} | steady {rate:.3f} steps/s "
          f"({rate * B_TRAIN:.2f} img/s) excluding the first step; wall "
          f"{wall:.1f} s | peak {peak_gib:.2f} GiB "
          f"{'ok' if train_ok else 'FAIL'}", flush=True)
    k1_launches = launches["gn_swish"]

    cfg["path"]["resume_state"] = ckpt
    val_cfg = os.path.join(work, "chip_smoke_val.json")
    with open(val_cfg, "w") as f:
        json.dump(cfg, f)
    kernels.reset_launch_counts()
    routes0 = dict(fused_conv.ROUTE_TAKEN)
    t0 = time.time()
    res = sr_mfe.main(["-p", "val", "-c", val_cfg, "--device", "cuda",
                       "--seed", str(seed)])
    torch.cuda.synchronize()
    vwall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    routes = {k: n - routes0[k] for k, n in fused_conv.ROUTE_TAKEN.items()}
    want_k3, want_k2 = 49 * T * VAL_IMAGES, 4 * T * VAL_IMAGES
    val_ok = (math.isfinite(res.get("psnr", math.nan))
              and math.isfinite(res.get("ssim", math.nan))
              and launches["fused_gn_swish_conv3x3"] == want_k3
              and routes == {"wgmma": 0, "cuda_cores": want_k3}
              and launches["channel_stats"] == want_k2
              and launches["gn_swish"] == 0)
    print(f"[val] {card} | cli.sr_mfe -p val cuda f32 fused from "
          f"{os.path.basename(ckpt)}, {VAL_IMAGES} images, T={T}: psnr "
          f"{res.get('psnr', math.nan):.4f} ssim {res.get('ssim', math.nan):.4f}"
          f" | K3 launches {launches['fused_gn_swish_conv3x3']} (want "
          f"{want_k3}, all on the float32 CUDA-core kernel: "
          f"{routes['cuda_cores']}), K2 {launches['channel_stats']} (want "
          f"{want_k2}), K1 "
          f"{launches['gn_swish']} | {res.get('avg_time', math.nan):.3f} s "
          f"per image after the first, wall {vwall:.1f} s "
          f"({vwall / VAL_IMAGES:.3f} s per image) "
          f"{'ok' if val_ok else 'FAIL'}", flush=True)
    detail = {"steps": TRAIN_STEPS, "batch": B_TRAIN, "T": T,
              "l_pix": losses, "steady_steps_per_s": rate, "wall_s": wall,
              "peak_gib": peak_gib, "k1_launches": k1_launches,
              "bit_equal": bit_equal, "val": res, "val_wall_s": vwall,
              "val_launches": launches, "val_routes": routes}
    return detail, k1_launches, train_ok and val_ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds weights, inputs and the synthetic data")
    args = ap.parse_args(argv)

    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from fastdiffsr_tpu_torch.ops import fused_conv, kernels
    from fastdiffsr_tpu_torch.cli import infer
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr_fused import (
        fused_apply, prepare_fused_params)
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.data import write_pack

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    card = card_line()
    print(f"card: {card}", flush=True)
    detail = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    ok = True

    # 1. build
    t0 = time.time()
    lib_path = kernels.build()
    kernels.load()
    build_s = time.time() - t0
    log = (lib_path.parent / "build.log").read_text().splitlines()
    ptxas = ptxas_report(log)
    print(f"[build] {card} | build+load {build_s:.1f} s in this run "
          f"(nvcc {log[0]}) -> {lib_path} | ptxas: " + " ; ".join(ptxas),
          flush=True)
    detail["build_seconds"] = build_s
    detail["ptxas"] = ptxas

    cfg_path = os.path.join(ROOT, "fastdiffsr_tpu_torch", "configs",
                            "sr_fastdiffsr_test_64_256.json")
    cfg = load_json_config(cfg_path)
    unet_opt = cfg["model"]["unet"]
    T = int(cfg["model"]["beta_schedule"]["val"]["n_timestep"])
    dev = torch.device("cuda")

    # 2./3. kernels vs plain at the shapes of one full-width eval
    B = B_KERNEL
    net = unet_from_config(unet_opt, dtype=torch.float32, device=dev,
                           seed=args.seed)
    fp16 = prepare_fused_params(net, torch.bfloat16)
    gx = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn((B, 256, 256, 6), generator=gx, device=dev)
    level = torch.rand((B,), generator=gx, device=dev)
    k3_sigs, k2_sigs = record_calls(fp16, x, level)
    n_k3 = sum(k3_sigs.values())
    n_k2 = sum(k2_sigs.values())
    print(f"[shapes] {card} | one eval: {n_k3} K3 calls in {len(k3_sigs)} "
          f"shapes, {n_k2} K2 calls in {len(k2_sigs)} shapes", flush=True)
    ok &= n_k3 == 49 and n_k2 == 4
    del x
    k3_rows, k3_ok = phase_k3(k3_sigs, B, REPS, card, args.seed)
    k3_b1_rows, k3_b1_ok = phase_k3(k3_sigs, 1, REPS, card, args.seed,
                                    dtypes=("f32",))
    k2_rows, k2_ok = phase_k2(k2_sigs, B, REPS, card, args.seed)
    ok &= k3_ok and k3_b1_ok and k2_ok
    detail["k3"], detail["k3_b1"], detail["k2"] = k3_rows, k3_b1_rows, k2_rows

    # 4. one full-width UNet eval, fused vs plain
    Bu = B_UNET
    x = torch.randn((Bu, 256, 256, 6), generator=gx, device=dev)
    level = torch.rand((Bu,), generator=gx, device=dev)
    with torch.no_grad(), reference_norm():
        want = net(x, level)
    got32 = fused_apply(prepare_fused_params(net, torch.float32), x, level)
    got16 = fused_apply(fp16, x, level)
    torch.cuda.synchronize()
    e32 = (got32 - want).abs().max().item()
    e16 = (got16 - want).abs().max().item()
    ymax = want.abs().max().item()
    tol16 = UNET_TOL["bf16"] * max(1.0, ymax)
    unet_ok = (e32 <= UNET_TOL["f32"] and e16 <= tol16
               and bool(torch.isfinite(got16).all()))
    ok &= unet_ok
    print(f"[unet] {card} | B={Bu} 256x256 full width: fused f32 vs plain "
          f"f32 max|d|={e32:.3g} (tol {UNET_TOL['f32']}), fused bf16 vs "
          f"plain f32 max|d|={e16:.3g} (tol {tol16:.3g}), max|y|={ymax:.3g} "
          f"{'ok' if unet_ok else 'FAIL'}", flush=True)
    detail["unet"] = {"B": Bu, "err_f32": e32, "err_bf16": e16}
    del x, want, got32, got16, net, fp16

    # 5. serving path end to end
    work = os.path.join(ROOT, "build", "smoke")
    droot = os.path.join(work, f"pack_{args.seed}")
    n_img = SERVE_BATCH * SERVE_BATCHES
    write_pack(droot, n_img, args.seed)
    cfg["name"] = "chip_smoke"
    val = cfg["datasets"]["val"]
    val.update(dataroot=droot, datatype="npy", batch_size=SERVE_BATCH,
               data_len=n_img)
    run_cfg = os.path.join(work, "chip_smoke_infer.json")
    with open(run_cfg, "w") as f:
        json.dump(cfg, f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    routes0 = dict(fused_conv.ROUTE_TAKEN)
    t0 = time.time()
    summary = infer.main(["-c", run_cfg, "--device", "cuda", "--dtype",
                          "bf16", "--seed", str(args.seed)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    routes = {k: n - routes0[k] for k, n in fused_conv.ROUTE_TAKEN.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    pngs = [p for p in os.listdir(summary["results"]) if p.endswith(".png")]
    want_k3 = 49 * T * SERVE_BATCHES
    want_k2 = 4 * T * SERVE_BATCHES
    serve_ok = (launches["fused_gn_swish_conv3x3"] == want_k3
                and routes == {"wgmma": want_k3, "cuda_cores": 0}
                and launches["channel_stats"] == want_k2
                and summary["images"] == n_img and len(pngs) == n_img)
    ok &= serve_ok
    img_s = (1.0 / summary["mean_latency_s"] if summary["mean_latency_s"]
             else None)
    print(f"[serve] {card} | cli.infer cuda bf16 fused, full width, T={T}, "
          f"{SERVE_BATCHES} batches of {SERVE_BATCH}: {summary['images']} "
          f"images finite, {len(pngs)} PNGs | K3 launches "
          f"{launches['fused_gn_swish_conv3x3']} (want {want_k3}; "
          f"{routes['wgmma']} on wgmma, {routes['cuda_cores']} on CUDA "
          f"cores), K2 "
          f"{launches['channel_stats']} (want {want_k2}) | steady "
          f"{img_s:.3f} img/s, {summary['mean_latency_s']:.4f} s/img; "
          f"wall {wall:.1f} s incl. first batch | peak "
          f"{peak_gib:.2f} GiB {'ok' if serve_ok else 'FAIL'}", flush=True)
    detail["serve"] = {"T": T, "batch": SERVE_BATCH,
                       "batches": SERVE_BATCHES, "img_per_s": img_s,
                       "mean_latency_s": summary["mean_latency_s"],
                       "wall_s": wall, "peak_gib": peak_gib,
                       "launches": launches, "routes": routes}

    del summary
    torch.cuda.empty_cache()

    # 6.-9. the training path
    train_cfg = load_json_config(os.path.join(
        ROOT, "fastdiffsr_tpu_torch", "configs",
        "sr_fastdiffsr_train_64_256.json"))
    r = int(train_cfg["datasets"]["train"]["r_resolution"])
    tnet = unet_from_config(train_cfg["model"]["unet"], device=dev,
                            seed=args.seed)
    x = torch.randn((B_TRAIN, r, r, 6), generator=gx, device=dev)
    level = torch.rand((B_TRAIN,), generator=gx, device=dev)
    k1_sigs, strided = record_k1(tnet, x, level)
    n_k1 = sum(k1_sigs.values())
    shapes_ok = n_k1 == K1_PER_FORWARD and strided == 0
    ok &= shapes_ok
    print(f"[shapes] {card} | one training forward: {n_k1} K1 calls in "
          f"{len(k1_sigs)} shapes (want {K1_PER_FORWARD}), {strided} "
          f"Blocks with a non-contiguous NHWC input "
          f"{'ok' if shapes_ok else 'FAIL'}", flush=True)
    del tnet, x
    k1_rows, k1_ok = phase_k1(k1_sigs, B_TRAIN, REPS, card, args.seed)
    largest = max(k1_sigs, key=lambda sg: sg[0] * sg[1] * sg[2])
    detail["k1_grad"], grad_ok = phase_k1_grad(largest, B_TRAIN, card,
                                               args.seed)
    detail["k1"] = k1_rows
    detail["train_step"], step_ok = phase_train_parity(train_cfg, B_TRAIN,
                                                       card, args.seed)
    detail["train"], k1_launches, train_ok = phase_train(train_cfg, card,
                                                         args.seed)
    ok &= k1_ok and grad_ok and step_ok and train_ok

    def k3_route_of(dt):
        """The kernel every K3 row of that type ran on (or "mixed")."""
        seen = {r["kernel_route"] for r in k3_rows + k3_b1_rows
                if r["dtype"] == dt}
        return seen.pop() if len(seen) == 1 else "mixed"

    def by(rows, dt="bf16", per="calls_per_eval"):
        ops = sum(r["bound_ms"] * r[per] for r in rows
                  if r["dtype"] == dt and r["bound_by"] == "operations")
        return ("operations" if ops >= total(rows, "bound_ms", dt, per) / 2
                else "bytes")

    print_k3_totals(k3_rows, card)
    print_k3_totals(k3_b1_rows, card)
    k1_tot = {k: total(k1_rows, k, "f32", "calls_per_forward")
              for k in ("ms", "plain_ms", "bound_ms", "two_call_library_ms",
                        "reference_ms", "wall_ms", "plain_wall_ms",
                        "two_call_library_wall_ms", "reference_wall_ms")}
    print(f"[K1 total] {card} | f32 per training forward (B={B_TRAIN}), "
          f"device: kernel {k1_tot['ms']:.3f} ms, plain "
          f"{k1_tot['plain_ms']:.3f} ms, F.group_norm+F.silu "
          f"{k1_tot['two_call_library_ms']:.3f} ms, gn_swish_reference "
          f"(recomputed in the backward) {k1_tot['reference_ms']:.3f} ms | "
          f"wall: kernel {k1_tot['wall_ms']:.3f} ms, plain "
          f"{k1_tot['plain_wall_ms']:.3f} ms, two calls "
          f"{k1_tot['two_call_library_wall_ms']:.3f} ms | bound "
          f"{k1_tot['bound_ms']:.3f} ms", flush=True)
    detail["k1_total_f32"] = k1_tot
    kern = [
        {"name": "gn_swish", "route": "cuda",
         "source": "fastdiffsr_tpu_torch/csrc/gn_swish.cu",
         "replaces": "fastdiffsr_tpu/ops/groupnorm.py:54",
         "launches": k1_launches,
         "max_abs_err": max(r["max_abs_err"] for r in k1_rows
                            if r["dtype"] == "f32"),
         "ms": k1_tot["ms"], "plain_ms": k1_tot["plain_ms"],
         "bound_ms": k1_tot["bound_ms"],
         "bound_by": by(k1_rows, "f32", "calls_per_forward"),
         "library_ms": None,
         "two_call_library_ms": k1_tot["two_call_library_ms"],
         "wall_ms": k1_tot["wall_ms"]},
        # K3 has two hand-written kernels: bf16 maps (serving) run on the
        # tensor cores, f32 maps (validation) on the CUDA cores
        {"name": "fused_gn_swish_conv3x3", "route": "cuda",
         "source": "fastdiffsr_tpu_torch/csrc/fused_conv_wgmma.cu",
         "replaces": "fastdiffsr_tpu/ops/fused_conv.py:107",
         "launches": routes["wgmma"],
         "kernel_route": k3_route_of("bf16"),
         "max_abs_err": max(r["max_abs_err_y"] for r in k3_rows
                            if r["dtype"] == "bf16"),
         "ms": total(k3_rows, "ms"), "plain_ms": total(k3_rows, "plain_ms"),
         "bound_ms": total(k3_rows, "bound_ms"), "bound_by": by(k3_rows),
         "library_ms": total(k3_rows, "library_ms"),
         "wall_ms": total(k3_rows, "wall_ms")},
        {"name": "fused_gn_swish_conv3x3_f32", "route": "cuda",
         "source": "fastdiffsr_tpu_torch/csrc/fused_conv.cu",
         "replaces": "fastdiffsr_tpu/ops/fused_conv.py:107",
         "launches": detail["train"]["val_routes"]["cuda_cores"],
         "kernel_route": k3_route_of("f32"),
         "max_abs_err": max(r["max_abs_err_y"] for r in k3_rows
                            if r["dtype"] == "f32"),
         "ms": total(k3_rows, "ms", "f32"),
         "plain_ms": total(k3_rows, "plain_ms", "f32"),
         "bound_ms": total(k3_rows, "bound_ms", "f32"),
         "bound_by": by(k3_rows, "f32"),
         "library_ms": total(k3_rows, "library_ms", "f32"),
         "wall_ms": total(k3_rows, "wall_ms", "f32"),
         # per eval at batch 1, the validation batch
         "ms_b1": total(k3_b1_rows, "ms", "f32"),
         "library_ms_b1": total(k3_b1_rows, "library_ms", "f32")},
        {"name": "channel_stats", "route": "cuda",
         "source": "fastdiffsr_tpu_torch/csrc/channel_stats.cu",
         "replaces": "fastdiffsr_tpu/ops/groupnorm.py:143",
         "launches": launches["channel_stats"],
         "max_abs_err": max(r["max_abs_err"] for r in k2_rows
                            if r["dtype"] == "f32"),
         "ms": total(k2_rows, "ms"), "plain_ms": total(k2_rows, "plain_ms"),
         "bound_ms": total(k2_rows, "bound_ms"), "bound_by": by(k2_rows),
         "library_ms": None, "wall_ms": total(k2_rows, "wall_ms")},
    ]
    detail["kernels"] = kern
    detail["seconds"] = time.time() - t_start
    print(f"[time] {card} | the run took {detail['seconds']:.1f} s, of which "
          f"{build_s:.1f} s built the kernels", flush=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)
    if not ok:
        print("chip_smoke: a check failed (see the FAIL lines above)",
              file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
