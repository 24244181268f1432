#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fastdiffsr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--gdp-reference | --ediffsr-only |
                                      --msi-only | --dist-only]

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
3. the same for K2 (channel statistics) at its shapes, at batch 16 in
   bf16 and f32 and at batch 1 in f32 (the ``-p val`` shape): per shape
   the kernels one call launches (the kernel nodes of a captured CUDA
   graph: one), repeated calls and graph replays bit-equal, and the times
   beside the launch floor (a one-element in-place add timed the same way);
4. one full-width UNet eval at 256x256, fused forward against the plain
   UNet (its Blocks on gn_swish_reference), f32 (and bf16 fused against
   f32 plain);
5. the serving path end to end: a synthetic 64->256 npy pack from
   --seed, then ``fastdiffsr_tpu_torch.cli.infer`` on CUDA at full width,
   T=20, in bf16, with launch counters that must show 49 K3 launches, all
   on the wgmma kernel, and 4 K2 launches per UNet eval; then the same
   with no ``--dtype`` (float32, infer's default; K3 on the CUDA cores);
6. K1 (GroupNorm -> Swish) against its plain version at every distinct
   K1 shape of one full-width training forward at batch 4, in f32 and
   bf16 (two kernels per call: K2's, then the apply pass), with the
   kernel's, the plain version's and the two library calls' (F.group_norm
   then F.silu) times and the least time the card could take;
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
   from it on a few images (PSNR/SSIM, LPIPS computed on the card with a
   weight pack made from --seed, 49 K3 and 4 K2 launches per UNet eval,
   seconds per image, and LPIPS's milliseconds per image);
10. the fast samplers: ``cli.infer`` at full width in bf16 on the fused
   forward with DDIM and then DPM-Solver++ at 10 steps (49 K3 launches,
   all on wgmma, and 4 K2 per eval), then ``sample_ddim`` and
   ``sample_dpm`` on the fused f32 forward against the plain UNet (on
   gn_swish_reference) from the same initial noise, with the bf16 fused
   forward as a control that must fall outside the tolerance;
11. K1 against its plain version at every distinct K1 shape of one SR3
   (ddpm) and one guided (gdp) training forward at batch 4, 256x256, that
   phase 6 did not measure, with the same columns, then in f32 at batch
   1, the batch of their ``-p val`` runs, and K1's time per forward of
   each net at both batches;
12. the ddpm, tesr and gdp variants: per variant a train step on K1
   against one on gn_swish_reference (randomized weights), then
   ``cli.sr_mfe -p train`` at full width (45 K1 launches per step for
   SR3, 29 for the guided UNet; steady steps/s; peak memory; a checkpoint
   that reloads bit-equal; gdp also validates 13 images at its last step
   inside the run, on cuDNN's heuristics) and ``-p val`` on one image
   (ddpm: ancestral T=1000; tesr, gdp: DDIM 50 steps; K1 launches per
   eval, seconds per image); then ``cli.infer`` of the ddpm config in
   bf16 on the plain
   forward with DPM-Solver++ at 20 steps;
13. K3 (f32 and bf16) and K2 against their plain versions at every
   signature of one 128->512 UNet eval at batch 1 (the maps of
   configs/sr_fastdiffsr_infer_x4.json: 512, 256, 128 and 64 pixels a
   side), with the same columns and per-eval totals;
14. the 128->512 path end to end: ``cli.infer`` of
   configs/sr_fastdiffsr_infer_x4.json at full width, T=20, batch 1, on a
   synthetic 128->512 pack from --seed, first with no ``--dtype`` (float32,
   K3 on the CUDA cores) and then with ``--dtype bf16`` (K3 on wgmma), 49
   K3 and 4 K2 launches per eval on the routed kernel, seconds per image
   (mean, and the spread over the images) and peak memory;
15. ``cli.fid`` on the card over two directories of FID_IMAGES 256x256
   PNGs written from --seed (HR tiles and their x4 bicubic baseline),
   with an Inception weight pack made from --seed: the extractor's time
   per image apart from the PNG decoding and from scipy's ``sqrtm``; the
   card's pool3 features against the CPU's on a few images, and the FID
   against a float64 evaluation of the same statistics by eigenvalues;
16. EDiffSR through ``fastdiffsr_tpu_torch.ediffsr.train`` on synthetic
   64->256 PNG folders from --seed: training of the paper's full-width
   ConditionalNAFNet (setting_mfe_Train_x4.yml: width 64, enc
   [14,1,1,1], T=100, batch 2, AdamW 4e-5) for EDIFFSR_STEPS steps with a
   T=100 validation of 2 images at the last one (steady steps/s, peak
   memory, seconds per validation image), ``--test`` of
   setting_mfe_Test_x4.yml from its checkpoint with the reverse SDE on 4
   images and the Euler ODE and RK45 on one each (seconds per image,
   RK45's accepted and trial steps, peak memory), and the same port code
   on the card against the CPU (a full-width NAFNet forward, a 4-step
   reverse SDE, a ConditionalUNet forward). EDiffSR has no kernel of
   ours: every launch counter must read 0 there;
17. the five MSI baselines (SwinIR, HAT, HSENet, TransENet, NDSRGAN)
   through ``fastdiffsr_tpu_torch.msi.main`` at full width (JAX
   ``msi/main.py``'s defaults, x4, crop 256, batch 1) on PNG folders from
   --seed: ``--mode train`` for MSI_STEPS steps with its epoch-end
   validation of 8 tiles (steady steps/s, peak memory, a checkpoint
   that reloads bit-equal), ``--mode validateByClass`` from the
   checkpoint (PSNR/SSIM/ERGAS and LPIPS on the card, seconds per
   image), ``--mode test_single`` on an odd-size PNG; NDSRGAN's
   GANTrainer at full width (batch 2, GAN_STEPS steps); each full-width
   model on the card against the CPU on an LR input that is not a
   window multiple. No kernel of ours here either: every launch counter
   must read 0;
18. data parallelism under ``python -m torch.distributed.run --standalone
   --nproc_per_node=1`` (world size 1: the machine has one card, so the
   2-rank equalities rest on the CPU tests with gloo), the rank's backend
   checked to be NCCL: ``sr_mfe -p train -dist`` on the train config as
   shipped (full width, batch 4, 256x256) for DIST_TRAIN_STEPS steps with
   one in-run validation and one checkpoint on rank 0 (45 K1 launches
   per step, 49 K3 and 4 K2 per validation eval; per-step l_pix against
   the same run without -dist; steady steps/s with and without; the
   all-reduce of the UNet's gradients in DDP's 25 MiB buckets, CUDA-event
   ms per step; peak GiB), the checkpoint in a plain ``-p val``;
   ``cli.infer -dist`` in f32 on DIST_INFER_IMAGES images against the
   same run without (SR PNGs equal); ``ediffsr.train -launcher pytorch``
   (phase 16's run on one loader thread), ``msi.main --launcher
   pytorch`` for SwinIR (phase 17's) and NDSRGAN's GANTrainer in DDP,
   each against its plain run in this
   process (losses, steady steps/s, peak GiB; no kernel of ours).

Float32 is full float32 throughout (no TF32, as the CLIs set it). The
CLIs set cuDNN's algorithm choice themselves (``device.
set_cudnn_autotuning``): timed for ``-p train``, heuristics for ``-p val``
and ``infer``. The script's own phases time them (``own_phases_regime``);
PyTorch keeps the first plan of a shape, so ``-p val`` at batch 1 may
reuse a plan timed for phase 2's F.conv2d at the same shape.

``--gdp-reference`` runs, after the build, only the gdp variant's
evaluation at its reference shape (ancestral T=1000 at 256x256 through
``cli.infer``, one image, f32 and bf16), which is too long for every run.
``--ediffsr-only`` runs, after the build, only phase 16,
``--msi-only`` only phase 17 and ``--dist-only`` only phase 18
(``--dist-worker <spec>`` is phase 18's rank, which torchrun starts).

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
kernel build included: about ten minutes on an H100.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
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
# K1 calls per UNet forward: FastDiffSR and SR3, 44 ResnetBlock Blocks +
# the final Block; guided, 28 ResBlock in-norms + the final out-norm
K1_PER_FORWARD = {"fastdiffsr": 45, "ddpm": 45, "tesr": 45, "gdp": 29}
SAMPLER_STEPS = 10   # phase 10: DDIM / DPM-Solver++ steps
B_SAMPLER = 2        # phase 10: batch of the fused-vs-plain sampler check
# fused f32 vs plain sampling: each eval may differ by SAMPLER_EPS_GAP
# (about twice the f32 fused-vs-plain gap of one eval in phase 4,
# 4.65e-6), and step k carries it into x with the gain of
# sampler_gains(); the tolerance is their product summed over the steps.
# The first step's gain (~999 of the DDIM sum) is an upper bound that the
# x0 clip removes wherever x0 saturates, so every run also takes a control
# reading: the bf16 fused forward against the same plain f32 run must
# exceed the tolerance, or the check could not tell a bf16-sized fault.
SAMPLER_EPS_GAP = 1e-5
VARIANT_STEPS = 6    # phase 12: full-width train steps per variant
# phase 12: the val sampler of each variant (ddpm: its own T=1000)
VARIANT_VAL = {"ddpm": None,
               "tesr": {"sampler": "ddim", "ddim_steps": 50},
               "gdp": {"sampler": "ddim", "ddim_steps": 50}}
# phase 14: 128->512 images per type at batch 1; the first is set-up, and
# the other 47 make a steady window of seconds in bf16
INFER_512_IMAGES = 48
# phase 15: images per cli.fid directory, the Potsdam test set's count
# (SURVEY.md §3), more than pool3's 2048 features
FID_IMAGES = 3272
FID_CHECK_IMAGES = 8   # phase 15: pool3 on the card against the CPU's
FID_FEAT_TOL = 1e-4    # |dpool3| <= tol * max|pool3| (the CPU tests')
FID_RTOL = 1e-3        # FID against the eigenvalue evaluation (the tests')
LPIPS_REPS = 10        # phase 9: timed LPIPS calls
# phase 16, EDiffSR: full-width training steps (batch 2, T=100), the PNGs
# written per split, the in-run validation's images
EDIFFSR_STEPS = 16
EDIFFSR_TRAIN_IMAGES = 16
EDIFFSR_VAL_IMAGES = 4
EDIFFSR_IN_RUN_VAL = 2
# the same port code on the card and on the CPU: max|d| <= tol * max|y|
# (IEEE float32 on both; only the order of the sums differs)
EDIFFSR_CPU_TOL = 1e-4
# phase 17, MSI: full-width training steps per model (batch 1, crop 256,
# x4), the training tiles, the test set's classes and tiles per class,
# the odd-size test_single input (h, w; TransENet takes multiples of its
# 8x8 patches), GAN steps and batch, and the card-vs-CPU LR inputs
MSI_MODELS = ("SwinIR", "HAT", "HSENet", "TransENet", "NDSRGAN")
MSI_STEPS = 12
MSI_TRAIN_TILES = 16
MSI_CLASSES, MSI_PER_CLASS = 2, 4
MSI_SINGLE = {"TransENet": (184, 248)}
MSI_SINGLE_DEFAULT = (190, 250)
GAN_STEPS, GAN_BATCH = 4, 2
MSI_CPU_INPUT = {"TransENet": (40, 32)}
MSI_CPU_INPUT_DEFAULT = (36, 28)
MSI_CPU_TOL = 1e-4
# phase 18, data parallel under torchrun at world size 1: sr_mfe -dist
# steps (one in-run validation and one checkpoint at the last), cli.infer
# -dist images (one batch of phase 5's size), the loss tolerance of each
# -dist run against its plain run (the JAX package's two-process bound;
# each process times its own cuDNN algorithms, so the last bits may
# differ), the SR PNGs' (uint8 levels; a float gap within K3's tolerance
# may round across one level), the worker's time limit in seconds, and
# the timed all-reduces
DIST_TRAIN_STEPS = 8
DIST_INFER_IMAGES = 16
DIST_LPIX_RTOL = 2e-3
DIST_PNG_TOL = 1
DIST_TIMEOUT = 600
ALLREDUCE_REPS = 20


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


@functools.lru_cache(maxsize=None)
def launch_floor_ms() -> float:
    """The single-launch floor of this card: device time per call of a
    one-element PyTorch in-place op in device_ms's CUDA-graph harness,
    measured once per run."""
    import torch
    one = torch.zeros(1, device="cuda")
    return device_ms(lambda: one.add_(1.0), REPS)


def same_bits_again(fn, want, n: int = 3) -> bool:
    """``n`` more eager calls of ``fn``, and ``n`` replays of one call
    captured in a CUDA graph, each give ``want``'s bits."""
    import torch
    if not all(torch.equal(fn(), want) for _ in range(n)):
        return False
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(n):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            return False
    return True


def _k1_sites():
    """The UNet modules whose GroupNorm -> Swish calls gn_swish_custom:
    the FastDiffSR/SR3 Block and the guided UNet."""
    from fastdiffsr_tpu_torch.models import unet_fastdiffsr, unet_guided
    return (unet_fastdiffsr, unet_guided)


@contextlib.contextmanager
def patched_k1(fn):
    """Within the block, every UNet GroupNorm -> Swish that runs K1 calls
    ``fn`` in place of gn_swish_custom."""
    mods = _k1_sites()
    orig = [m.gn_swish_custom for m in mods]
    for m in mods:
        m.gn_swish_custom = fn
    try:
        yield
    finally:
        for m, o in zip(mods, orig):
            m.gn_swish_custom = o


def own_phases_regime():
    """cuDNN's algorithm choice for the script's own phases: timed. A CLI
    sets its own (``device.set_cudnn_autotuning``) and this is restored
    after it. PyTorch keeps the plan of a convolution shape it met first
    whatever the setting later is, so the own phases, which meet the
    training shapes before ``-p train`` does, must time them as that CLI
    would."""
    from fastdiffsr_tpu_torch.device import set_cudnn_autotuning
    set_cudnn_autotuning(True)


def reference_norm():
    """Within the block, every UNet Block (and the guided UNet's K1
    norms) runs gn_swish_reference (plain PyTorch, autograd) in place of
    K1's gn_swish_custom."""
    from fastdiffsr_tpu_torch.ops.groupnorm import gn_swish_reference
    return patched_k1(gn_swish_reference)


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


def print_k3_totals(rows, card, label=""):
    """One ``[K3 total ...]`` line per type of ``rows`` (one batch)."""
    for dt in sorted({r["dtype"] for r in rows}):
        B = rows[0]["B"]
        routes = {r["kernel_route"] for r in rows if r["dtype"] == dt}
        calls = sum(r["calls_per_eval"] for r in rows if r["dtype"] == dt)
        print(f"[K3 total {dt} B={B}{label}] {card} | per UNet eval "
              f"({calls} calls) on "
              f"{'/'.join(sorted(routes))}, device: kernel "
              f"{total(rows, 'ms', dt):.3f} ms, plain "
              f"{total(rows, 'plain_ms', dt):.3f} ms, F.conv2d "
              f"{total(rows, 'library_ms', dt):.3f} ms | wall: kernel "
              f"{total(rows, 'wall_ms', dt):.3f} ms | bound "
              f"{total(rows, 'bound_ms', dt):.3f} ms", flush=True)


def phase_k2(sigs, B, reps, card, seed, dtypes=("bf16", "f32")):
    """K2 against its plain version at every signature of ``sigs`` at batch
    ``B`` in each of ``dtypes``: one kernel node per call (a captured
    graph), repeated calls and graph replays bit-equal, then the device and
    wall times of the kernel and the plain version beside the bound and the
    launch floor."""
    import torch

    from fastdiffsr_tpu_torch.ops import kernels
    from fastdiffsr_tpu_torch.ops.groupnorm import (channel_stats,
                                                    channel_stats_plain)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    floor = launch_floor_ms()
    rows, ok = [], True
    for (H, W, C), count in sorted(sigs.items()):
        for dt_name in dtypes:
            dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dt_name]
            x = torch.randn((B, H, W, C), generator=g, device=dev).to(dt)
            got = channel_stats(x)
            torch.cuda.synchronize()
            want = channel_stats_plain(x)
            err = (got - want).abs().max().item()
            tol = STATS_RTOL * want[:, 1].abs().max().item() + 1e-3
            per_call = kernels.kernels_per_call(lambda: channel_stats(x))
            same = same_bits_again(lambda: channel_stats(x), got)
            row_ok = err <= tol and per_call == 1 and same
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
                         "bound_ms": b_ms, "bound_by": b_by,
                         "launches_per_call": per_call, "bit_equal": same,
                         "floor_ms": floor})
            print(f"[K2] {card} | {dt_name} B={B} {H}x{W} C={C} x{count}/eval"
                  f" | max|d|={err:.3g} (tol {tol:.3g}), {per_call} launch"
                  f"/call, repeats and graph replays "
                  f"{'bit-equal' if same else 'DIFFER'} "
                  f"{'ok' if row_ok else 'FAIL'} | device: kernel {ms:.4f} "
                  f"ms ({b_ms / ms:.2f} of bound) plain {plain_ms:.4f} ms | "
                  f"wall: kernel {wall_ms:.4f} ms plain {plain_wall_ms:.4f} "
                  f"ms | bound {b_ms:.4f} ms ({b_by}) | launch floor "
                  f"{floor:.4f} ms", flush=True)
            del x, got, want
    return rows, ok


def floor_line(launches) -> str:
    """``launches`` beside the time they take at the launch floor."""
    floor = launch_floor_ms()
    return (f"{launches} launches at the floor {floor:.4f} ms: "
            f"{launches * floor:.4f} ms")


def print_k2_totals(rows, card, label=""):
    """One ``[K2 total ...]`` line per type of ``rows`` (one batch): per
    eval, beside the bound and the floor of the eval's launches."""
    for dt in sorted({r["dtype"] for r in rows}):
        B = rows[0]["B"]
        calls = sum(r["calls_per_eval"] for r in rows if r["dtype"] == dt)
        launches = total(rows, "launches_per_call", dt)
        kern, bnd = total(rows, "ms", dt), total(rows, "bound_ms", dt)
        print(f"[K2 total {dt} B={B}{label}] {card} | per UNet eval "
              f"({calls} calls), device: kernel {kern:.4f} ms "
              f"({bnd / kern:.2f} of bound), plain "
              f"{total(rows, 'plain_ms', dt):.4f} ms | wall: kernel "
              f"{total(rows, 'wall_ms', dt):.4f} ms | bound {bnd:.4f} ms | "
              f"{floor_line(launches)}", flush=True)


def record_k1(net, x, level):
    """Run one forward of ``net`` and return the distinct K1 call
    signatures (H, W, C, groups) with their call counts, and how many
    K1 calls got a map that is not a contiguous NHWC tensor."""
    import torch

    from fastdiffsr_tpu_torch.ops.groupnorm import gn_swish_custom
    sigs, strided = {}, [0]

    def rec(h, scale, bias, groups, eps=1e-5):
        sig = (h.shape[1], h.shape[2], h.shape[3], groups)
        sigs[sig] = sigs.get(sig, 0) + 1
        strided[0] += not h.is_contiguous()
        return gn_swish_custom(h, scale, bias, groups, eps)

    with torch.no_grad(), patched_k1(rec):
        net(x, level)
    return sigs, strided[0]


def phase_k1(sigs, B, reps, card, seed, dtypes=("f32", "bf16")):
    """K1 against its plain version at every signature of ``sigs`` at
    batch ``B`` in each of ``dtypes``, then the device and wall times of
    the kernel, the plain version, gn_swish_reference and F.group_norm +
    F.silu."""
    import torch
    import torch.nn.functional as F

    from fastdiffsr_tpu_torch.ops import kernels
    from fastdiffsr_tpu_torch.ops.groupnorm import (gn_swish, gn_swish_plain,
                                                    gn_swish_reference)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    rows, ok = [], True
    for (H, W, C, G), count in sorted(sigs.items()):
        for dt_name in dtypes:
            dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dt_name]
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
            # pass 1 (K2's kernel) and pass 2
            per_call = kernels.kernels_per_call(
                lambda: gn_swish(x, scale, bias, G))
            row_ok &= per_call == 2
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
                         "bound_ms": b_ms, "bound_by": b_by,
                         "launches_per_call": per_call})
            print(f"[K1] {card} | {dt_name} B={B} {H}x{W} C={C} G={G} "
                  f"x{count}/forward | max|dy|={err:.3g}, {per_call} "
                  f"launches/call {'ok' if row_ok else 'FAIL'} | device: "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                  f"F.group_norm+F.silu (two "
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


def randomize_params(net, seed: int):
    """Every parameter seeded on its device: weights N(0, 1/fan_in),
    GroupNorm and LayerNorm scales 1 + 0.1 N, biases (and MSI's bias
    tables) 0.1 N (the guided UNet's and HSENet's zero-initialised layers
    would otherwise hide part of the net)."""
    import torch
    dev = next(net.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            for name, p in m.named_parameters(recurse=False):
                z = torch.randn(p.shape, generator=g, device=dev)
                if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm)) \
                        and name == "weight":
                    p.copy_(1.0 + 0.1 * z)
                elif name == "weight":
                    p.copy_(z / math.sqrt(p[0].numel()))
                else:
                    p.copy_(0.1 * z)
    return net


def phase_train_parity(cfg, B, card, seed):
    """One full-width train step with the K1 norms on K1 and on
    gn_swish_reference, from the same weights (randomized for the SR3
    and guided UNets), batch and injected draws, dropout off, Adam with
    eps STEP_ADAM_EPS."""
    import torch

    from fastdiffsr_tpu_torch.cli.infer import build_unet
    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.ops import kernels
    from fastdiffsr_tpu_torch.train import create_train_state, make_train_step
    dev = torch.device("cuda")
    variant = cfg["model"]["which_model_G"]
    model_opt = dict(cfg["model"], unet=dict(cfg["model"]["unet"],
                                             dropout=0.0))
    lr = float(cfg["train"]["optimizer"]["lr"])
    spec = DiffusionSpec.for_variant(variant)
    eng = DiffusionEngine(spec, ScheduleBuffers.create(
        cfg["model"]["beta_schedule"]["train"], device=dev))
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    r = int(cfg["datasets"]["train"]["r_resolution"])
    batch = {k: torch.rand((B, r, r, 3), generator=g, device=dev) * 2 - 1
             for k in ("HR", "SR")}
    if spec.conditioning == "continuous_gamma":
        draws = {"gamma": eng.sample_gammas(g, B)[0]}
    else:
        draws = {"t": torch.randint(0, eng.buffers.num_timesteps, (B,),
                                    generator=g, device=dev)}
    noise = torch.randn((B, r, r, 3), generator=g, device=dev)
    step = make_train_step(eng, ema_start=0)
    want_k1 = K1_PER_FORWARD[variant]
    out = {}
    net = build_unet(model_opt, device=dev, seed=seed)
    if variant != "fastdiffsr":
        randomize_params(net, seed + 6)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    for arm in ("reference", "k1"):
        net.load_state_dict(start)
        state = create_train_state(net, torch.optim.Adam(
            net.parameters(), lr=lr, betas=(0.9, 0.999), eps=STEP_ADAM_EPS))
        kernels.reset_launch_counts()
        with (reference_norm() if arm == "reference"
              else contextlib.nullcontext()):
            _, m = step(state, batch, None, noise=noise, **draws)
        torch.cuda.synchronize()
        out[arm] = {"loss": m["l_pix"].item(),
                    "grad_norm": m["grad_norm"].item(),
                    "k1": kernels.LAUNCHES["gn_swish"],
                    "grads": {k: p.grad.clone()
                              for k, p in net.named_parameters()},
                    "params": {k: p.detach().clone()
                               for k, p in net.named_parameters()}}
        del state
    del net, start
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
          and a["k1"] == 0 and b["k1"] == want_k1)
    label = "" if variant == "fastdiffsr" else f" {variant}"
    weights = "" if variant == "fastdiffsr" else ", randomized weights"
    print(f"[train step{label}] {card} | full width B={B} {r}x{r} f32, "
          f"dropout off{weights}, injected {'+'.join(draws)}+noise, K1 "
          f"norms on gn_swish_reference vs K1: loss "
          f"{a['loss']:.6f} vs {b['loss']:.6f} (rel {d_loss:.3g}), grad_norm "
          f"{a['grad_norm']:.6g} vs {b['grad_norm']:.6g} (rel {d_gn:.3g}), "
          f"max per-tensor |dgrad|/max|g| {d_grad:.3g} (max |dgrad| "
          f"{dg_abs:.3g}), params after one Adam step (eps {STEP_ADAM_EPS}) "
          f"max |d| {d_par / lr:.3g} lr (tol {STEP_TOL['param']} lr; slope "
          f"bound lr*max|dgrad|/eps = {dg_abs / STEP_ADAM_EPS:.3g} lr; "
          f"{moved:.3g} of elements moved by more than the tol) | K1 "
          f"launches {a['k1']} / {b['k1']} (want 0 / {want_k1}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    del out, a, b
    torch.cuda.empty_cache()
    return {"variant": variant, "rel_loss": d_loss, "rel_grad_norm": d_gn,
            "rel_grad": d_grad, "max_abs_grad_gap": dg_abs,
            "adam_eps": STEP_ADAM_EPS, "param_max_over_lr": d_par / lr,
            "share_moved_over_tol": moved, "ok": ok}, ok


def evals_per_image(cfg) -> int:
    """UNet evals per sampled image of a config's val sampler."""
    import numpy as np
    T = int(cfg["model"]["beta_schedule"]["val"]["n_timestep"])
    diff = cfg["model"].get("diffusion") or {}
    if (diff.get("sampler") or "ancestral") == "ancestral":
        return T
    steps = int(diff.get("ddim_steps") or T)
    return len(np.unique(np.linspace(0, T - 1, steps).round()))


def phase_train(cfg, card, seed, steps=TRAIN_STEPS, val_images=VAL_IMAGES,
                sampler=None, lpips=False, val_freq=10 ** 9):
    """cli.sr_mfe -p train then -p val, on CUDA at full width, for the
    config's variant; ``sampler`` ({sampler, ddim_steps}) overrides the
    val sampler. With ``lpips``, -p val runs with an LPIPS weight pack
    made from ``seed`` and must report LPIPS computed on the card.
    ``val_freq`` <= ``steps`` validates inside the training run too (on
    cuDNN's heuristics, which the CLI switches to around it)."""
    import numpy as np
    import torch

    from fastdiffsr_tpu_torch import metrics
    from fastdiffsr_tpu_torch.cli import sr_mfe
    from fastdiffsr_tpu_torch.lpips_torch import random_pack
    from fastdiffsr_tpu_torch.cli.infer import build_unet
    from fastdiffsr_tpu_torch.data import write_pack
    from fastdiffsr_tpu_torch.ops import fused_conv, kernels
    from fastdiffsr_tpu_torch.train import create_train_state, make_optimizer
    from fastdiffsr_tpu_torch.train.checkpoint import load_state
    dev = torch.device("cuda")
    variant = cfg["model"]["which_model_G"]
    label = "" if variant == "fastdiffsr" else f" {variant}"
    work = os.path.join(ROOT, "build", "smoke")
    ds = cfg["datasets"]["train"]
    droot = write_pack(os.path.join(work, f"train_pack_{seed}"),
                       TRAIN_IMAGES, seed + 7, int(ds["l_resolution"]),
                       int(ds["r_resolution"]))
    cfg = json.loads(json.dumps(cfg))
    cfg["name"] = f"chip_smoke_train{label.replace(' ', '_')}"
    cfg["datasets"]["train"].update(dataroot=droot, datatype="npy",
                                    batch_size=B_TRAIN)
    cfg["datasets"]["val"].update(dataroot=droot, datatype="npy",
                                  data_len=val_images)
    cfg["train"].update(n_iter=steps, val_freq=val_freq,
                        save_checkpoint_freq=10 ** 9, print_freq=8)
    if sampler:
        cfg["model"]["diffusion"].update(sampler)
    T = int(cfg["model"]["beta_schedule"]["val"]["n_timestep"])
    run_cfg = os.path.join(work, f"{cfg['name']}.json")
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
    # launches of the validations inside the run, whose val set config.parse
    # cuts to 13 images for -p train, as the reference does
    in_evals = (evals_per_image(cfg) * min(13, TRAIN_IMAGES)
                * (steps // val_freq))
    fused_val = variant == "fastdiffsr"
    want_k1 = K1_PER_FORWARD[variant] * (steps + (0 if fused_val
                                                  else in_evals))
    ckpt = summary["checkpoint"]
    payload = torch.load(os.path.join(ckpt, "state.pt"), map_location=dev,
                         weights_only=True)
    # the initial weights (the run's seed) differ from the trained ones
    # in every tensor the steps changed; the reload must overwrite them
    net = build_unet(cfg["model"], device=dev, seed=seed)
    changed = sum(not torch.equal(v, payload["params"][k])
                  for k, v in net.state_dict().items())
    state = load_state(ckpt, create_train_state(
        net, make_optimizer(net.parameters(), cfg["train"]["optimizer"])),
        variant)
    opt_sd = state.optimizer.state_dict()["state"]
    bit_equal = (
        state.step == steps == payload["step"]
        and all(torch.equal(v, payload["params"][k])
                for k, v in net.state_dict().items())
        and all(torch.equal(v, payload["ema_params"][k])
                for k, v in state.ema_params.items())
        and all(torch.equal(opt_sd[i][n], payload["opt_state"]["state"][i][n])
                for i in opt_sd for n in ("exp_avg", "exp_avg_sq")))
    del state, net, payload
    rate = summary["steady_steps_per_s"]
    train_ok = (summary["steps"] == steps and len(losses) == steps
                and all(map(math.isfinite, losses)) and changed > 0
                and bit_equal and launches["gn_swish"] == want_k1
                and launches["fused_gn_swish_conv3x3"]
                == (49 * in_evals if fused_val else 0)
                and launches["channel_stats"]
                == (4 * in_evals if fused_val else 0)
                and rate is not None)
    print(f"[train{label}] {card} | cli.sr_mfe -p train cuda f32 full width, "
          f"B={B_TRAIN}, T={T}, TF32 off, {steps} steps: l_pix "
          f"first {losses[0]:.4f} last {losses[-1]:.4f} mean "
          f"{sum(losses) / len(losses):.4f}, {changed} param tensors changed,"
          f" checkpoint {os.path.basename(ckpt)} reloads bit-equal "
          f"{bit_equal} | K1 launches {launches['gn_swish']} (want {want_k1}"
          f"), K3 {launches['fused_gn_swish_conv3x3']}, K2 "
          f"{launches['channel_stats']} | steady {rate:.3f} steps/s "
          f"({rate * B_TRAIN:.2f} img/s) excluding the first step; wall "
          f"{wall:.1f} s | peak {peak_gib:.2f} GiB "
          f"{'ok' if train_ok else 'FAIL'}", flush=True)
    in_val = summary["last_validation"]
    if in_evals:
        print(f"[train{label} in-run validation] {card} | every {val_freq} "
              f"steps, {min(13, TRAIN_IMAGES)} images, "
              f"{evals_per_image(cfg)} evals each, on cuDNN's heuristics: "
              f"{in_val['avg_time']:.3f} s per image after the first, psnr "
              f"{in_val['psnr']:.4f}", flush=True)
    k1_launches = launches["gn_swish"]

    cfg["path"]["resume_state"] = ckpt
    val_cfg = os.path.join(work, f"{cfg['name']}_val.json")
    with open(val_cfg, "w") as f:
        json.dump(cfg, f)
    if lpips:
        pack = os.path.join(work, f"lpips_alex_{seed}.npz")
        np.savez(pack, **random_pack(seed + 8))
        os.environ["FASTDIFFSR_TPU_LPIPS"] = pack
    gc.collect()            # the train run's state, before the val peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    routes0 = dict(fused_conv.ROUTE_TAKEN)
    t0 = time.time()
    res = sr_mfe.main(["-p", "val", "-c", val_cfg, "--device", "cuda",
                       "--seed", str(seed)])
    torch.cuda.synchronize()
    own_phases_regime()
    vwall = time.time() - t0
    vpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(kernels.LAUNCHES)
    routes = {k: n - routes0[k] for k, n in fused_conv.ROUTE_TAKEN.items()}
    n_eval = evals_per_image(cfg) * val_images
    if variant == "fastdiffsr":
        want = {"fused_gn_swish_conv3x3": 49 * n_eval,
                "channel_stats": 4 * n_eval, "gn_swish": 0}
        want_routes = {"wgmma": 0, "cuda_cores": 49 * n_eval}
    else:
        want = {"fused_gn_swish_conv3x3": 0, "channel_stats": 0,
                "gn_swish": K1_PER_FORWARD[variant] * n_eval}
        want_routes = {"wgmma": 0, "cuda_cores": 0}
    val_ok = (math.isfinite(res.get("psnr", math.nan))
              and math.isfinite(res.get("ssim", math.nan))
              and launches == want and routes == want_routes)
    lpips_ms = None
    if lpips:
        # LPIPS of one validation image (an SR/HR pair at the config's
        # size) on the module -p val built, timed from the host: the call
        # returns a float, so it waits for the card
        net = metrics._LPIPS.get("cuda")
        on_card = net is not None and net.shift.device.type == "cuda"
        # -p val from a checkpoint writes into that run's directory
        results = os.path.join(os.path.dirname(os.path.dirname(ckpt)),
                               "results")
        pair = [metrics.load_img(os.path.join(results, f"0_{k}.png"))
                for k in ("sr", "hr")]
        metrics.calculate_lpips(*pair, device=dev)
        torch.cuda.synchronize()
        t1 = time.time()
        for _ in range(LPIPS_REPS):
            metrics.calculate_lpips(*pair, device=dev)
        lpips_ms = (time.time() - t1) / LPIPS_REPS * 1e3
        l_ok = on_card and math.isfinite(res.get("lpips", math.nan))
        val_ok &= l_ok
        print(f"[lpips] {card} | -p val lpips {res.get('lpips', math.nan):.6f}"
              f" on the card: {on_card}, LPIPS-alex (synthetic pack from "
              f"--seed) {lpips_ms:.3f} ms per {pair[0].shape[0]}x"
              f"{pair[0].shape[1]} image pair, host-timed over "
              f"{LPIPS_REPS} calls {'ok' if l_ok else 'FAIL'}", flush=True)
    diff = cfg["model"].get("diffusion") or {}
    samp = diff.get("sampler") or "ancestral"
    s_img = res.get("avg_time", res.get("avg_time_incl_setup", math.nan))
    steady = "after the first" if "avg_time" in res else "incl. set-up"
    print(f"[val{label}] {card} | cli.sr_mfe -p val cuda f32 "
          f"{'fused' if variant == 'fastdiffsr' else 'plain'} from "
          f"{os.path.basename(ckpt)}, {val_images} images, {samp} "
          f"{evals_per_image(cfg)} evals of T={T}: psnr "
          f"{res.get('psnr', math.nan):.4f} ssim {res.get('ssim', math.nan):.4f}"
          f" | K3 launches {launches['fused_gn_swish_conv3x3']} (want "
          f"{want['fused_gn_swish_conv3x3']}, on the float32 CUDA-core "
          f"kernel: {routes['cuda_cores']}), K2 {launches['channel_stats']} "
          f"(want {want['channel_stats']}), K1 {launches['gn_swish']} (want "
          f"{want['gn_swish']}) | {s_img:.3f} s per image {steady}, wall "
          f"{vwall:.1f} s ({vwall / val_images:.3f} s per image) | peak "
          f"{vpeak:.2f} GiB {'ok' if val_ok else 'FAIL'}", flush=True)
    detail = {"variant": variant, "steps": steps, "batch": B_TRAIN, "T": T,
              "l_pix": losses, "steady_steps_per_s": rate, "wall_s": wall,
              "peak_gib": peak_gib, "k1_launches": k1_launches,
              "bit_equal": bit_equal, "val": res, "val_sampler": samp,
              "val_evals_per_image": evals_per_image(cfg),
              "val_wall_s": vwall, "val_peak_gib": vpeak,
              "val_launches": launches, "val_routes": routes,
              "val_lpips_ms": lpips_ms, "in_run_validation": in_val}
    return detail, k1_launches, train_ok and val_ok


def run_infer(cfg, name, card, args, tag, want, want_routes=None):
    """cli.infer on ``cfg`` (written as ``name``) with the counters set to
    0 just before and read just after; checks the launch counts against
    ``want`` (and K3's routes) and prints one line."""
    import torch

    from fastdiffsr_tpu_torch.cli import infer
    from fastdiffsr_tpu_torch.ops import fused_conv, kernels
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    run_cfg = os.path.join(work, f"{name}.json")
    with open(run_cfg, "w") as f:
        json.dump(cfg, f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    routes0 = dict(fused_conv.ROUTE_TAKEN)
    t0 = time.time()
    summary = infer.main(["-c", run_cfg, "--device", "cuda", *args])
    torch.cuda.synchronize()
    own_phases_regime()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    routes = {k: n - routes0[k] for k, n in fused_conv.ROUTE_TAKEN.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_img = int(cfg["datasets"]["val"]["data_len"])
    batch = int(cfg["datasets"]["val"]["batch_size"])
    samp = (cfg["model"].get("diffusion") or {}).get("sampler") or "ancestral"
    T = int(cfg["model"]["beta_schedule"]["val"]["n_timestep"])
    pngs = [p for p in os.listdir(summary["results"]) if p.endswith(".png")]
    ok = (launches == want and summary["images"] == n_img
          and len(pngs) == n_img
          and (want_routes is None or routes == want_routes))
    lat = summary["mean_latency_s"]
    lats = sorted(summary["latencies_s"])
    if lat:
        rate = (f"steady {1.0 / lat:.3f} img/s, {lat:.4f} s/img (per "
                f"image over {len(lats)} steady images, each its batch's "
                f"mean: min {lats[0]:.4f}, median {lats[len(lats) // 2]:.4f}"
                f", max {lats[-1]:.4f})")
    else:
        lat = summary["first_batch_s_per_image"]
        rate = f"{lat:.4f} s/img incl. set-up (one batch)"
    print(f"[{tag}] {card} | cli.infer cuda {' '.join(args)}, {samp} "
          f"{evals_per_image(cfg)} evals of T={T}, batches of {batch}: "
          f"{summary['images']} images finite, {len(pngs)} PNGs | launches "
          f"K3 {launches['fused_gn_swish_conv3x3']} (want "
          f"{want['fused_gn_swish_conv3x3']}; {routes['wgmma']} on wgmma, "
          f"{routes['cuda_cores']} on CUDA cores), K2 "
          f"{launches['channel_stats']} (want {want['channel_stats']}), K1 "
          f"{launches['gn_swish']} (want {want['gn_swish']}) | {rate}; wall "
          f"{wall:.1f} s | peak {peak_gib:.2f} GiB {'ok' if ok else 'FAIL'}",
          flush=True)
    return {"launches": launches, "routes": routes, "s_per_img": lat,
            "img_per_s": 1.0 / lat, "steady": bool(summary["mean_latency_s"]),
            "latencies_s": lats,
            "wall_s": wall, "peak_gib": peak_gib,
            "results": summary["results"]}, ok


def sampler_gains(alphas_cumprod, steps: int, sampler: str):
    """Per step of DDIM (eta 0) or DPM-Solver++(2M) on the schedule's
    timestep subsequence, the gain from an error in the denoiser's noise
    output to the next x, before the x0 clip: DDIM |sqrt(1-a') -
    sqrt(a'(1-a)/a)|, DPM |coef_D| sqrt((1-a)/a) (|w_cur| + |w_prev|)
    (a = alpha-bar at t, a' at the next t, 1 after the last). Written from
    the update rules, apart from the engine's code. The clip of x0 can
    only shrink an error, so this is an upper bound of the step's own
    gain; what the UNet makes of an error in its input is not in it."""
    import numpy as np
    ac = np.asarray(alphas_cumprod, np.float64)
    T = len(ac)
    ts = np.unique(np.linspace(0, T - 1, steps).round().astype(np.int64))
    ts = ts[::-1]
    t_next = np.append(ts[1:], -1)
    a = ac[ts]
    a_n = np.where(t_next >= 0, ac[np.maximum(t_next, 0)], 1.0)
    to_x0 = np.sqrt((1 - a) / a)
    if sampler == "ddim":
        return np.abs(np.sqrt(1 - a_n) - np.sqrt(a_n) * to_x0)
    coef_d = np.sqrt(a_n) - np.sqrt(a) * np.sqrt(1 - a_n) / np.sqrt(1 - a)
    lam = 0.5 * np.log(a / (1 - a))
    lam_n = np.append(lam[1:], np.inf)
    h = lam_n - lam
    w = np.ones(len(ts))
    for k in range(1, len(ts)):
        if np.isfinite(h[k]):       # the final step is first order
            w[k] = 1.0 + 1.0 / (h[k - 1] / h[k])   # |w_cur| + |w_prev|
    return np.abs(coef_d) * to_x0 * w


def phase_samplers(cfg, card, seed):
    """10. DDIM and DPM-Solver++ through cli.infer on the fused bf16
    forward (K3 on wgmma, K2), then both samplers on the fused f32
    forward against the plain UNet on gn_swish_reference."""
    import torch

    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr_fused import (
        fused_apply, prepare_fused_params)
    detail, ok = {}, True
    n_eval = SAMPLER_STEPS * SERVE_BATCHES
    for sampler in ("ddim", "dpm"):
        c = json.loads(json.dumps(cfg))
        c["name"] = f"chip_smoke_{sampler}"
        c["model"]["diffusion"].update(sampler=sampler,
                                       ddim_steps=SAMPLER_STEPS)
        detail[sampler], s_ok = run_infer(
            c, c["name"], card, ["--dtype", "bf16", "--seed", str(seed)],
            f"serve {sampler} {SAMPLER_STEPS} steps",
            {"fused_gn_swish_conv3x3": 49 * n_eval,
             "channel_stats": 4 * n_eval, "gn_swish": 0},
            {"wgmma": 49 * n_eval, "cuda_cores": 0})
        ok &= s_ok

    dev = torch.device("cuda")
    net = unet_from_config(cfg["model"]["unet"], device=dev, seed=seed)
    fp = prepare_fused_params(net, torch.float32)
    fp_bf16 = prepare_fused_params(net, torch.bfloat16)
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(
                              cfg["model"]["beta_schedule"]["val"],
                              device=dev))
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    shape = (B_SAMPLER, 256, 256, 3)
    cond = torch.rand(shape, generator=g, device=dev) * 2 - 1
    init = torch.randn(shape, generator=g, device=dev)
    for name in ("ddim", "dpm"):
        fn = getattr(eng, f"sample_{name}")
        got = fn(lambda x, lv: fused_apply(fp, x, lv), cond,
                 steps=SAMPLER_STEPS, init_noise=init)
        with reference_norm():
            want = fn(lambda x, lv: net(x, lv), cond, steps=SAMPLER_STEPS,
                      init_noise=init)
        control = fn(lambda x, lv: fused_apply(fp_bf16, x, lv), cond,
                     steps=SAMPLER_STEPS, init_noise=init)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_control = (control - want).abs().max().item()
        gains = sampler_gains(eng.buffers.alphas_cumprod.cpu().numpy(),
                              SAMPLER_STEPS, name)
        tol = SAMPLER_EPS_GAP * float(gains.sum())
        row_ok = (err <= tol < err_control
                  and bool(torch.isfinite(got).all()))
        ok &= row_ok
        print(f"[sampler {name}] {card} | sample_{name} B={B_SAMPLER} "
              f"256x256, {SAMPLER_STEPS} steps from the same initial noise: "
              f"fused f32 (K3 on CUDA cores, K2) vs plain UNet on "
              f"gn_swish_reference max|d|={err:.3g} (tol {tol:.3g} = "
              f"{SAMPLER_EPS_GAP} per eval x the steps' summed gain "
              f"{gains.sum():.4g}, largest {gains.max():.4g}); control, "
              f"fused bf16 vs the same plain run, max|d|={err_control:.3g} "
              f"(must exceed the tol) {'ok' if row_ok else 'FAIL'}",
              flush=True)
        detail[f"{name}_fused_vs_plain"] = {
            "max_abs_err": err, "tol": tol,
            "control_bf16_max_abs_err": err_control}
    del net, fp, fp_bf16
    torch.cuda.empty_cache()
    return detail, ok


def variant_cfg(variant, kind="train_64_256"):
    """The port's ``configs/sr_{variant}_{kind}.json``."""
    from fastdiffsr_tpu_torch.config import load_json_config
    return load_json_config(os.path.join(
        ROOT, "fastdiffsr_tpu_torch", "configs",
        f"sr_{variant}_{kind}.json"))


def phase_k1_variants(done_rows, card, seed):
    """11. K1 against its plain version at every distinct K1 shape of one
    SR3 (ddpm) and one guided (gdp) training forward at batch 4, 256x256,
    f32 and bf16 (shapes phase 6 measured are not measured again), then
    in f32 at batch 1, the batch of their ``-p val`` runs, and K1's time
    per forward of each net at both batches."""
    import torch

    from fastdiffsr_tpu_torch.cli.infer import build_unet
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 12)
    rows = {(r["H"], r["W"], r["C"], r["groups"], r["dtype"], r["B"]): r
            for r in done_rows}
    detail, ok = {}, True
    for variant in ("ddpm", "gdp"):
        cfg = variant_cfg(variant)
        net = build_unet(cfg["model"], device=dev, seed=seed)
        T = int(cfg["model"]["beta_schedule"]["train"]["n_timestep"])
        x = torch.randn((B_TRAIN, 256, 256, 6), generator=g, device=dev)
        level = torch.randint(0, T, (B_TRAIN,), generator=g,
                              device=dev).float()
        sigs, strided = record_k1(net, x, level)
        del net, x
        torch.cuda.empty_cache()
        n_k1 = sum(sigs.values())
        shapes_ok = n_k1 == K1_PER_FORWARD[variant] and strided == 0
        ok &= shapes_ok
        new = {sg: n for sg, n in sigs.items()
               if (*sg, "f32", B_TRAIN) not in rows}
        print(f"[shapes {variant}] {card} | one training forward: {n_k1} "
              f"K1 calls in {len(sigs)} shapes (want "
              f"{K1_PER_FORWARD[variant]}), {len(new)} not measured yet, "
              f"{strided} K1 inputs not contiguous NHWC "
              f"{'ok' if shapes_ok else 'FAIL'}", flush=True)
        new_rows, k_ok = phase_k1(new, B_TRAIN, REPS, card, seed)
        new_b1 = {sg: n for sg, n in sigs.items()
                  if (*sg, "f32", 1) not in rows}
        b1_rows, b1_ok = phase_k1(new_b1, 1, REPS, card, seed,
                                  dtypes=("f32",))
        ok &= k_ok and b1_ok
        rows.update({(r["H"], r["W"], r["C"], r["groups"], r["dtype"],
                      r["B"]): r for r in new_rows + b1_rows})
        tot = {}
        for dt, B in (("f32", B_TRAIN), ("bf16", B_TRAIN), ("f32", 1)):
            key = f"{dt}_b{B}"
            tot[key] = {k: sum(rows[(*sg, dt, B)][k] * n
                               for sg, n in sigs.items())
                        for k in ("ms", "plain_ms", "bound_ms",
                                  "two_call_library_ms", "wall_ms")}
            tot[key]["max_abs_err"] = max(rows[(*sg, dt, B)]["max_abs_err"]
                                          for sg in sigs)
            tot[key]["launches"] = sum(
                rows[(*sg, dt, B)]["launches_per_call"] * n
                for sg, n in sigs.items())
            print(f"[K1 total {variant} {dt} B={B}] {card} | per forward, "
                  f"device: kernel {tot[key]['ms']:.3f} ms, plain "
                  f"{tot[key]['plain_ms']:.3f} ms, F.group_norm+F.silu "
                  f"{tot[key]['two_call_library_ms']:.3f} ms | wall: kernel "
                  f"{tot[key]['wall_ms']:.3f} ms | bound "
                  f"{tot[key]['bound_ms']:.3f} ms | "
                  f"{floor_line(tot[key]['launches'])}", flush=True)
        detail[variant] = {"shapes": [list(sg) + [n] for sg, n in
                                      sorted(sigs.items())],
                           "rows": new_rows + b1_rows, "total": tot}
    return detail, ok


def phase_variants(card, seed, pack):
    """12. For ddpm, tesr and gdp: a train step on K1 against one on
    gn_swish_reference (randomized weights), cli.sr_mfe -p train at full
    width and -p val on one image; then cli.infer of the ddpm config in
    bf16 on the plain forward with DPM-Solver++."""
    detail, ok = {}, True
    k1 = 0
    for variant in ("ddpm", "tesr", "gdp"):
        cfg = variant_cfg(variant)
        detail[f"{variant}_step"], s_ok = phase_train_parity(
            cfg, B_TRAIN, card, seed)
        # gdp also validates inside its run: timed cuDNN algorithms took
        # 3x the heuristics' time for its batch-1 evals (PERF.md)
        detail[variant], k1_train, t_ok = phase_train(
            cfg, card, seed, steps=VARIANT_STEPS, val_images=1,
            sampler=VARIANT_VAL[variant],
            val_freq=VARIANT_STEPS if variant == "gdp" else 10 ** 9)
        ok &= s_ok and t_ok
        k1 += k1_train + detail[variant]["val_launches"]["gn_swish"]
    cfg = variant_cfg("ddpm", "test_64_256")
    cfg["name"] = "chip_smoke_ddpm_infer"
    cfg["datasets"]["val"].update(dataroot=pack, datatype="npy",
                                  batch_size=4, data_len=4)
    cfg["model"]["diffusion"].update(sampler="dpm", ddim_steps=20)
    detail["ddpm_infer_bf16"], i_ok = run_infer(
        cfg, cfg["name"], card,
        ["--dtype", "bf16", "--plain", "--seed", str(seed)],
        "infer ddpm bf16 plain dpm 20 steps",
        {"fused_gn_swish_conv3x3": 0, "channel_stats": 0,
         "gn_swish": K1_PER_FORWARD["ddpm"] * 20})
    ok &= i_ok
    k1 += detail["ddpm_infer_bf16"]["launches"]["gn_swish"]
    return detail, k1, ok


def phase_512_kernels(card, seed):
    """13. K3 (f32, bf16) and K2 against their plain versions at every
    signature of one 128->512 eval of configs/sr_fastdiffsr_infer_x4.json
    at batch 1 (recorded from a fused f32 forward)."""
    import torch

    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr_fused import \
        prepare_fused_params
    cfg = variant_cfg("fastdiffsr", "infer_x4")
    r = int(cfg["datasets"]["val"]["r_resolution"])
    dev = torch.device("cuda")
    net = unet_from_config(cfg["model"]["unet"], device=dev, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    x = torch.randn((1, r, r, 6), generator=g, device=dev)
    level = torch.rand((1,), generator=g, device=dev)
    k3_sigs, k2_sigs = record_calls(prepare_fused_params(net, torch.float32),
                                    x, level)
    del net, x
    torch.cuda.empty_cache()
    n_k3, n_k2 = sum(k3_sigs.values()), sum(k2_sigs.values())
    ok = n_k3 == 49 and n_k2 == 4
    print(f"[shapes {r}] {card} | one 128->{r} eval: {n_k3} K3 calls in "
          f"{len(k3_sigs)} shapes, {n_k2} K2 calls in {len(k2_sigs)} shapes "
          f"(want 49 and 4) {'ok' if ok else 'FAIL'}", flush=True)
    k3_rows, k3_ok = phase_k3(k3_sigs, 1, REPS, card, seed,
                              dtypes=("f32", "bf16"))
    k2_rows, k2_ok = phase_k2(k2_sigs, 1, REPS, card, seed)
    print_k3_totals(k3_rows, card, f" {r}x{r}")
    print_k2_totals(k2_rows, card, f" {r}x{r}")
    return {"k3": k3_rows, "k2": k2_rows}, ok and k3_ok and k2_ok


def phase_512_infer(card, seed):
    """14. cli.infer of configs/sr_fastdiffsr_infer_x4.json (128->512,
    T=20, batch 1) on a synthetic pack from ``seed``: with no --dtype
    (float32, K3 on the CUDA cores), then --dtype bf16 (K3 on wgmma)."""
    from fastdiffsr_tpu_torch.data import write_pack
    cfg = variant_cfg("fastdiffsr", "infer_x4")
    ds = cfg["datasets"]["val"]
    l_res, r_res = int(ds["l_resolution"]), int(ds["r_resolution"])
    work = os.path.join(ROOT, "build", "smoke")
    pack = write_pack(os.path.join(work, f"pack_{l_res}_{r_res}_{seed}"),
                      INFER_512_IMAGES, seed + 13, l_res, r_res)
    ds.update(dataroot=pack, datatype="npy", batch_size=1,
              data_len=INFER_512_IMAGES)
    n_eval = int(cfg["model"]["beta_schedule"]["val"]["n_timestep"]) * \
        INFER_512_IMAGES
    detail, ok = {}, True
    for dt, flags, route in (("f32", [], "cuda_cores"),
                             ("bf16", ["--dtype", "bf16"], "wgmma")):
        cfg["name"] = f"chip_smoke_infer_{r_res}_{dt}"
        detail[dt], i_ok = run_infer(
            cfg, cfg["name"], card, [*flags, "--seed", str(seed)],
            f"infer {l_res}->{r_res} {dt}",
            {"fused_gn_swish_conv3x3": 49 * n_eval,
             "channel_stats": 4 * n_eval, "gn_swish": 0},
            {"wgmma": 0, "cuda_cores": 0, route: 49 * n_eval})
        ok &= i_ok
    return detail, ok


def fid_reference(mu1, s1, mu2, s2) -> float:
    """The Frechet distance in float64 by eigenvalues, apart from scipy's
    sqrtm: Tr (S1 S2)^(1/2) is the sum of the square roots of the
    eigenvalues of S1^(1/2) S2 S1^(1/2). Features with no variance in
    either set add nothing and are left out."""
    import numpy as np
    live = (np.diag(s1) > 0) | (np.diag(s2) > 0)
    s1, s2 = s1[np.ix_(live, live)], s2[np.ix_(live, live)]
    w, v = np.linalg.eigh(s1)
    r = (v * np.sqrt(np.clip(w, 0, None))) @ v.T
    e = np.linalg.eigvalsh(r @ s2 @ r)
    d = mu1 - mu2
    return float(d @ d + np.trace(s1) + np.trace(s2)
                 - 2 * np.sqrt(np.clip(e, 0, None)).sum())


def write_fid_dirs(root, n, seed):
    """Two directories of ``n`` 256x256 PNGs from ``seed``: HR tiles
    (``data/synth.py::write_pack``'s recipe, made on the card) and their
    x4 bicubic baseline; the PNGs are encoded on 8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    import torch.nn.functional as F

    from fastdiffsr_tpu_torch.metrics import save_img
    dirs = [os.path.join(root, d) for d in ("hr", "bicubic")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def u8(t):
        return (t.clamp(0, 1) * 255).round().to(torch.uint8).permute(
            0, 2, 3, 1).cpu().numpy()
    with ThreadPoolExecutor(8) as pool:
        for start in range(0, n, 512):
            small = torch.rand((min(512, n - start), 3, 16, 16), generator=g,
                               device="cuda")
            hr = F.interpolate(small, size=256, mode="bicubic",
                               align_corners=False)
            lr = F.interpolate(hr, size=64, mode="bicubic", antialias=True,
                               align_corners=False)
            sr = F.interpolate(lr, size=256, mode="bicubic",
                               align_corners=False)
            for d, imgs in zip(dirs, (u8(hr), u8(sr))):
                list(pool.map(lambda j: save_img(imgs[j], os.path.join(
                    d, f"{start + j:05d}.png")), range(len(imgs))))
    return dirs


def phase_fid(card, seed):
    """15. cli.fid --device cuda over two directories of FID_IMAGES PNGs
    (``write_fid_dirs``) with an Inception weight pack made from ``seed``.
    The extractor, decoding and Frechet-distance calls are timed apart;
    the card's pool3 features are held against the CPU's on
    FID_CHECK_IMAGES images, and the FID against ``fid_reference``."""
    import numpy as np

    from fastdiffsr_tpu_torch.cli import fid
    from fastdiffsr_tpu_torch.metrics import load_img
    from fastdiffsr_tpu_torch.models import inception
    work = os.path.join(ROOT, "build", "smoke")
    t0 = time.time()
    fake, real = write_fid_dirs(os.path.join(work, f"fid_{seed}"),
                                FID_IMAGES, seed + 15)
    write_s = time.time() - t0
    inc_pack = os.path.join(work, f"inception_fid_{seed}.npz")
    np.savez(inc_pack, **inception.random_pack(seed + 14))
    os.environ["FASTDIFFSR_TPU_INCEPTION"] = inc_pack
    built, stats = [], []
    secs = {"extract": 0.0, "features": 0.0, "frechet": 0.0}
    load, features, frechet = (inception.load_default, fid.directory_features,
                               fid.frechet_distance)

    def timed(key, fn):
        def call(*a, **kw):
            t = time.time()
            out = fn(*a, **kw)
            secs[key] += time.time() - t
            return out
        return call

    def record_load(device="cpu"):
        built.append(load(device))
        return timed("extract", built[-1])

    def record_frechet(*a):
        stats.append(a)
        return frechet(*a)

    inception.load_default = record_load
    fid.directory_features = timed("features", features)
    fid.frechet_distance = timed("frechet", record_frechet)
    try:
        t0 = time.time()
        value = fid.main([fake, real, "--device", "cuda"])
        fid_s = time.time() - t0
    finally:
        inception.load_default = load
        fid.directory_features, fid.frechet_distance = features, frechet
    on_card = [e.device.type for e in built] == ["cuda"]
    want = fid_reference(*stats[0])
    f_err = abs(value - want) / abs(want)
    x = np.stack([load_img(os.path.join(real, f"{j:05d}.png"))
                  for j in range(FID_CHECK_IMAGES)]).astype(np.float32) / 255
    cpu = load("cpu")(x)
    feat_err = float(np.abs(built[0](x) - cpu).max())
    feat_tol = FID_FEAT_TOL * float(np.abs(cpu).max())
    ok = (on_card and math.isfinite(value) and value > 0
          and f_err <= FID_RTOL and feat_err <= feat_tol)
    n = 2 * FID_IMAGES
    print(f"[fid] {card} | cli.fid --device cuda over 2 x {FID_IMAGES} "
          f"256x256 PNGs (HR tiles against their x4 bicubic baseline; "
          f"synthetic Inception pack from --seed): FID {value:.6g}, "
          f"eigenvalue reference {want:.6g} (rel err {f_err:.2g}, tol "
          f"{FID_RTOL}); pool3 on the card against the CPU on "
          f"{FID_CHECK_IMAGES} images max|d| {feat_err:.3g} (tol "
          f"{feat_tol:.3g}); extractor on the card: {on_card} | "
          f"{fid_s:.2f} s: extractor {1e3 * secs['extract'] / n:.3f} ms per "
          f"image (batches of 8), with PNG decoding "
          f"{1e3 * secs['features'] / n:.3f} ms per image, Frechet distance "
          f"(scipy sqrtm, host) {secs['frechet']:.2f} s; PNGs written in "
          f"{write_s:.1f} s {'ok' if ok else 'FAIL'}", flush=True)
    return {"value": value, "reference": want, "rel_err": f_err,
            "feature_err": feat_err, "images": n, "seconds": fid_s,
            "extract_ms_per_image": 1e3 * secs["extract"] / n,
            "features_ms_per_image": 1e3 * secs["features"] / n,
            "frechet_s": secs["frechet"], "write_s": write_s}, ok


def write_ediffsr_dirs(root, seed):
    """EDiffSR's LQGT folders under ``root``: ``{train,val}/{hr_256,lr_64}``
    with EDIFFSR_TRAIN_IMAGES and EDIFFSR_VAL_IMAGES PNGs from ``seed``
    (smooth 256x256 HR tiles made on the card, their x4 bicubic LR),
    written with the port's PNG encoder."""
    import torch
    import torch.nn.functional as F

    from fastdiffsr_tpu_torch.metrics import save_img
    g = torch.Generator(device="cuda").manual_seed(seed)

    def u8(t):
        return (t.clamp(0, 1) * 255).round().to(torch.uint8).permute(
            0, 2, 3, 1).cpu().numpy()
    roots = {}
    for split, n in (("train", EDIFFSR_TRAIN_IMAGES),
                     ("val", EDIFFSR_VAL_IMAGES)):
        small = torch.rand((n, 3, 16, 16), generator=g, device="cuda")
        hr = F.interpolate(small, size=256, mode="bicubic",
                           align_corners=False).clamp(0, 1)
        lr = F.interpolate(hr, size=64, mode="bicubic", antialias=True,
                           align_corners=False)
        for sub, imgs in (("hr_256", u8(hr)), ("lr_64", u8(lr))):
            d = os.path.join(root, split, sub)
            os.makedirs(d, exist_ok=True)
            for j, img in enumerate(imgs):
                save_img(img, os.path.join(d, f"{j:04d}.png"))
            roots[(split, sub)] = d
    return roots


def randomize_naf(net, seed: int):
    """randomize_params, then the channel LayerNorms' scales 1 + 0.1 N
    (randomize_params draws beta/gamma, which start at 0 and would leave
    every NAFBlock the identity)."""
    import torch

    from fastdiffsr_tpu_torch.models.nafnet import LayerNorm2d
    randomize_params(net, seed)
    dev = next(net.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, LayerNorm2d):
                m.g.copy_(1.0 + 0.1 * torch.randn(m.g.shape, generator=g,
                                                  device=dev))
    return net


def card_vs_cpu(card, seed):
    """The same port code on the card and on the CPU: a full-width
    NAFNet forward (256x256, batch 2, two t values), a 4-step reverse SDE
    of it with an injected noise sequence (128x128, batch 1), and one
    ConditionalUNet forward (nf 64, depth 4, 64x64, batch 2), each within
    EDIFFSR_CPU_TOL of the largest |value| of the CPU's result."""
    import copy

    import torch

    from fastdiffsr_tpu_torch.diffusion.sde import IRSDE, IRSDEBuffers
    from fastdiffsr_tpu_torch.ediffsr.options import load_yaml
    from fastdiffsr_tpu_torch.models.cond_unet import cond_unet_from_config
    from fastdiffsr_tpu_torch.models.nafnet import nafnet_from_config

    yml = os.path.join(ROOT, "fastdiffsr_tpu_torch", "ediffsr",
                       "options_yml", "setting_mfe_Train_x4.yml")
    with open(yml) as f:
        setting = load_yaml(f.read())["network_G"]["setting"]
    gen = torch.Generator().manual_seed(seed)
    rows, ok = {}, True

    def compare(name, fn_card, fn_cpu, what):
        nonlocal ok
        t0 = time.time()
        with torch.no_grad():
            want = fn_cpu()
            t_cpu = time.time() - t0
            got = fn_card()
            torch.cuda.synchronize()
        err = (got.cpu() - want).abs().max().item()
        ymax = want.abs().max().item()
        tol = EDIFFSR_CPU_TOL * ymax
        good = bool(torch.isfinite(got).all()) and err <= tol
        ok &= good
        print(f"[ediffsr card vs cpu] {card} | {what}: max|d| {err:.3g}, "
              f"max|y| {ymax:.3g}, tol {EDIFFSR_CPU_TOL} * max|y| = "
              f"{tol:.3g}; the CPU took {t_cpu:.1f} s "
              f"{'ok' if good else 'FAIL'}", flush=True)
        rows[name] = {"err": err, "ymax": ymax, "tol": tol, "ok": good}

    net = randomize_naf(nafnet_from_config(setting, device="cpu", seed=seed),
                        seed)
    net_gpu = copy.deepcopy(net).cuda()
    x = torch.rand((2, 256, 256, 3), generator=gen)
    mu = torch.rand((2, 256, 256, 3), generator=gen)
    t = torch.tensor([3.0, 77.0])
    compare("nafnet", lambda: net_gpu(x.cuda(), mu.cuda(), t.cuda()),
            lambda: net(x, mu, t),
            "ConditionalNAFNet width 64 enc [14,1,1,1], 256x256, B=2, "
            "t=(3, 77)")

    sde_cpu = IRSDE(IRSDEBuffers.create(50, 4, "cosine", 0.005))
    sde_gpu = IRSDE(IRSDEBuffers.create(50, 4, "cosine", 0.005,
                                        device="cuda"))
    mu = torch.rand((1, 128, 128, 3), generator=gen)
    xt = mu + torch.randn(mu.shape, generator=gen) * sde_cpu.b.max_sigma
    noise = torch.randn((4, 1, 128, 128, 3), generator=gen)
    compare("reverse_sde",
            lambda: sde_gpu.reverse_sde(net_gpu, xt.cuda(), mu.cuda(),
                                        noise_seq=noise.cuda()),
            lambda: sde_cpu.reverse_sde(net, xt, mu, noise_seq=noise),
            "reverse SDE, 4 steps of that NAFNet with an injected noise "
            "sequence, 128x128, B=1")
    del net, net_gpu

    unet = randomize_naf(cond_unet_from_config(
        {"nf": 64, "depth": 4}, device="cpu", seed=seed), seed)
    unet_gpu = copy.deepcopy(unet).cuda()
    x = torch.rand((2, 64, 64, 3), generator=gen)
    mu = torch.rand((2, 64, 64, 3), generator=gen)
    compare("cond_unet", lambda: unet_gpu(x.cuda(), mu.cuda(), t.cuda()),
            lambda: unet(x, mu, t),
            "ConditionalUNet nf 64 depth 4, 64x64, B=2, t=(3, 77)")
    return rows, ok


def phase_ediffsr(card, seed):
    """EDiffSR on the card through its CLI (``fastdiffsr_tpu_torch.
    ediffsr.train``): training of the paper's full-width NAFNet
    (setting_mfe_Train_x4.yml with only its data roots, niter, val_freq
    and checkpoint frequency changed) with a full T=100 validation at
    its last step; ``--test`` of setting_mfe_Test_x4.yml from that
    checkpoint with the reverse SDE on EDIFFSR_VAL_IMAGES images, then
    the Euler ODE and RK45 on one image each; then ``card_vs_cpu``. No
    kernel of ours is on this path: every launch counter must stay 0."""
    import torch

    from fastdiffsr_tpu_torch.ediffsr import train as etrain
    from fastdiffsr_tpu_torch.ediffsr.options import dump_yaml, load_yaml
    from fastdiffsr_tpu_torch.ops import kernels

    work = os.path.join(ROOT, "build", "smoke", "ediffsr")
    os.makedirs(work, exist_ok=True)
    t0 = time.time()
    roots = write_ediffsr_dirs(os.path.join(work, f"data_{seed}"), seed + 11)
    t_data = time.time() - t0
    ymls = os.path.join(ROOT, "fastdiffsr_tpu_torch", "ediffsr",
                        "options_yml")
    with open(os.path.join(ymls, "setting_mfe_Train_x4.yml")) as f:
        opt = load_yaml(f.read())
    opt["name"] = "chip_smoke_ediffsr"
    for split in ("train", "val"):
        opt["datasets"][split].update(
            dataroot_GT=roots[(split, "hr_256")],
            dataroot_LQ=roots[(split, "lr_64")])
    opt["train"].update(niter=EDIFFSR_STEPS, val_freq=EDIFFSR_STEPS,
                        manual_seed=seed)
    opt["logger"]["save_checkpoint_freq"] = EDIFFSR_STEPS
    train_yml = os.path.join(work, "train.yml")
    with open(train_yml, "w") as f:
        f.write(dump_yaml(opt))
    setting = opt["network_G"]["setting"]
    detail, ok = {"data_s": t_data}, True
    cwd = os.getcwd()
    os.chdir(work)                  # experiments/ and results/ go here
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.time()
        summ = etrain.main(["-opt", train_yml, "--device", "cuda",
                            "--val_images", str(EDIFFSR_IN_RUN_VAL)])
        wall = time.time() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        val = summ["validations"][-1] if summ["validations"] else {}
        rate = summ["steady_steps_per_s"]
        losses = summ["loss"]
        train_ok = (summ["steps"] == EDIFFSR_STEPS and rate is not None
                    and len(losses) == EDIFFSR_STEPS
                    and all(map(math.isfinite, losses))
                    and val.get("images") == EDIFFSR_IN_RUN_VAL
                    and math.isfinite(val.get("psnr", math.nan))
                    and not any(launches.values()))
        ok &= train_ok
        val_s = val.get("seconds", math.nan) / max(val.get("images", 1), 1)
        print(f"[ediffsr train] {card} | ediffsr.train cuda f32, "
              f"ConditionalNAFNet width {setting['width']} enc "
              f"{setting['enc_blk_nums']}, T={opt['sde']['T']}, batch "
              f"{opt['datasets']['train']['batch_size']} 256x256, "
              f"{opt['train']['optimizer']} {opt['train']['lr_G']}, "
              f"{EDIFFSR_STEPS} steps: loss first {losses[0]:.4f} last "
              f"{losses[-1]:.4f} | steady {rate:.3f} steps/s excluding the "
              f"first step; wall {wall:.1f} s | in-run validation at step "
              f"{EDIFFSR_STEPS}: {val.get('images')} images, psnr "
              f"{val.get('psnr', math.nan):.4f}, {val_s:.3f} s per image "
              f"(T={opt['sde']['T']} reverse SDE, batch 1, set-up "
              f"included) | peak {peak:.2f} GiB | kernel launches "
              f"{launches} (none on this path) "
              f"{'ok' if train_ok else 'FAIL'}", flush=True)
        detail["train"] = {"steps": summ["steps"], "steady_steps_per_s": rate,
                           "loss": losses, "wall_s": wall, "peak_gib": peak,
                           "validation": val, "val_s_per_image": val_s,
                           "launches": launches}

        with open(os.path.join(ymls, "setting_mfe_Test_x4.yml")) as f:
            topt = load_yaml(f.read())
        topt["name"] = "chip_smoke_ediffsr_test"
        topt["datasets"]["test"].update(
            dataroot_GT=roots[("val", "hr_256")],
            dataroot_LQ=roots[("val", "lr_64")])
        topt["path"]["pretrain_model_G"] = summ["checkpoint"]
        detail["test"] = {}
        for sampler, n in (("sde", EDIFFSR_VAL_IMAGES), ("ode", 1),
                           ("rk45", 1)):
            topt["datasets"]["test"]["data_len"] = n
            topt["name"] = f"chip_smoke_ediffsr_test_{sampler}"
            test_yml = os.path.join(work, f"test_{sampler}.yml")
            with open(test_yml, "w") as f:
                f.write(dump_yaml(topt))
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.time()
            res = etrain.main(["-opt", test_yml, "--test", "--device", "cuda",
                               "--sampler", sampler])
            wall = time.time() - t0
            launches = dict(kernels.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            pngs = [p for p in os.listdir(os.path.join(
                work, "results", topt["name"])) if p.endswith(".png")
                and not p.endswith("_plot.png")]
            s_img = res.get("avg_time", res.get("first_batch_s"))
            steady = ("after the first" if "avg_time" in res
                      else "set-up included")
            steps = ""
            if sampler == "rk45":
                r = res["rk45"][0]
                steps = (f", RK45 {r['rk45_accepted']} accepted of "
                         f"{r['rk45_trials']} trial steps "
                         f"({6 * r['rk45_trials'] + 1} NAFNet evals)")
            t_ok = (res.get("images") == n and len(pngs) == n
                    and all(math.isfinite(res.get(k, math.nan))
                            for k in ("psnr", "ssim", "ergas"))
                    and not any(launches.values()))
            ok &= t_ok
            print(f"[ediffsr test {sampler}] {card} | ediffsr.train --test "
                  f"cuda f32 --sampler {sampler}, {n} images 64->256: psnr "
                  f"{res.get('psnr', math.nan):.4f} ssim "
                  f"{res.get('ssim', math.nan):.4f} ergas "
                  f"{res.get('ergas', math.nan):.4f}, {len(pngs)} SR PNGs"
                  f"{steps} | {s_img:.3f} s per image {steady}, wall "
                  f"{wall:.1f} s | peak {peak:.2f} GiB "
                  f"{'ok' if t_ok else 'FAIL'}", flush=True)
            detail["test"][sampler] = {**res, "wall_s": wall,
                                       "peak_gib": peak, "s_per_image": s_img,
                                       "launches": launches}
    finally:
        os.chdir(cwd)
    detail["card_vs_cpu"], cmp_ok = card_vs_cpu(card, seed)
    ok &= cmp_ok
    return detail, ok


def write_msi_dirs(root, seed):
    """MSI's PNG folders under ``root`` from ``seed``: ``train/`` with
    MSI_TRAIN_TILES smooth 256x256 tiles (made on the card),
    ``test/class_{k}/`` with MSI_PER_CLASS tiles per class, and the
    odd-size ``single_{h}x{w}.png`` inputs of test_single."""
    import torch
    import torch.nn.functional as F

    from fastdiffsr_tpu_torch.metrics import save_img
    g = torch.Generator(device="cuda").manual_seed(seed)

    def tiles(n, h, w):
        small = torch.rand((n, 3, 16, 16), generator=g, device="cuda")
        img = F.interpolate(small, size=(h, w), mode="bicubic",
                            align_corners=False).clamp(0, 1)
        return (img * 255).round().to(torch.uint8).permute(
            0, 2, 3, 1).cpu().numpy()
    dirs = {"train": os.path.join(root, "train"),
            "test": os.path.join(root, "test")}
    for j, img in enumerate(tiles(MSI_TRAIN_TILES, 256, 256)):
        save_img(img, os.path.join(dirs["train"], f"{j:04d}.png"))
    for k in range(MSI_CLASSES):
        for j, img in enumerate(tiles(MSI_PER_CLASS, 256, 256)):
            save_img(img, os.path.join(dirs["test"], f"class_{k}",
                                       f"{j:04d}.png"))
    for h, w in {MSI_SINGLE_DEFAULT, *MSI_SINGLE.values()}:
        dirs[(h, w)] = os.path.join(root, f"single_{h}x{w}.png")
        save_img(tiles(1, h, w)[0], dirs[(h, w)])
    return dirs


def msi_card_vs_cpu(card, seed):
    """Each full-width MSI model (randomized weights) on the card against
    the same port code on the CPU, on one LR input that is not a window
    multiple (TransENet: a multiple of its 8x8 patches), within
    MSI_CPU_TOL of the CPU's max|y|."""
    import copy
    import types

    import torch

    from fastdiffsr_tpu_torch.msi.main import build_model
    rows, ok = {}, True
    gen = torch.Generator().manual_seed(seed)
    for name in MSI_MODELS:
        net = randomize_params(build_model(name, types.SimpleNamespace(
            scale_factor=4, tiny=False)), seed).eval()
        net_gpu = copy.deepcopy(net).cuda()
        h, w = MSI_CPU_INPUT.get(name, MSI_CPU_INPUT_DEFAULT)
        x = torch.rand((1, h, w, 3), generator=gen)
        t0 = time.time()
        with torch.no_grad():
            want = net(x)
            t_cpu = time.time() - t0
            got = net_gpu(x.cuda()).cpu()
        err = (got - want).abs().max().item()
        ymax = want.abs().max().item()
        good = (bool(torch.isfinite(got).all()) and got.shape == want.shape
                and err <= MSI_CPU_TOL * ymax)
        ok &= good
        print(f"[msi card vs cpu] {card} | {name} full width, LR {h}x{w} "
              f"-> {tuple(got.shape[1:3])}: max|d| {err:.3g}, max|y| "
              f"{ymax:.3g}, tol {MSI_CPU_TOL} * max|y| = "
              f"{MSI_CPU_TOL * ymax:.3g}; the CPU took {t_cpu:.1f} s "
              f"{'ok' if good else 'FAIL'}", flush=True)
        rows[name] = {"err": err, "ymax": ymax, "ok": good}
        del net, net_gpu
    return rows, ok


def msi_reloads_bit_equal(name, ckpt, steps):
    """The checkpoint's state.pt loads into a fresh full-width model and
    Adam through ``load_state`` and every parameter and moment equals
    the payload's; the steps moved the weights off their seeded init."""
    import types

    import torch

    from fastdiffsr_tpu_torch.msi.main import build_model, init_weights
    from fastdiffsr_tpu_torch.train.checkpoint import load_state
    from fastdiffsr_tpu_torch.train.state import create_train_state
    from fastdiffsr_tpu_torch.msi.trainer import ARCH_OF

    payload = torch.load(os.path.join(ckpt, "state.pt"), map_location="cuda",
                         weights_only=True)
    net = init_weights(build_model(name, types.SimpleNamespace(
        scale_factor=4, tiny=False))).cuda()
    init = {k: v.clone() for k, v in net.state_dict().items()}
    state = load_state(ckpt, create_train_state(
        net, torch.optim.Adam(net.parameters())), ARCH_OF[type(net).__name__])
    opt_sd = state.optimizer.state_dict()["state"]
    changed = sum(not torch.equal(v, init[k])
                  for k, v in net.state_dict().items())
    equal = (state.step == steps == payload["step"]
             and all(torch.equal(v, payload["params"][k])
                     for k, v in net.state_dict().items())
             and all(torch.equal(opt_sd[i][n],
                                 payload["opt_state"]["state"][i][n])
                     for i in opt_sd for n in ("exp_avg", "exp_avg_sq")))
    return equal, changed


def phase_msi(card, seed):
    """The five MSI baselines through ``fastdiffsr_tpu_torch.msi.main`` at
    full width (JAX main.py's defaults, x4, crop 256, batch 1) on PNG
    folders from ``seed``: ``--mode train`` for MSI_STEPS steps with the
    epoch-end validation of 8 test tiles (steady steps/s, peak memory, a
    checkpoint that reloads bit-equal), ``--mode validateByClass`` from
    it (PSNR/SSIM/ERGAS and LPIPS on the card from a seeded pack, seconds
    per image with set-up), ``--mode test_single`` on an odd-size PNG;
    then GANTrainer at full width and ``msi_card_vs_cpu``. No kernel of
    ours is on this path: every launch counter must read 0."""
    import types

    import numpy as np
    import torch

    from fastdiffsr_tpu_torch.lpips_torch import random_pack
    from fastdiffsr_tpu_torch.metrics import load_img
    from fastdiffsr_tpu_torch.msi import main as msi_main
    from fastdiffsr_tpu_torch.msi.ndsrgan import GANTrainer
    from fastdiffsr_tpu_torch.ops import kernels

    work = os.path.join(ROOT, "build", "smoke", "msi")
    os.makedirs(work, exist_ok=True)
    t0 = time.time()
    dirs = write_msi_dirs(os.path.join(work, f"data_{seed}"), seed + 17)
    detail, ok = {"data_s": time.time() - t0}, True
    if "FASTDIFFSR_TPU_LPIPS" not in os.environ:
        pack = os.path.join(work, f"lpips_alex_{seed}.npz")
        np.savez(pack, **random_pack(seed + 8))
        os.environ["FASTDIFFSR_TPU_LPIPS"] = pack
    n_test = MSI_CLASSES * MSI_PER_CLASS
    kernels.reset_launch_counts()
    common = ["--scale_factor", "4", "--crop_size", "256",
              "--test_crop_size", "256", "--device", "cuda",
              "--save_dir", os.path.join(work, "runs"),
              "--test_data_dir", dirs["test"]]

    def run(name, *argv):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        out = msi_main.main(["--model_name", name, *argv, *common])
        torch.cuda.synchronize()
        return out, time.time() - t, torch.cuda.max_memory_allocated() / 2**30

    for name in MSI_MODELS:
        row = {}
        summ, wall, peak = run(name, "--mode", "train", "--data_dir",
                               dirs["train"], "--batch_size", "1",
                               "--num_epochs", "1", "--max_steps",
                               str(MSI_STEPS), "--log_freq", "4")
        losses, rate = summ["loss"], summ["steady_steps_per_s"]
        val = summ["validations"][0] if summ["validations"] else {}
        equal, changed = msi_reloads_bit_equal(name, summ["checkpoint"],
                                               MSI_STEPS)
        t_ok = (summ["steps"] == MSI_STEPS and len(losses) == MSI_STEPS
                and all(map(math.isfinite, losses)) and rate is not None
                and math.isfinite(val.get("psnr", math.nan))
                and "lpips" in val and equal and changed > 0)
        ok &= t_ok
        print(f"[msi train {name}] {card} | msi.main --mode train cuda f32 "
              f"full width, x4 crop 256 batch 1, {MSI_STEPS} steps: loss "
              f"first {losses[0]:.4f} last {losses[-1]:.4f} | steady "
              f"{rate:.3f} steps/s excluding the first step; wall "
              f"{wall:.1f} s (model build, cuDNN timing and the epoch-end "
              f"validation of {min(8, n_test)} tiles included) | validation "
              f"psnr {val.get('psnr', math.nan):.4f} lpips "
              f"{val.get('lpips', math.nan):.4f}, forward "
              f"{val.get('infer_time', math.nan):.4f} s per image at batch "
              f"8 (first batch's set-up included) | peak {peak:.2f} GiB | "
              f"checkpoint {os.path.basename(summ['checkpoint'])} reloads "
              f"bit-equal {equal}, {changed} tensors moved "
              f"{'ok' if t_ok else 'FAIL'}", flush=True)
        row["train"] = {"steps": summ["steps"], "steady_steps_per_s": rate,
                        "loss": losses, "wall_s": wall, "peak_gib": peak,
                        "validation": val, "bit_equal": equal}

        rep, wall, peak = run(name, "--mode", "validateByClass", "--resume",
                              summ["checkpoint"])
        overall = rep["__overall__"]
        classes = sorted(k for k in rep if k != "__overall__")
        v_ok = (len(classes) == MSI_CLASSES and all(
            math.isfinite(rep[c].get(k, math.nan)) for c in rep
            for k in ("psnr", "ssim", "ergas", "lpips")))
        ok &= v_ok
        print(f"[msi validateByClass {name}] {card} | --resume, {n_test} "
              f"tiles in {len(classes)} classes, batch 8, cuDNN heuristics: "
              f"psnr {overall['psnr']:.4f} ssim {overall['ssim']:.4f} ergas "
              f"{overall['ergas']:.4f} lpips {overall['lpips']:.4f} "
              f"(bicubic psnr {overall['psnr_bicubic']:.4f}) | "
              f"{wall / n_test:.3f} s per image with set-up (model build, "
              f"checkpoint load, PNG decoding, metrics), wall {wall:.1f} s | "
              f"peak {peak:.2f} GiB {'ok' if v_ok else 'FAIL'}", flush=True)
        row["validate_by_class"] = {"report": rep, "wall_s": wall,
                                    "s_per_image": wall / n_test,
                                    "peak_gib": peak}

        h, w = MSI_SINGLE.get(name, MSI_SINGLE_DEFAULT)
        out_png = os.path.join(work, f"{name}_single.png")
        _, wall, peak = run(name, "--mode", "test_single", "--resume",
                            summ["checkpoint"], "--input", dirs[(h, w)],
                            "--output", out_png)
        sr = load_img(out_png)
        s_ok = sr.shape == (4 * h, 4 * w, 3)
        ok &= s_ok
        print(f"[msi test_single {name}] {card} | {w}x{h} PNG -> "
              f"{sr.shape[1]}x{sr.shape[0]}, batch 1: wall {wall:.2f} s "
              f"(set-up included) | peak {peak:.2f} GiB "
              f"{'ok' if s_ok else 'FAIL'}", flush=True)
        row["test_single"] = {"in_hw": [h, w], "out_shape": list(sr.shape),
                              "wall_s": wall, "peak_gib": peak}
        detail[name] = row

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = types.SimpleNamespace(scale_factor=4, g_nf=64, g_nc=32,
                                 g_blocks=23, crop_size=256, lr=2e-4,
                                 weight_gan=1e-3)
    t0 = time.time()
    gan = GANTrainer(args, device="cuda", seed=seed)
    m = gan.train([dirs["train"]], num_epochs=1, batch_size=GAN_BATCH,
                  max_steps=GAN_STEPS)
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    g_ok = (gan.step_count == GAN_STEPS and m["steps_per_s"] is not None
            and all(math.isfinite(m[k]) for k in ("g", "d", "pixel", "adv")))
    ok &= g_ok
    print(f"[msi gan] {card} | NDSRGAN GANTrainer cuda f32, DRRDBNet nf 64 "
          f"nc 32 23 blocks + GroupNorm discriminator, crop 256 batch "
          f"{GAN_BATCH}, LSGAN, {GAN_STEPS} steps: g {m['g']:.4f} d "
          f"{m['d']:.4f} pixel {m['pixel']:.4f} adv {m['adv']:.4f} | steady "
          f"{m['steps_per_s']:.3f} steps/s excluding the first; wall "
          f"{wall:.1f} s | peak {peak:.2f} GiB {'ok' if g_ok else 'FAIL'}",
          flush=True)
    detail["gan"] = {**m, "wall_s": wall, "peak_gib": peak}
    del gan

    detail["card_vs_cpu"], cmp_ok = msi_card_vs_cpu(card, seed)
    launches = dict(kernels.LAUNCHES)
    l_ok = not any(launches.values())
    ok &= cmp_ok and l_ok
    print(f"[msi] {card} | kernel launches through phase 17: {launches} "
          f"(none on this path) {'ok' if l_ok else 'FAIL'}", flush=True)
    detail["launches"] = launches
    return detail, ok


def dist_specs(seed):
    """Phase 18's inputs under build/smoke/dist: the train config as
    shipped (full width, batch B_TRAIN, on a pack from ``seed``) for
    DIST_TRAIN_STEPS steps, the f32 serving config on DIST_INFER_IMAGES
    images in one batch, the EDiffSR train yml (phase 16's settings) and
    MSI's folders, each as a ``-dist`` run with one in-run validation and
    one checkpoint at its last step, and as a plain reference without
    them. Returns the spec the worker reads."""
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.data import write_pack
    from fastdiffsr_tpu_torch.ediffsr.options import dump_yaml, load_yaml

    work = os.path.join(ROOT, "build", "smoke", "dist")
    os.makedirs(work, exist_ok=True)
    cfgs = os.path.join(ROOT, "fastdiffsr_tpu_torch", "configs")
    spec = {"work": work, "seed": seed,
            "out": os.path.join(work, "worker_result.json")}

    def dump(obj, name):
        path = os.path.join(work, name)
        with open(path, "w") as f:
            f.write(obj if isinstance(obj, str) else json.dumps(obj))
        return path

    train = load_json_config(os.path.join(cfgs,
                                          "sr_fastdiffsr_train_64_256.json"))
    ds = train["datasets"]["train"]
    pack = write_pack(os.path.join(work, f"train_pack_{seed}"),
                      TRAIN_IMAGES, seed + 7, int(ds["l_resolution"]),
                      int(ds["r_resolution"]))
    for split in ("train", "val"):
        train["datasets"][split].update(dataroot=pack, datatype="npy")
    train["datasets"]["train"]["batch_size"] = B_TRAIN
    train["datasets"]["val"]["data_len"] = VAL_IMAGES
    n = DIST_TRAIN_STEPS
    for tag, every in (("", n), ("_ref", 10 ** 9)):
        train["name"] = f"chip_smoke_dist_train{tag}"
        train["train"].update(n_iter=n, val_freq=every, print_freq=n,
                              save_checkpoint_freq=every)
        spec[f"train{tag}"] = dump(train, f"train{tag}.json")

    serve = load_json_config(os.path.join(cfgs,
                                          "sr_fastdiffsr_test_64_256.json"))
    spack = write_pack(os.path.join(work, f"serve_pack_{seed}"),
                       DIST_INFER_IMAGES, seed)
    serve["datasets"]["val"].update(dataroot=spack, datatype="npy",
                                    batch_size=DIST_INFER_IMAGES,
                                    data_len=DIST_INFER_IMAGES)
    for tag in ("", "_ref"):
        serve["name"] = f"chip_smoke_dist_infer{tag}"
        spec[f"infer{tag}"] = dump(serve, f"infer{tag}.json")

    roots = write_ediffsr_dirs(os.path.join(work, f"ediffsr_{seed}"),
                               seed + 11)
    ymls = os.path.join(ROOT, "fastdiffsr_tpu_torch", "ediffsr",
                        "options_yml")
    with open(os.path.join(ymls, "setting_mfe_Train_x4.yml")) as f:
        opt = load_yaml(f.read())
    for split in ("train", "val"):
        opt["datasets"][split].update(dataroot_GT=roots[(split, "hr_256")],
                                      dataroot_LQ=roots[(split, "lr_64")])
    # one loader thread: with several, a batch's samples draw their flips
    # and rotations from the dataset's shared stream in the threads' order,
    # which differs from run to run (-dist or not)
    opt["datasets"]["train"]["n_workers"] = 1
    for tag, every in (("", EDIFFSR_STEPS), ("_ref", 0)):
        opt["name"] = f"chip_smoke_ediffsr_dist{tag}"
        opt["train"].update(niter=EDIFFSR_STEPS, val_freq=every,
                            manual_seed=seed)
        opt["logger"]["save_checkpoint_freq"] = EDIFFSR_STEPS
        spec[f"ediffsr{tag}"] = dump(dump_yaml(opt), f"ediffsr{tag}.yml")

    dirs = write_msi_dirs(os.path.join(work, f"msi_{seed}"), seed + 17)
    spec["msi"] = ["--model_name", "SwinIR", "--mode", "train",
                   "--data_dir", dirs["train"], "--batch_size", "1",
                   "--num_epochs", "1", "--max_steps", str(MSI_STEPS),
                   "--log_freq", "4", "--scale_factor", "4",
                   "--crop_size", "256", "--test_crop_size", "256",
                   "--device", "cuda"]
    spec["msi_test"] = dirs["test"]
    spec["gan_dirs"] = [dirs["train"]]
    return spec


def gan_args():
    """NDSRGAN's GANTrainer at full width (phase 17's)."""
    import types
    return types.SimpleNamespace(scale_factor=4, g_nf=64, g_nc=32,
                                 g_blocks=23, crop_size=256, lr=2e-4,
                                 weight_gan=1e-3)


def dist_jobs(spec, dist):
    """(name, function) of phase 18's runs, with ``-dist`` (in the
    torchrun worker) or as the plain reference (in this process)."""
    from fastdiffsr_tpu_torch.cli import infer, sr_mfe
    from fastdiffsr_tpu_torch.ediffsr import train as etrain
    from fastdiffsr_tpu_torch.msi import main as msi_main
    from fastdiffsr_tpu_torch.msi.ndsrgan import GANTrainer

    tag, seed = ("" if dist else "_ref"), str(spec["seed"])
    flag = ["-dist"] if dist else []
    launcher = ["--launcher", "pytorch"] if dist else []
    # the reference skips the in-run validations (absent test dir)
    test_dir = spec["msi_test"] if dist else os.path.join(spec["work"], "-")

    def ediffsr():
        cwd = os.getcwd()
        os.chdir(spec["work"])          # experiments/ goes here
        try:
            return etrain.main(["-opt", spec[f"ediffsr{tag}"], "--device",
                                "cuda", "--val_images", "1"]
                               + (["-launcher", "pytorch"] if dist else []))
        finally:
            os.chdir(cwd)

    def gan():
        g = GANTrainer(gan_args(), device="cuda", seed=spec["seed"])
        return g.train(spec["gan_dirs"], num_epochs=1, batch_size=GAN_BATCH,
                       max_steps=GAN_STEPS)

    return [
        ("sr_mfe", lambda: sr_mfe.main(["-p", "train", "-c",
                                        spec[f"train{tag}"], "--device",
                                        "cuda", "--seed", seed, *flag])),
        ("infer", lambda: infer.main(["-c", spec[f"infer{tag}"], "--device",
                                      "cuda", "--seed", seed, *flag])),
        ("ediffsr", ediffsr),
        ("swinir", lambda: msi_main.main(
            [*spec["msi"], "--test_data_dir", test_dir, "--save_dir",
             os.path.join(spec["work"], f"msi_runs{tag}"), *launcher])),
        ("gan", gan),
    ]


def run_jobs(jobs):
    """Each job with the launch counters and peak memory reset just
    before and read just after."""
    import torch

    from fastdiffsr_tpu_torch.ops import fused_conv, kernels
    out = {}
    for name, fn in jobs:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        routes0 = dict(fused_conv.ROUTE_TAKEN)
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        out[name] = {"result": res, "wall_s": time.time() - t0,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "launches": dict(kernels.LAUNCHES),
                     "routes": {k: v - routes0[k] for k, v in
                                fused_conv.ROUTE_TAKEN.items()}}
    return out


def allreduce_ms(n_params: int, device) -> tuple:
    """CUDA-event ms of all-reducing ``n_params`` float32 gradients in
    DDP's bucket size (25 MiB), per step, over ALLREDUCE_REPS steps after
    a warm-up; and the bucket count."""
    import torch
    import torch.distributed as dist
    flat = torch.zeros(n_params, device=device)
    buckets = flat.split(25 * 2 ** 20 // 4)
    for _ in range(3):
        for b in buckets:
            dist.all_reduce(b)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ALLREDUCE_REPS):
        for b in buckets:
            dist.all_reduce(b)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ALLREDUCE_REPS, len(buckets)


def dist_worker(spec_path) -> int:
    """Phase 18's rank (run by torch.distributed.run from phase_dist):
    join the group from torchrun's variables (NCCL), run the ``-dist``
    jobs and the all-reduce timing, write the results for phase_dist."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from fastdiffsr_tpu_torch.cli.infer import build_unet
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.device import use_ieee_float32
    from fastdiffsr_tpu_torch.parallel import initialize_from_env, shutdown

    with open(spec_path) as f:
        spec = json.load(f)
    use_ieee_float32()
    device = initialize_from_env("cuda")
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "device": str(device),
           "nccl": str(torch.cuda.nccl.version())}
    t0 = time.time()
    out["jobs"] = run_jobs(dist_jobs(spec, dist=True))
    net = build_unet(load_json_config(spec["train"])["model"], device=device)
    n_params = sum(p.numel() for p in net.parameters())
    del net
    out["n_params"] = n_params
    out["allreduce_ms"], out["buckets"] = allreduce_ms(n_params, device)
    out["seconds"] = time.time() - t0
    with open(spec["out"], "w") as f:
        json.dump(out, f, default=str)
    shutdown()
    return 0


def phase_dist(card, seed):
    """Phase 18: data parallelism under torchrun at world size 1 on the
    card (module docstring). Returns (detail, launches of the kernels in
    it by name and K3 route, ok)."""
    import signal

    import numpy as np
    import torch

    from fastdiffsr_tpu_torch.cli import sr_mfe
    from fastdiffsr_tpu_torch.metrics import load_img
    from fastdiffsr_tpu_torch.ops import fused_conv, kernels

    t_phase = time.time()
    spec = dist_specs(seed)
    refs = run_jobs(dist_jobs(spec, dist=False))
    own_phases_regime()
    spec_path = os.path.join(spec["work"], "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    gc.collect()
    torch.cuda.empty_cache()
    if os.path.exists(spec["out"]):
        os.remove(spec["out"])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", os.path.join(ROOT, "chip_smoke.py"),
           "--dist-worker", spec_path]
    log_path = os.path.join(spec["work"], "worker.log")
    t0 = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=DIST_TIMEOUT)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            if proc.poll() is None or rc is None:
                os.killpg(proc.pid, signal.SIGKILL)     # torchrun + rank
                proc.wait()
    worker_wall = time.time() - t0
    if rc != 0 or not os.path.exists(spec["out"]):
        with open(log_path) as f:
            tail = f.read()[-4000:]
        print(f"[dist] {card} | torch.distributed.run --nproc_per_node=1 "
              f"FAIL (exit {rc}, {worker_wall:.1f} s):\n{tail}", flush=True)
        return {"worker_rc": rc}, {}, False
    with open(spec["out"]) as f:
        res = json.load(f)
    jobs = res["jobs"]
    ok = (res["backend"] == "nccl" and res["world"] == 1
          and res["device"] == "cuda:0")
    print(f"[dist] {card} | torch.distributed.run --standalone "
          f"--nproc_per_node=1: backend {res['backend']} (NCCL "
          f"{res['nccl']}), world {res['world']}, rank 0 on {res['device']},"
          f" the worker took {worker_wall:.1f} s (process start, NCCL init "
          f"and cuDNN's timing included) {'ok' if ok else 'FAIL'}",
          flush=True)
    detail = {"backend": res["backend"], "world": res["world"],
              "nccl": res["nccl"], "worker_wall_s": worker_wall,
              "allreduce_ms": res["allreduce_ms"],
              "n_params": res["n_params"], "buckets": res["buckets"]}

    def rel(a, b):
        a, b = np.asarray(a, float), np.asarray(b, float)
        return float(np.max(np.abs(a - b) / np.abs(b))) if len(b) else 0.0

    def rate(job, key):
        return job["result"][key] or math.nan

    # sr_mfe -p train -dist: per-step l_pix, launches, rate, all-reduce
    d, r = jobs["sr_mfe"], refs["sr_mfe"]
    steps = DIST_TRAIN_STEPS
    with open(spec["train"]) as f:
        tcfg = json.load(f)
    T = int(tcfg["model"]["beta_schedule"]["val"]["n_timestep"])
    # config.parse cuts -p train's val set to 13 images, as the reference
    n_val = evals_per_image(tcfg) * min(13, TRAIN_IMAGES)
    want = {"gn_swish": K1_PER_FORWARD["fastdiffsr"] * steps,
            "fused_gn_swish_conv3x3": 49 * n_val, "channel_stats": 4 * n_val}
    l_err = rel(d["result"]["l_pix"], r["result"]["l_pix"])
    ckpt = d["result"]["checkpoint"]
    s_ok = (d["launches"] == want and d["routes"]["cuda_cores"] == 49 * n_val
            and len(d["result"]["l_pix"]) == steps and l_err <= DIST_LPIX_RTOL
            and ckpt and os.path.basename(ckpt).startswith(f"I{steps}_")
            and d["result"]["last_validation"] is not None)
    d_rate, p_rate = rate(d, "steady_steps_per_s"), rate(
        r, "steady_steps_per_s")
    mib = res["n_params"] * 4 / 2 ** 20
    print(f"[dist sr_mfe] {card} | sr_mfe -p train -dist, "
          f"sr_fastdiffsr_train_64_256.json full width, B={B_TRAIN} 256x256,"
          f" {steps} steps: K1 launches {d['launches']['gn_swish']} "
          f"({d['launches']['gn_swish'] / steps:g} per step, want "
          f"{K1_PER_FORWARD['fastdiffsr']}); in-run validation on rank 0 "
          f"({min(13, TRAIN_IMAGES)} images): K3 "
          f"{d['launches']['fused_gn_swish_conv3x3']} ("
          f"{d['launches']['fused_gn_swish_conv3x3'] / n_val:g} per eval, "
          f"{d['routes']['cuda_cores']} on the f32 CUDA-core kernel), K2 "
          f"{d['launches']['channel_stats']} "
          f"({d['launches']['channel_stats'] / n_val:g} per eval) | l_pix "
          f"per step against the plain run: max rel diff {l_err:.3g} (tol "
          f"{DIST_LPIX_RTOL}) | steady {d_rate:.3f} steps/s with -dist, "
          f"{p_rate:.3f} without ({d_rate / p_rate:.4f}) | all-reduce of "
          f"the UNet's {res['n_params']} gradients ({mib:.1f} MiB in "
          f"{res['buckets']} buckets of 25 MiB): {res['allreduce_ms']:.4f} "
          f"ms per step (CUDA events) | peak {d['peak_gib']:.2f} GiB (plain "
          f"{r['peak_gib']:.2f}) | checkpoint "
          f"{os.path.basename(ckpt or '-')} by rank 0 "
          f"{'ok' if s_ok else 'FAIL'}", flush=True)
    ok &= s_ok
    detail["sr_mfe"] = {"l_pix": d["result"]["l_pix"],
                        "l_pix_plain": r["result"]["l_pix"],
                        "l_pix_max_rel": l_err, "steps_per_s": d_rate,
                        "plain_steps_per_s": p_rate,
                        "launches": d["launches"], "routes": d["routes"],
                        "peak_gib": d["peak_gib"],
                        "plain_peak_gib": r["peak_gib"],
                        "in_run_validation": d["result"]["last_validation"],
                        "wall_s": d["wall_s"], "checkpoint": ckpt}
    launches = {k: v for k, v in d["launches"].items()}
    launches["cuda_cores"] = d["routes"]["cuda_cores"]

    # the -dist checkpoint in a plain -p val
    with open(spec["train_ref"]) as f:
        cfg = json.load(f)
    cfg["name"] = "chip_smoke_dist_val"
    cfg["path"]["resume_state"] = ckpt
    val_cfg = os.path.join(spec["work"], "val.json")
    with open(val_cfg, "w") as f:
        json.dump(cfg, f)
    kernels.reset_launch_counts()
    routes0 = dict(fused_conv.ROUTE_TAKEN)
    v = sr_mfe.main(["-p", "val", "-c", val_cfg, "--device", "cuda",
                     "--seed", str(seed)])
    torch.cuda.synchronize()
    own_phases_regime()
    v_launch = dict(kernels.LAUNCHES)
    v_cores = fused_conv.ROUTE_TAKEN["cuda_cores"] - routes0["cuda_cores"]
    n_eval = T * VAL_IMAGES
    v_ok = (math.isfinite(v.get("psnr", math.nan))
            and v_launch["fused_gn_swish_conv3x3"] == 49 * n_eval == v_cores
            and v_launch["channel_stats"] == 4 * n_eval)
    print(f"[dist val] {card} | the -dist checkpoint in a plain -p val, "
          f"{VAL_IMAGES} images: psnr {v.get('psnr', math.nan):.4f} ssim "
          f"{v.get('ssim', math.nan):.4f}, K3 "
          f"{v_launch['fused_gn_swish_conv3x3']} K2 "
          f"{v_launch['channel_stats']} launches {'ok' if v_ok else 'FAIL'}",
          flush=True)
    ok &= v_ok
    for k in ("fused_gn_swish_conv3x3", "channel_stats"):
        launches[k] += v_launch[k]
    launches["cuda_cores"] += v_cores

    # cli.infer -dist against the plain run, image for image
    d, r = jobs["infer"], refs["infer"]
    n_eval = T                          # one batch of DIST_INFER_IMAGES
    diffs = [int(np.abs(load_img(os.path.join(d["result"]["results"],
                                              f"{i}_sr.png")).astype(int)
                        - load_img(os.path.join(r["result"]["results"],
                                                f"{i}_sr.png")).astype(int)
                        ).max()) for i in range(DIST_INFER_IMAGES)]
    i_ok = (d["result"]["images"] == DIST_INFER_IMAGES
            and max(diffs) <= DIST_PNG_TOL
            and d["launches"]["fused_gn_swish_conv3x3"] == 49 * n_eval
            and d["routes"]["cuda_cores"] == 49 * n_eval
            and d["launches"]["channel_stats"] == 4 * n_eval)
    print(f"[dist infer] {card} | cli.infer -dist f32, {DIST_INFER_IMAGES} "
          f"64->256 images in one batch, T={T}: K3 "
          f"{d['launches']['fused_gn_swish_conv3x3']} (49 per eval, want "
          f"{49 * n_eval}), K2 {d['launches']['channel_stats']} | SR PNGs "
          f"against the plain run: max |d| {max(diffs)} uint8 levels (tol "
          f"{DIST_PNG_TOL}; expect 0) | {d['wall_s']:.1f} s wall (plain "
          f"{r['wall_s']:.1f}) | peak {d['peak_gib']:.2f} GiB "
          f"{'ok' if i_ok else 'FAIL'}", flush=True)
    ok &= i_ok
    detail["infer"] = {"max_png_diff": max(diffs), "wall_s": d["wall_s"],
                       "plain_wall_s": r["wall_s"],
                       "peak_gib": d["peak_gib"], "launches": d["launches"]}
    for k in ("fused_gn_swish_conv3x3", "channel_stats"):
        launches[k] += d["launches"][k]
    launches["cuda_cores"] += d["routes"]["cuda_cores"]

    # EDiffSR, SwinIR and the GAN: losses, rates, no kernel of ours
    for name, key, loss_key, what in (
            ("ediffsr", "steady_steps_per_s", "loss",
             "ediffsr.train -launcher pytorch, setting_mfe_Train_x4.yml "
             f"full width (one loader thread), batch 2 256x256, "
             f"{EDIFFSR_STEPS} steps, a 1-image validation and the save on "
             "rank 0"),
            ("swinir", "steady_steps_per_s", "loss",
             f"msi.main --launcher pytorch SwinIR full width, crop 256 "
             f"batch 1, {MSI_STEPS} steps, the epoch-end validation of 8 "
             "tiles and the save on rank 0"),
            ("gan", "steps_per_s", None,
             f"GANTrainer in DDP (G and D), full width, crop 256 batch "
             f"{GAN_BATCH}, {GAN_STEPS} steps")):
        d, r = jobs[name], refs[name]
        if loss_key:
            err = rel(d["result"][loss_key], r["result"][loss_key])
        else:
            err = rel([d["result"][k] for k in ("g", "d", "pixel", "adv")],
                      [r["result"][k] for k in ("g", "d", "pixel", "adv")])
        d_rate, p_rate = rate(d, key), rate(r, key)
        j_ok = (err <= DIST_LPIX_RTOL and not any(d["launches"].values())
                and math.isfinite(d_rate))
        if name == "swinir":
            j_ok &= bool(d["result"]["validations"]) and bool(
                d["result"]["checkpoint"])
        print(f"[dist {name}] {card} | {what}: loss against the plain run "
              f"max rel diff {err:.3g} (tol {DIST_LPIX_RTOL}) | steady "
              f"{d_rate:.3f} steps/s with DDP, {p_rate:.3f} without "
              f"({d_rate / p_rate:.4f}) | peak {d['peak_gib']:.2f} GiB "
              f"(plain {r['peak_gib']:.2f}) | kernel launches "
              f"{d['launches']} (none on this path) "
              f"{'ok' if j_ok else 'FAIL'}", flush=True)
        ok &= j_ok
        detail[name] = {"loss": d["result"].get(loss_key or "g"),
                        "plain_loss": r["result"].get(loss_key or "g"),
                        "loss_max_rel": err, "steps_per_s": d_rate,
                        "plain_steps_per_s": p_rate,
                        "peak_gib": d["peak_gib"],
                        "plain_peak_gib": r["peak_gib"],
                        "wall_s": d["wall_s"]}
    detail["seconds"] = time.time() - t_phase
    return detail, launches, ok


def gdp_reference(card, seed):
    """``--gdp-reference``: cli.infer of configs/sr_gdp_test_64_256.json
    (the guided UNet at full width, ancestral sampling over T=1000 at
    256x256) on one synthetic image from ``seed``, on the plain forward,
    f32 then bf16, with seeded Flax-default weights (the zero-initialised
    output layers make the UNet's output 0, which costs the same as any
    other). One image is one batch, so its seconds include set-up. Ends
    with one JSON line of the rows; exits non-zero if a run failed its
    checks (29 K1 launches per eval)."""
    from fastdiffsr_tpu_torch.data import write_pack
    cfg = variant_cfg("gdp", "test_64_256")
    pack = write_pack(os.path.join(ROOT, "build", "smoke",
                                   f"gdp_pack_{seed}"), 1, seed)
    cfg["datasets"]["val"].update(dataroot=pack, datatype="npy",
                                  batch_size=1, data_len=1)
    T = int(cfg["model"]["beta_schedule"]["val"]["n_timestep"])
    rows, ok = [], True
    for dt in ("f32", "bf16"):
        cfg["name"] = f"chip_smoke_gdp_reference_{dt}"
        row, r_ok = run_infer(
            cfg, cfg["name"], card,
            ["--dtype", dt, "--plain", "--seed", str(seed)],
            f"gdp reference {dt}",
            {"fused_gn_swish_conv3x3": 0, "channel_stats": 0,
             "gn_swish": K1_PER_FORWARD["gdp"] * T})
        rows.append(dict(row, dtype=dt, T=T, ok=r_ok))
        ok &= r_ok
    print(json.dumps({"card": card, "gdp_reference": rows}))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds weights, inputs and the synthetic data")
    ap.add_argument("--gdp-reference", action="store_true",
                    help="in place of phases 2-17: the gdp evaluation at its "
                         "reference shape (see gdp_reference)")
    ap.add_argument("--ediffsr-only", action="store_true",
                    help="in place of phases 2-15 and 17: only phase 16 "
                         "(EDiffSR)")
    ap.add_argument("--msi-only", action="store_true",
                    help="in place of phases 2-16: only phase 17 (MSI)")
    ap.add_argument("--dist-only", action="store_true",
                    help="in place of phases 2-17: only phase 18 (data "
                         "parallel under torchrun)")
    ap.add_argument("--dist-worker", metavar="SPEC",
                    help="phase 18's rank, started by torchrun")
    args = ap.parse_args(argv)
    if args.dist_worker:
        return dist_worker(args.dist_worker)

    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from fastdiffsr_tpu_torch.ops import kernels
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr_fused import (
        fused_apply, prepare_fused_params)
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.data import write_pack
    from fastdiffsr_tpu_torch.device import use_ieee_float32

    use_ieee_float32()          # as the CLIs do
    own_phases_regime()
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
    if args.gdp_reference:
        return gdp_reference(card, args.seed)
    if args.ediffsr_only:
        t0 = time.time()
        detail["ediffsr"], e_ok = phase_ediffsr(card, args.seed)
        print(f"[ediffsr] {card} | phase 16 took {time.time() - t0:.1f} s "
              f"{'ok' if e_ok else 'FAIL'}", flush=True)
        with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
            json.dump(detail, f, indent=1)
        return 0 if e_ok else 1
    if args.msi_only:
        t0 = time.time()
        detail["msi"], m_ok = phase_msi(card, args.seed)
        print(f"[msi] {card} | phase 17 took {time.time() - t0:.1f} s "
              f"{'ok' if m_ok else 'FAIL'}", flush=True)
        with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
            json.dump(detail, f, indent=1)
        return 0 if m_ok else 1
    if args.dist_only:
        detail["dist"], _, d_ok = phase_dist(card, args.seed)
        took = detail["dist"].get("seconds", math.nan)
        print(f"[dist] {card} | phase 18 took {took:.1f} s "
              f"{'ok' if d_ok else 'FAIL'}", flush=True)
        with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
            json.dump(detail, f, indent=1)
        return 0 if d_ok else 1
    laps, t_lap = {}, [time.time()]

    def lap(name):
        """Seconds since the previous lap, kept as the phase's time."""
        now = time.time()
        laps[name] = now - t_lap[0]
        t_lap[0] = now
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
    floor = launch_floor_ms()
    print(f"[floor] {card} | the launch floor: a one-element in-place add, "
          f"device {floor:.4f} ms per call ({REPS} calls in one CUDA-graph "
          f"replay)", flush=True)
    detail["floor_ms"] = floor
    k2_rows, k2_ok = phase_k2(k2_sigs, B, REPS, card, args.seed)
    # batch 1 in float32, the -p val shape
    k2_b1_rows, k2_b1_ok = phase_k2(k2_sigs, 1, REPS, card, args.seed,
                                    dtypes=("f32",))
    print_k2_totals(k2_rows, card)
    print_k2_totals(k2_b1_rows, card)
    ok &= k3_ok and k3_b1_ok and k2_ok and k2_b1_ok
    detail["k3"], detail["k3_b1"] = k3_rows, k3_b1_rows
    detail["k2"], detail["k2_b1"] = k2_rows, k2_b1_rows
    lap("2-3 K3, K2")

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
    lap("4 UNet")
    del x, want, got32, got16, net, fp16

    # 5. serving path end to end
    work = os.path.join(ROOT, "build", "smoke")
    droot = os.path.join(work, f"pack_{args.seed}")
    n_img = SERVE_BATCH * SERVE_BATCHES
    write_pack(droot, n_img, args.seed)
    cfg["name"] = "chip_smoke_infer"
    cfg["datasets"]["val"].update(dataroot=droot, datatype="npy",
                                  batch_size=SERVE_BATCH, data_len=n_img)
    n_eval = T * SERVE_BATCHES
    detail["serve"], serve_ok = run_infer(
        cfg, cfg["name"], card, ["--dtype", "bf16", "--seed", str(args.seed)],
        "serve", {"fused_gn_swish_conv3x3": 49 * n_eval,
                  "channel_stats": 4 * n_eval, "gn_swish": 0},
        {"wgmma": 49 * n_eval, "cuda_cores": 0})
    # the same in float32, infer's default (K3 on the CUDA cores)
    cfg["name"] = "chip_smoke_infer_f32"
    detail["serve_f32"], serve32_ok = run_infer(
        cfg, cfg["name"], card, ["--seed", str(args.seed)], "serve f32",
        {"fused_gn_swish_conv3x3": 49 * n_eval, "channel_stats": 4 * n_eval,
         "gn_swish": 0}, {"wgmma": 0, "cuda_cores": 49 * n_eval})
    ok &= serve_ok and serve32_ok
    lap("5 serve")
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
    shapes_ok = n_k1 == K1_PER_FORWARD["fastdiffsr"] and strided == 0
    ok &= shapes_ok
    print(f"[shapes] {card} | one training forward: {n_k1} K1 calls in "
          f"{len(k1_sigs)} shapes (want {K1_PER_FORWARD['fastdiffsr']}), "
          f"{strided} Blocks with a non-contiguous NHWC input "
          f"{'ok' if shapes_ok else 'FAIL'}", flush=True)
    del tnet, x
    k1_rows, k1_ok = phase_k1(k1_sigs, B_TRAIN, REPS, card, args.seed)
    lap("6 K1")
    largest = max(k1_sigs, key=lambda sg: sg[0] * sg[1] * sg[2])
    detail["k1_grad"], grad_ok = phase_k1_grad(largest, B_TRAIN, card,
                                               args.seed)
    detail["k1"] = k1_rows
    detail["train_step"], step_ok = phase_train_parity(train_cfg, B_TRAIN,
                                                       card, args.seed)
    lap("7-8 K1 grad, train step")
    detail["train"], k1_launches, train_ok = phase_train(train_cfg, card,
                                                         args.seed,
                                                         lpips=True)
    lap("9 train, val")
    ok &= k1_ok and grad_ok and step_ok and train_ok

    # 10. the fast samplers; 11. K1 at the SR3 and guided shapes;
    # 12. the ddpm/tesr/gdp variants end to end
    detail["samplers"], samp_ok = phase_samplers(cfg, card, args.seed)
    lap("10 samplers")
    detail["k1_variants"], k1v_ok = phase_k1_variants(k1_rows, card,
                                                      args.seed)
    lap("11 K1 variants")
    detail["variants"], k1_variant_launches, var_ok = phase_variants(
        card, args.seed, droot)
    lap("12 variants")
    ok &= samp_ok and k1v_ok and var_ok

    # 13. K3/K2 at the 128->512 shapes; 14. the 128->512 path; 15. cli.fid
    detail["k512"], k512_ok = phase_512_kernels(card, args.seed)
    lap("13 K3, K2 at 512")
    detail["infer_512"], i512_ok = phase_512_infer(card, args.seed)
    lap("14 infer 128->512")
    detail["fid"], fid_ok = phase_fid(card, args.seed)
    lap("15 fid")
    ok &= k512_ok and i512_ok and fid_ok

    # 16. EDiffSR: training, --test with the three samplers, card vs CPU
    gc.collect()
    torch.cuda.empty_cache()
    detail["ediffsr"], ediffsr_ok = phase_ediffsr(card, args.seed)
    lap("16 ediffsr")
    ok &= ediffsr_ok

    # 17. MSI: the five baselines through msi.main, GAN, card vs CPU
    gc.collect()
    torch.cuda.empty_cache()
    detail["msi"], msi_ok = phase_msi(card, args.seed)
    lap("17 msi")
    ok &= msi_ok

    # 18. data parallel under torchrun (world size 1, NCCL)
    gc.collect()
    torch.cuda.empty_cache()
    detail["dist"], dist_launches, dist_ok = phase_dist(card, args.seed)
    lap("18 dist")
    ok &= dist_ok
    k3_512, k2_512 = detail["k512"]["k3"], detail["k512"]["k2"]
    k1_all_rows = k1_rows + [r for v in detail["k1_variants"].values()
                             for r in v["rows"]]
    # per SR3 forward (the shapes of phase 6) at batch 1, the batch of
    # the variants' -p val runs
    k1_b1 = detail["k1_variants"]["ddpm"]["total"]["f32_b1"]
    wgmma_launches = detail["serve"]["routes"]["wgmma"] + sum(
        detail["samplers"][s]["routes"]["wgmma"] for s in ("ddim", "dpm")) \
        + detail["infer_512"]["bf16"]["routes"]["wgmma"]
    k2_launches = (detail["serve"]["launches"]["channel_stats"]
                   + detail["serve_f32"]["launches"]["channel_stats"]
                   + detail["train"]["val_launches"]["channel_stats"]
                   + sum(detail["samplers"][s]["launches"]["channel_stats"]
                         for s in ("ddim", "dpm"))
                   + sum(detail["infer_512"][dt]["launches"]["channel_stats"]
                         for dt in ("f32", "bf16"))
                   + dist_launches.get("channel_stats", 0))

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

    def at_512(rows, dt, err="max_abs_err_y"):
        """Per 128->512 eval at batch 1: the ``*_512`` keys of an entry."""
        return {"ms_512": total(rows, "ms", dt),
                "plain_ms_512": total(rows, "plain_ms", dt),
                "bound_ms_512": total(rows, "bound_ms", dt),
                "bound_by_512": by(rows, dt),
                "library_ms_512": (total(rows, "library_ms", dt)
                                   if rows[0]["library_ms"] is not None
                                   else None),
                "max_abs_err_512": max(r[err] for r in rows
                                       if r["dtype"] == dt)}

    print_k3_totals(k3_rows, card)
    print_k3_totals(k3_b1_rows, card)
    k1_tot = {k: total(k1_rows, k, "f32", "calls_per_forward")
              for k in ("ms", "plain_ms", "bound_ms", "two_call_library_ms",
                        "reference_ms", "wall_ms", "plain_wall_ms",
                        "two_call_library_wall_ms", "reference_wall_ms",
                        "launches_per_call")}
    print(f"[K1 total] {card} | f32 per training forward (B={B_TRAIN}), "
          f"device: kernel {k1_tot['ms']:.3f} ms, plain "
          f"{k1_tot['plain_ms']:.3f} ms, F.group_norm+F.silu "
          f"{k1_tot['two_call_library_ms']:.3f} ms, gn_swish_reference "
          f"(recomputed in the backward) {k1_tot['reference_ms']:.3f} ms | "
          f"wall: kernel {k1_tot['wall_ms']:.3f} ms, plain "
          f"{k1_tot['plain_wall_ms']:.3f} ms, two calls "
          f"{k1_tot['two_call_library_wall_ms']:.3f} ms | bound "
          f"{k1_tot['bound_ms']:.3f} ms | "
          f"{floor_line(k1_tot['launches_per_call'])}", flush=True)
    detail["k1_total_f32"] = k1_tot
    kern = [
        {"name": "gn_swish", "route": "cuda",
         "source": "fastdiffsr_tpu_torch/csrc/gn_swish.cu",
         "replaces": "fastdiffsr_tpu/ops/groupnorm.py:54",
         "launches": k1_launches + k1_variant_launches
         + dist_launches.get("gn_swish", 0),
         "max_abs_err": max(r["max_abs_err"] for r in k1_all_rows
                            if r["dtype"] == "f32"),
         "ms": k1_tot["ms"], "plain_ms": k1_tot["plain_ms"],
         "bound_ms": k1_tot["bound_ms"],
         "bound_by": by(k1_rows, "f32", "calls_per_forward"),
         "library_ms": None,
         "two_call_library_ms": k1_tot["two_call_library_ms"],
         "wall_ms": k1_tot["wall_ms"],
         "ms_b1": k1_b1["ms"], "plain_ms_b1": k1_b1["plain_ms"],
         "bound_ms_b1": k1_b1["bound_ms"],
         "two_call_library_ms_b1": k1_b1["two_call_library_ms"],
         "launches_per_call": max(r["launches_per_call"]
                                  for r in k1_all_rows),
         "floor_ms": detail["floor_ms"]},
        # K3 has two hand-written kernels: bf16 maps (serving) run on the
        # tensor cores, f32 maps (validation) on the CUDA cores
        {"name": "fused_gn_swish_conv3x3", "route": "cuda",
         "source": "fastdiffsr_tpu_torch/csrc/fused_conv_wgmma.cu",
         "replaces": "fastdiffsr_tpu/ops/fused_conv.py:107",
         "launches": wgmma_launches,
         "kernel_route": k3_route_of("bf16"),
         "max_abs_err": max(r["max_abs_err_y"] for r in k3_rows
                            if r["dtype"] == "bf16"),
         "ms": total(k3_rows, "ms"), "plain_ms": total(k3_rows, "plain_ms"),
         "bound_ms": total(k3_rows, "bound_ms"), "bound_by": by(k3_rows),
         "library_ms": total(k3_rows, "library_ms"),
         "wall_ms": total(k3_rows, "wall_ms"), **at_512(k3_512, "bf16")},
        {"name": "fused_gn_swish_conv3x3_f32", "route": "cuda",
         "source": "fastdiffsr_tpu_torch/csrc/fused_conv.cu",
         "replaces": "fastdiffsr_tpu/ops/fused_conv.py:107",
         "launches": detail["train"]["val_routes"]["cuda_cores"]
         + detail["serve_f32"]["routes"]["cuda_cores"]
         + detail["infer_512"]["f32"]["routes"]["cuda_cores"]
         + dist_launches.get("cuda_cores", 0),
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
         "library_ms_b1": total(k3_b1_rows, "library_ms", "f32"),
         **at_512(k3_512, "f32")},
        {"name": "channel_stats", "route": "cuda",
         "source": "fastdiffsr_tpu_torch/csrc/channel_stats.cu",
         "replaces": "fastdiffsr_tpu/ops/groupnorm.py:143",
         "launches": k2_launches,
         "max_abs_err": max(r["max_abs_err"] for r in k2_rows
                            if r["dtype"] == "f32"),
         "ms": total(k2_rows, "ms"), "plain_ms": total(k2_rows, "plain_ms"),
         "bound_ms": total(k2_rows, "bound_ms"), "bound_by": by(k2_rows),
         "library_ms": None, "wall_ms": total(k2_rows, "wall_ms"),
         "ms_f32": total(k2_rows, "ms", "f32"),
         "bound_ms_f32": total(k2_rows, "bound_ms", "f32"),
         # batch 1, float32: the -p val shape
         "ms_b1": total(k2_b1_rows, "ms", "f32"),
         "plain_ms_b1": total(k2_b1_rows, "plain_ms", "f32"),
         "bound_ms_b1": total(k2_b1_rows, "bound_ms", "f32"),
         "launches_per_call": max(r["launches_per_call"]
                                  for r in k2_rows + k2_b1_rows + k2_512),
         "floor_ms": detail["floor_ms"],
         **at_512(k2_512, "bf16", "max_abs_err"),
         **{f"{k}_f32": v for k, v in
            at_512(k2_512, "f32", "max_abs_err").items()}},
    ]
    detail["kernels"] = kern
    detail["seconds"] = time.time() - t_start
    detail["phase_seconds"] = laps
    print(f"[phase seconds] {card} | " + ", ".join(
        f"{k} {v:.1f}" for k, v in laps.items()), flush=True)
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
