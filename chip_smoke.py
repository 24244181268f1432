#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fastdiffsr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--gdp-reference | --ediffsr-only |
                                      --msi-only | --dist-only |
                                      --serving-only | --demo-only |
                                      --quant-only | --rewrites-only]

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
   gn_swish_reference, built with the default tconv Upsample) from the
   same initial noise, with the bf16 fused forward as a control that
   must fall outside the tolerance, and the plain chain run twice
   bit-equal;
11. K1 against its plain version at every distinct K1 shape of one SR3
   (ddpm) and one guided (gdp) training forward at batch 4, 256x256, that
   phase 6 did not measure, with the same columns, then in f32 at batch
   1, the batch of their ``-p val`` runs, and K1's time per forward of
   each net at both batches;
12. the ddpm, tesr and gdp variants: per UNet (ddpm's and tesr's SR3,
   gdp's guided) a train step on K1 against one on gn_swish_reference
   (randomized weights), then per variant
   ``cli.sr_mfe -p train`` at full width (45 K1 launches per step for
   SR3, 29 for the guided UNet; steady steps/s; peak memory; a checkpoint
   that reloads bit-equal; gdp also validates VAL_PACK_IMAGES images at
   its last step inside the run, on cuDNN's heuristics) and ``-p val`` on
   one image (ddpm: ancestral T=1000; tesr, gdp: DDIM 50 steps; K1
   launches per eval, seconds per image); then ``cli.infer`` of the ddpm
   config in bf16 on the plain forward with DPM-Solver++ at 20 steps
   (beside phases 16-17, as the phases below marked so; see after the
   list);
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
   against a float64 evaluation of the same statistics by eigenvalues
   (beside phases 16-17);
16. EDiffSR through ``fastdiffsr_tpu_torch.ediffsr.train`` on synthetic
   64->256 PNG folders from --seed: training of the paper's full-width
   ConditionalNAFNet (setting_mfe_Train_x4.yml: width 64, enc
   [14,1,1,1], T=100, batch 2, AdamW 4e-5) for EDIFFSR_STEPS steps with a
   T=100 validation of 2 images at the last one (steady steps/s, peak
   memory, seconds per validation image), ``--test`` of
   setting_mfe_Test_x4.yml from its checkpoint with the reverse SDE on 2
   images and the Euler ODE and RK45 on one each (seconds per image,
   RK45's accepted and trial steps, peak memory), and the same port code
   on the card against the CPU (a full-width NAFNet forward, a 4-step
   reverse SDE, a ConditionalUNet forward). EDiffSR has no kernel of
   ours: every launch counter must read 0 there. Phases 16 and 17 run in
   a process of their own (``--side-worker``);
17. the five MSI baselines (SwinIR, HAT, HSENet, TransENet, NDSRGAN)
   through ``fastdiffsr_tpu_torch.msi.main`` at full width (JAX
   ``msi/main.py``'s defaults, x4, crop 256, batch 1) on PNG folders from
   --seed: ``--mode train`` for MSI_STEPS steps with its epoch-end
   validation of 8 tiles (steady steps/s, peak memory, a checkpoint
   that reloads bit-equal), ``--mode validateByClass`` from SwinIR's
   checkpoint (MSI_BY_CLASS; PSNR/SSIM/ERGAS and LPIPS on the card,
   seconds per image), ``--mode test_single`` on an odd-size PNG; NDSRGAN's
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
   each against its plain run in this process (beside phases 16-17;
   losses, steady steps/s, peak GiB; no kernel of ours); before
   those jobs, first in the rank's process, the chained train step
   under the group on the train config (its state DDP-wrapped): a replay
   of CHAIN_N captured steps (the bare net, its gradients' all-reduce in
   the graph) against unchained DDP steps, with K1's and NCCL's kernels
   per replay in a torch.profiler trace, and ``sr_mfe -p train -dist``
   with FASTDIFFSR_TPU_STEPS_PER_CALL=CHAIN_N against unchained (steady
   steps/s and peak reserved GiB of both);
19. the serving export (``fastdiffsr_tpu_torch.serving``) at full width,
   every artifact with a symbolic batch: 64->256 ancestral T=20 in f32
   (through the CLI's ``main`` with ``--selftest``) and bf16, DPM-Solver++
   10 steps in f32 (with a CPU copy, ``--platforms cuda,cpu``), 128->512
   ancestral in bf16 (the fused forward: K3 and K2), ddpm's DDIM 5
   steps in f32 (the plain SR3 forward: K1), ddpm's own ancestral T=1000
   in f32, which the CLI exports in the scan form (one eval in the graph,
   the noise drawn inside from one seed per image), and the 64->256 f32
   sampler with the scan form forced (``export_sampler(loop=True)``),
   exported by one process each (export seconds, artifact MB); a fresh
   process per artifact that
   imports torch and the op registry (``fastdiffsr_tpu_torch.ops``) only
   loads it (seconds) as soon as its export is written, and runs it on the
   inputs of the in-process sampler, which a further fresh process runs
   with the same per-image generators (64->256 at batches 16 and 3, DPM
   and DDIM at 2, 128->512 at 1 over 2 timed images, ddpm T=1000 on one
   image, its reference before the turns, the forced scan form at 2; a
   scan-form case's in-process sampler fed the noise ``counter_noise``
   makes of the seeds): outputs
   within EXPORT_TOL, launches per image of each kernel, and of K3 per
   route, equal, 49 K3 and 4 K2 (fused) or 45 K1 (SR3) per eval, and
   img/s of both; the f32 loader also runs its unrolled artifact on the
   forced scan form's noise, which must give the scan's images bit for
   bit; the DPM loader also runs the CPU copy on image 0 against the
   card's (phase 10's tolerance) before its turn; the workers take the
   card in turns. The workers start after phase 14, niced, and prepare
   (export, load, run every in-process reference) beside phases 12 and
   15-18; phase 18 starts once the references are done, and the turns
   wait for phase 19. Then the host microseconds of
   one K3 call through its registered operator against the direct
   wrapper;
20. ``model_api.DDPM`` on sr_fastdiffsr_train_64_256.json at full width,
   batch 4: three ``optimize_parameters`` steps (45 K1 launches each,
   l_pix equal bit for bit to ``make_train_step`` with the step's
   generator), ``set_new_noise_schedule`` to val and ``test(continous=
   True)`` (a (T,B,256,256,3) trajectory whose last frame is ``test()``,
   49 K3 and 4 K2 per eval), ``save_network`` / ``load_network``
   bit-equal, ``count_parameters`` equal to ``param_count`` (beside
   phases 16-17);
21. the demo path: DEMO_SOURCES seeded 64x64 source PNGs tiled by
   ``fastdiffsr_tpu_torch.data.prepare`` (a pool of spawn workers) at
   8->64 into folders, npy packs and LMDB, which must decode
   to equal uint8 arrays (seconds to write and read each); one train step
   of configs/demo_ucm_native_8_64_s8hg.json (full width, batch 16,
   64x64, its SSIM term on) on K1 against gn_swish_reference, with the
   term printed beside the L1 term; ``cli.sr_mfe -p train`` of that config
   and of ``_s8h.json`` (no term) for DEMO_STEPS steps on the folder
   corpus (device cache on, as the configs have it; 45 K1 launches per
   step; steps/s of both: the term's cost), then of s8hg on the folder and
   on the LMDB corpus with cuDNN on its deterministic algorithms (l_pix
   equal bit for bit); ``-p val`` of the s8hg checkpoint on DEMO_VAL
   tiles (x8, fused f32, batch 1, T=20: 49 K3 on the CUDA cores and 4 K2
   per eval, seconds per image); then K3 f32 and K2 at batch 1 and K1 at
   batch 16 against their plain versions at every shape of the 64x64
   UNet, down to its 8x8 maps;
22. the W8A8 path (``FASTDIFFSR_TPU_QUANT``): the quantized convs of a
   full-width 64->256 and 128->512 forward counted (21 and 31); Q1
   (``csrc/quant_conv.cu``) against its plain version at the 9 shapes of
   a 64->256 eval at batch 16 and the 4 further 128-row shapes of a
   128->512 eval at batch 1, f32 and bf16 maps, both scale modes (int32
   accumulators and outputs bit-equal, one launch per call), with the
   times of Q1, its plain version, the dynamic scale's abs-max, the bound
   (int8 operations at 1979 TOP/s or bytes), and two yardsticks the port
   never calls
   (``torch._int_mm`` of the quantized im2col, cuDNN's bf16 conv), per
   eval beside the earlier mma.sync kernel that the wgmma kernel replaced;
   serving 64->256 at T=20, batch 16, on the plain forward without quant,
   with w8a8 and with w8a8s, in bf16 and f32 (img/s, 21 Q1 and 45 K1 launches
   per eval, each quantized output's relative RMS against the
   unquantized one); ``cli.infer`` with w8a8 on 2 images and its refusal
   of ``--fused``; a w8a8 train step against one on Q1's plain version,
   then 3 steps with and without quant (steps/s); a w8a8 DPM-Solver++
   export of 2 steps, loaded and run bit-equal to the in-process sampler
   with its fdsr::quant_conv3 node count; gn_swish_stats and gn_swish_dot
   against gn_swish_reference at the quantized Blocks' GroupNorm inputs,
   timed beside K1;
23. the exact rewrites (``FASTDIFFSR_TPU_UPSAMPLE``, ``_FOLD``,
   ``_SKIP_CONCAT``, ``_CONV_SPLIT``): the three Upsample forms (dense,
   tconv, d2s2) at the Upsample shapes of a 64->256 eval at batch 16 and
   of a 128->512 eval at batch 1, f32 and bf16, tconv and d2s2 against
   dense, each called twice bit-equal, device and wall ms; the plain
   forward of sr_fastdiffsr_test_64_256.json at full width, batch 16, f32
   and bf16, built by ``unet_from_config`` in each mode (literal, tconv,
   d2s2, fold down and all, skip_concat split and swap, conv_split on
   every ups_* block) from the same weights, each against the literal
   forward and run twice bit-equal, with ms per eval and K1 launches per
   forward; K1 against its plain version
   at every K1 shape the modes add (fold's 2C maps at batch 8 in twice the
   groups, the split parts); SR3, guided and ConditionalUNet with the
   builders' default tconv Upsample against the literal one; 3 train steps
   at batch 4 with tconv (the default) and with dense, from the same
   weights and step generators (steps/s, first losses equal).
24. NAFNet's layout modes (``FASTDIFFSR_TPU_NAF_DW=shift``,
   ``FASTDIFFSR_TPU_NAF_FOLD=enc|all``): the full-width NAFNet of phase
   16 built in each mode from the literal net's weights, at batch 2 on
   256x256: forward and train-step ms, max|dy| to the literal forward and
   a second call bit-equal (beside phases 16-17, as phase 25);
25. the native PNG/JPEG decoder (``fastdiffsr_tpu_torch.native``, built
   with g++ here; whether it built): seeded 256x256 PNG and JPEG folders
   read through ``LRHRDataset`` with it and with
   ``FASTDIFFSR_TPU_NO_NATIVE=1`` (PIL): seconds per image, PNG
   bit-equal, JPEG's max|d|;
26. ``train.steps_per_call`` as one CUDA-graph replay: on
   demo_ucm_native_8_64_s8hg.json (64x64, B=16; phase 18's rank runs
   sr_fastdiffsr_train_64_256.json, 256x256, B=4, under ``-dist``), a
   replay of 4 captured steps against 4 eager steps from the same state,
   the chain captured first (max|d| of parameters, EMA and l_pix,
   bit-equal or not, on cuDNN's deterministic algorithms), K1's launches
   per replay by kernel name in a torch.profiler trace; ``cli.sr_mfe``
   with ``FASTDIFFSR_TPU_STEPS_PER_CALL=4``, its step-12 checkpoint
   against the unchained run's (these two in a process of their own,
   ``--chain-worker``, as a training run is, started before phase 23 and
   running beside it); steps/s, peak GiB and the device idle share
   (torch.profiler) of each arm alone, chained and unchained.

Phases run in the order 1-11, 13, 14; then 12, 15, phase 18's plain
references, 20, 24 and 25 in the smoke's process while phases 16-17 run
in theirs (``--side-worker``) and phase 19's workers prepare (its
exporters and loaders on SERVING_CPUS of the host's cores); then 18,
19, 21, 22, 23 (beside 26's ``--chain-worker``), 26. No time on the ``kernels`` line is taken beside another
phase (phases 2-3, 6, 11, 13, 21 and 22 time the kernels, each alone on
the card); the rates of the phases in that window (phase 18's plain
runs, phase 19's in-process samplers) are read beside each other.

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
``--msi-only`` only phase 17, ``--dist-only`` only phase 18
(``--dist-worker <spec>`` is phase 18's rank, which torchrun starts) and
``--serving-only`` only phases 19-20 (``--serving-worker`` is a process
of phase 19), ``--demo-only`` only phase 21, ``--quant-only`` only
phase 22, ``--rewrites-only`` only phase 23 and ``--slice-only``
only phases 24-26.

The builders read the Upsample form from ``FASTDIFFSR_TPU_UPSAMPLE``
with JAX's default, tconv: every plain forward that a phase builds
through them (SR3, guided and ConditionalUNet too) runs the tconv
Upsample, whose transposed conv runs on cuDNN's deterministic algorithms
(``ops.tconv``), so the checks that hold two runs of one computation
bit-equal (phases 10, 19, 20, 22 and 23) hold it too. The fused forward
(K3) reads only the parameters.

Kernel times: ``ms`` is device time per call, the CUDA-event time of one
replay of a CUDA graph that holds REPS calls (no host time between the
launches); ``wall_ms`` is the CUDA-event time of REPS calls made from
Python, host gaps included. The plain versions and library calls are
timed the same two ways. (torch.profiler is not used here: after it has
run, kernel launches in the same process cost more host time.)

The line before the last is one JSON object of per-kernel numbers (K3
has two entries, one per hand-written kernel; ``kernel_route`` names the
kernel; ``*_512`` keys are per 128->512 eval, ``*_64`` keys per 64x64
eval at batch 1, K1's per 64x64 training forward at batch 16), every
number of it measured in this run or, for ``bound_ms``, computed from
this run's shapes; the last line is {"ok": true, "device":
{...}}. Per-shape details go to build/chip_smoke.json. Any failed check
exits non-zero. The ``[time]`` line says how long the run took, the
kernel build included: about seventeen to nineteen minutes on an H100.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12,   # H100 SXM, dense
              "int8": 1979e12}
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
# the val pack of phases 9 and 12: config.parse cuts the val set of
# -p train to 13 images, and this pack holds 3, so gdp's in-run
# validation takes 3 (PERF.md §4)
VAL_PACK_IMAGES = 3
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
VARIANT_PARITY = ("ddpm", "gdp")    # phase 12's train-step parity: one
                                    # per UNet (tesr's is ddpm's SR3)
# phase 12: cuDNN candidates timed per conv shape of the guided UNet
# (PyTorch's default, 10, took ~140 s of the phase on the H100; cut to
# make room for phases 24-26; PERF.md §4)
GDP_BENCHMARK_LIMIT = 3
# phase 12: the val sampler of each variant (ddpm's own ancestral T=1000
# runs in phase 19, in process and as the scan artifact, at full width)
VARIANT_VAL = {"ddpm": {"sampler": "ddim", "ddim_steps": 50},
               "tesr": {"sampler": "ddim", "ddim_steps": 50},
               "gdp": {"sampler": "ddim", "ddim_steps": 50}}
# phase 14: 128->512 images per type at batch 1; the first is set-up, and
# the other 5 make a steady window (cut to keep the run in its time limit)
INFER_512_IMAGES = 6
# phase 15: images per cli.fid directory: more than pool3's 2048 features,
# so both covariances have full rank (fewer than the Potsdam test set's
# 3272, SURVEY.md §3, to leave time for phase 23; PERF.md §4)
FID_IMAGES = 2100
FID_CHECK_IMAGES = 8   # phase 15: pool3 on the card against the CPU's
FID_FEAT_TOL = 1e-4    # |dpool3| <= tol * max|pool3| (the CPU tests')
FID_RTOL = 1e-3        # FID against the eigenvalue evaluation (the tests')
LPIPS_REPS = 10        # phase 9: timed LPIPS calls
# phase 16, EDiffSR: full-width training steps (batch 2, T=100; 16
# before phases 18-19 grew), the PNGs written per split, the in-run
# validation's images
EDIFFSR_STEPS = 8
EDIFFSR_TRAIN_IMAGES = 16
EDIFFSR_VAL_IMAGES = 2
EDIFFSR_IN_RUN_VAL = 2
# the same port code on the card and on the CPU: max|d| <= tol * max|y|
# (IEEE float32 on both; only the order of the sums differs)
EDIFFSR_CPU_TOL = 1e-4
# phase 17, MSI: full-width training steps per model (batch 1, crop 256,
# x4), the training tiles, the test set's classes and tiles per class,
# the odd-size test_single input (h, w; TransENet takes multiples of its
# 8x8 patches), GAN steps and batch, and the card-vs-CPU LR inputs
MSI_MODELS = ("SwinIR", "HAT", "HSENet", "TransENet", "NDSRGAN")
MSI_STEPS = 4        # cut to keep the run in its time limit
MSI_BY_CLASS = ("SwinIR",)  # --mode validateByClass (its code is the
                            # models'; each model's eval runs in train)
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
# phase 19, serving export: the cases (name, config, the fused forward's
# type, sampler, steps, the batches of its runs: the first run of the
# largest batch warms up, the later ones are timed; image indices count
# on over a case's runs), the round-trip bound (the JAX package's,
# tests/test_serving.py:72; both processes run the same kernels in the
# same order on cuDNN's heuristics, so 0 is expected, in bf16 too), K3
# calls per host-time reading, and the workers' time limit in seconds
SERVING_CASES = (
    ("f32", "sr_fastdiffsr_test_64_256", "f32", "ancestral", None,
     (16, 16, 3)),
    ("bf16", "sr_fastdiffsr_test_64_256", "bf16", "ancestral", None,
     (16, 16, 3)),
    ("dpm_f32", "sr_fastdiffsr_test_64_256", "f32", "dpm", 10, (2, 2)),
    ("bf16_512", "sr_fastdiffsr_infer_x4", "bf16", "ancestral", None,
     (1, 1, 1)),
    # the plain forward traces to ~2.5x the fused one's nodes per eval:
    # 5 evals check K1 through the artifact within the fused cases' time
    ("ddpm_ddim", "sr_ddpm_test_64_256", "f32", "ddim", 5, (2,)),
    # ddpm's own T=1000 ancestral sampler: the CLI exports it in the scan
    # form (one UNet eval in the graph, noise from seeds); one image
    ("ddpm_t1000", "sr_ddpm_test_64_256", "f32", "ancestral", None, (1,)),
    # the scan form forced at T=20 (build_sample_export(loop=True)), also
    # run through the f32 case's unrolled artifact on the noise it drew
    ("fastdiffsr_loop", "sr_fastdiffsr_test_64_256", "f32", "ancestral",
     None, (2, 2)),
)
# phase 19's cases in the scan form, those the CLI would not put in it,
# and the case whose unrolled artifact each forced one is held against;
# the cases whose in-process reference runs before the card's turns, while
# the exporters trace beside phases 12-17 (all: ~40 s off the phase's
# serial turns, ddpm's T=1000 ~24 of them; their in-process rates are read
# beside those phases)
SERVING_SCAN = ("ddpm_t1000", "fastdiffsr_loop")
SERVING_FORCED = {"fastdiffsr_loop": "f32"}
SERVING_EARLY_REF = tuple(c[0] for c in SERVING_CASES)
EXPORT_TOL = 1e-5
HOST_CALLS = 200
SERVING_TIMEOUT = 600
SERVING_NICE = 19   # phase 19's workers prepare beside phases 12-18,
SERVING_CPUS = 3    # its exporters and loaders on this many cores
GO_TIMEOUT = 1500   # a worker's wait for phase 19's go
SIDE_TIMEOUT = 900  # phases 16-17's process, from its start
DDPM_STEPS = 3      # phase 20: optimize_parameters calls
# phase 21, the demo path: seeded 64x64 source images prepared at both
# demo sizes in the three formats (by a pool of DEMO_WORKERS processes),
# DEMO_STEPS train steps per run at the config's batch, -p val of DEMO_VAL
# tiles
DEMO_SOURCES = 96
DEMO_SIDE = 64
DEMO_SIZES = ((8, 64),)     # the size the demo configs train on
DEMO_FORMATS = {"folder": "img", "pack": "npy", "lmdb": "lmdb"}
DEMO_WORKERS = 4
DEMO_STEPS = 12
DEMO_VAL = 4
# phase 23, the exact rewrites: the Upsample shapes (B, C, H) of a 64->256
# eval at batch 16 and of a 128->512 eval at batch 1; tconv and d2s2
# against the literal Upsample, |dy| <= tol * max(1, max|y|) (f32: the
# summation order and the summed 4x4 / 2x2 taps; bf16: four bf16 steps,
# as each form rounds its own summed taps to bf16); the plain forward's
# batch, timed evals per mode and type, and the modes (one rewrite each
# over the literal forms); timed train steps per Upsample form
UPS_SHAPES = ((16, 256, 32), (16, 256, 64), (16, 128, 128),
              (1, 256, 64), (1, 256, 128), (1, 128, 256))
UPS_TOL = {"f32": 2e-5, "bf16": 2 ** -6}
REWRITE_B = 16
REWRITE_EVALS = 2
REWRITE_MODES = ("literal", "tconv", "d2s2", "fold_down", "fold_all",
                 "split", "swap", "conv_split")
REWRITE_TRAIN_STEPS = 3
# phase 24, NAFNet's layout modes: (dw_mode, fold_mode) pairs, the
# literal first; batch, timed forwards and train steps per mode; |dy| to
# the literal forward <= tol * max(1, max|y|) (f32, summation order: the
# CPU tests' 1e-4)
NAF_MODES = (("", ""), ("shift", ""), ("", "enc"), ("", "all"))
NAF_B = 2
NAF_REPS = 5
NAF_STEPS = 3
NAF_TOL = 1e-4
# phase 25, the native decoder: seeded 256x256 pairs per format; JPEG
# native vs PIL max|d| in [-1, 1] units (two decoders of one file may
# round an IDCT or an upsampled chroma sample apart by a few levels)
DECODE_IMAGES = 48
DECODE_JPEG_TOL = 0.1
# phase 26, chained train steps: the configs, the chain, the device
# cache's tiles, replay vs eager max|d| of parameters and EMA and the
# relative max|d| of l_pix (JAX's stated 1e-6 for its chain: sound runs
# read 0, runs whose capture took other conv plans 1.9e-6 to 4.3e-6 in
# parameters and EMA, and l_pix 1.1e-6 to 7.2e-6 apart, 1.3e-6 relative
# where that was read; PERF.md §6), the EMA's
# start, timed steps per arm (a few seconds each) and profiled steps, the
# CLI runs' steps, the chain worker's time limit in seconds
# phase 26 runs the demo config; phase 18's rank runs the train config
# (256x256) under -dist: the same capture of the bare net, in a fresh
# process, with its CLI pair
CHAIN_CONFIGS = ("demo_ucm_native_8_64_s8hg",)
DIST_CHAIN_CONFIG = "sr_fastdiffsr_train_64_256"
CHAIN_N = 4
CHAIN_TILES = 64
CHAIN_TOL = 1e-6
CHAIN_EMA_START = 6
CHAIN_TIMED = {"demo_ucm_native_8_64_s8hg": 32}
CHAIN_PROFILED = 4
CHAIN_CLI_STEPS = 12
CHAIN_TIMEOUT = 400


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
                args, i = [], 1 if rest.startswith("I") else len(rest)
                while t := re.match(r"Li(\d+)E|f|13__nv_bfloat16", rest[i:]):
                    args.append(t.group(1) or ("f32" if t.group(0) == "f"
                                               else "bf16"))
                    i += t.end()
                return name + "<" + ",".join(args) + ">"
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


def record_k1_batch(fn):
    """Run ``fn`` and return its output, the distinct K1 call signatures
    (B, H, W, C, groups) with their call counts, and how many K1 calls got
    a map that is not a contiguous NHWC tensor."""
    from fastdiffsr_tpu_torch.ops.groupnorm import gn_swish_custom
    sigs, strided = {}, [0]

    def rec(h, scale, bias, groups, eps=1e-5):
        sig = (*h.shape, groups)
        sigs[sig] = sigs.get(sig, 0) + 1
        strided[0] += not h.is_contiguous()
        return gn_swish_custom(h, scale, bias, groups, eps)

    with patched_k1(rec):
        out = fn()
    return out, sigs, strided[0]


def record_k1(net, x, level):
    """Run one forward of ``net`` and return the distinct K1 call
    signatures (H, W, C, groups) with their call counts, and how many
    K1 calls got a map that is not a contiguous NHWC tensor."""
    import torch
    with torch.no_grad():
        _, by_batch, strided = record_k1_batch(lambda: net(x, level))
    sigs = {}
    for sig, n in by_batch.items():
        sigs[sig[1:]] = sigs.get(sig[1:], 0) + n
    return sigs, strided


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


def phase_train_parity(cfg, B, card, seed, tag=None):
    """One full-width train step with the K1 norms on K1 and on
    gn_swish_reference, from the same weights (randomized for the SR3
    and guided UNets), batch and injected draws, dropout off, Adam with
    eps STEP_ADAM_EPS. The loss has the config's SSIM term where it sets
    one (``model.diffusion.aux_ssim_weight``); then the term is printed
    beside the L1 term of the same draws and weights. ``tag`` names the
    run in the printed lines (default: the variant)."""
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
    diff = cfg["model"].get("diffusion") or {}
    aux_w = float(diff.get("aux_ssim_weight") or 0.0)
    eng = DiffusionEngine(spec, ScheduleBuffers.create(
        cfg["model"]["beta_schedule"]["train"], device=dev),
        aux_ssim_weight=aux_w,
        aux_ssim_gamma_pow=float(diff.get("aux_ssim_gamma_pow") or 0.0))
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
    terms = None
    if aux_w:
        # the loss with the term and the L1 term alone, on the same draws
        l1_eng = DiffusionEngine(spec, eng.buffers)
        with torch.no_grad():
            total_l, l1 = (e.training_loss(net.train(), batch, None,
                                           noise=noise, **draws).item()
                           for e in (eng, l1_eng))
        terms = {"l_pix": total_l, "l1": l1, "aux": (total_l - l1) / aux_w,
                 "aux_weight": aux_w}
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
    label = (f" {tag}" if tag else
             "" if variant == "fastdiffsr" else f" {variant}")
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
    if terms:
        print(f"[train step{label} terms] {card} | the K1 step's loss "
              f"{terms['l_pix']:.6f} = L1 {terms['l1']:.6f} + "
              f"{aux_w} x SSIM term {terms['aux']:.6f} (mean of "
              f"gamma^{eng.aux_ssim_gamma_pow:g} (1 - SSIM) of the decoded "
              f"x0_hat)", flush=True)
    del out, a, b
    torch.cuda.empty_cache()
    return {"variant": variant, "rel_loss": d_loss, "rel_grad_norm": d_gn,
            "rel_grad": d_grad, "max_abs_grad_gap": dg_abs,
            "adam_eps": STEP_ADAM_EPS, "param_max_over_lr": d_par / lr,
            "share_moved_over_tol": moved, "terms": terms, "ok": ok}, ok


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
    vroot = write_pack(os.path.join(work, f"val_pack_{seed}"),
                       VAL_PACK_IMAGES, seed + 8, int(ds["l_resolution"]),
                       int(ds["r_resolution"]))
    cfg = json.loads(json.dumps(cfg))
    cfg["name"] = f"chip_smoke_train{label.replace(' ', '_')}"
    cfg["datasets"]["train"].update(dataroot=droot, datatype="npy",
                                    batch_size=B_TRAIN)
    cfg["datasets"]["val"].update(dataroot=vroot, datatype="npy",
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
    in_evals = (evals_per_image(cfg) * min(13, VAL_PACK_IMAGES)
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
              f"steps, {min(13, VAL_PACK_IMAGES)} images, "
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
                "channel_stats": 4 * n_eval, "gn_swish": 0, "quant_conv3": 0}
        want_routes = {"wgmma": 0, "cuda_cores": 49 * n_eval}
    else:
        want = {"fused_gn_swish_conv3x3": 0, "channel_stats": 0,
                "gn_swish": K1_PER_FORWARD[variant] * n_eval, "quant_conv3": 0}
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
             "channel_stats": 4 * n_eval, "gn_swish": 0, "quant_conv3": 0},
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
            want, want_again = [fn(lambda x, lv: net(x, lv), cond,
                                   steps=SAMPLER_STEPS, init_noise=init)
                                for _ in range(2)]
        control = fn(lambda x, lv: fused_apply(fp_bf16, x, lv), cond,
                     steps=SAMPLER_STEPS, init_noise=init)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_control = (control - want).abs().max().item()
        gains = sampler_gains(eng.buffers.alphas_cumprod.cpu().numpy(),
                              SAMPLER_STEPS, name)
        tol = SAMPLER_EPS_GAP * float(gains.sum())
        repeat = torch.equal(want, want_again)
        row_ok = (err <= tol < err_control and repeat
                  and bool(torch.isfinite(got).all()))
        ok &= row_ok
        print(f"[sampler {name}] {card} | sample_{name} B={B_SAMPLER} "
              f"256x256, {SAMPLER_STEPS} steps from the same initial noise: "
              f"fused f32 (K3 on CUDA cores, K2) vs plain UNet on "
              f"gn_swish_reference max|d|={err:.3g} (tol {tol:.3g} = "
              f"{SAMPLER_EPS_GAP} per eval x the steps' summed gain "
              f"{gains.sum():.4g}, largest {gains.max():.4g}); control, "
              f"fused bf16 vs the same plain run, max|d|={err_control:.3g} "
              f"(must exceed the tol); the plain UNet ({net.upsample_mode} "
              f"Upsample, the builder's default) run again bit-equal "
              f"{repeat} {'ok' if row_ok else 'FAIL'}", flush=True)
        detail[f"{name}_fused_vs_plain"] = {
            "max_abs_err": err, "tol": tol,
            "control_bf16_max_abs_err": err_control,
            "plain_upsample": net.upsample_mode, "plain_repeat_equal": repeat}
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
    import torch

    for variant in ("ddpm", "tesr", "gdp"):
        cfg = variant_cfg(variant)
        # the parity step meets the UNet's conv shapes first and times
        # them for the CLI run after it; gdp's among GDP_BENCHMARK_LIMIT
        # candidates each (PERF.md §4)
        # (tesr's UNet is ddpm's SR3: its parity step is ddpm's)
        limit = torch.backends.cudnn.benchmark_limit
        if variant == "gdp":
            torch.backends.cudnn.benchmark_limit = GDP_BENCHMARK_LIMIT
        try:
            s_ok = True
            if variant in VARIANT_PARITY:
                detail[f"{variant}_step"], s_ok = phase_train_parity(
                    cfg, B_TRAIN, card, seed)
        finally:
            torch.backends.cudnn.benchmark_limit = limit
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
         "gn_swish": K1_PER_FORWARD["ddpm"] * 20, "quant_conv3": 0})
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
             "channel_stats": 4 * n_eval, "gn_swish": 0, "quant_conv3": 0},
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

    def single(name, ckpt, row):
        """``--mode test_single`` on an odd-size PNG into ``row``."""
        nonlocal ok
        h, w = MSI_SINGLE.get(name, MSI_SINGLE_DEFAULT)
        out_png = os.path.join(work, f"{name}_single.png")
        _, wall, peak = run(name, "--mode", "test_single", "--resume", ckpt,
                            "--input", dirs[(h, w)], "--output", out_png)
        sr = load_img(out_png)
        s_ok = sr.shape == (4 * h, 4 * w, 3)
        ok &= s_ok
        print(f"[msi test_single {name}] {card} | {w}x{h} PNG -> "
              f"{sr.shape[1]}x{sr.shape[0]}, batch 1: wall {wall:.2f} s "
              f"(set-up included) | peak {peak:.2f} GiB "
              f"{'ok' if s_ok else 'FAIL'}", flush=True)
        row["test_single"] = {"in_hw": [h, w], "out_shape": list(sr.shape),
                              "wall_s": wall, "peak_gib": peak}

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

        detail[name] = row
        if name not in MSI_BY_CLASS:
            single(name, summ["checkpoint"], row)
            continue
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
        single(name, summ["checkpoint"], row)

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


def side_worker(seed) -> int:
    """Phases 16-17 (EDiffSR, MSI) in a process of their own
    (``--side-worker``), which the smoke runs beside its phases 12, 15,
    20, 24-25 and phase 18's plain references (``start_side``): no kernel
    of ours is on their paths and nothing of theirs feeds the ``kernels``
    line, so their checks hold as alone while their rates are read beside
    those phases. Prints the phases' lines,
    then one line ``SIDE_RESULT {ediffsr, msi, ok, seconds}``."""
    import torch

    sys.path.insert(0, ROOT)
    from fastdiffsr_tpu_torch.device import use_ieee_float32
    from fastdiffsr_tpu_torch.ops import kernels

    use_ieee_float32()
    own_phases_regime()
    kernels.load()
    card = card_line()
    t0 = time.time()
    res = {}
    res["ediffsr"], e_ok = phase_ediffsr(card, seed)
    res["seconds"] = {"16 ediffsr": time.time() - t0}
    gc.collect()
    torch.cuda.empty_cache()
    res["msi"], m_ok = phase_msi(card, seed)
    res["seconds"]["17 msi"] = time.time() - t0 - res["seconds"][
        "16 ediffsr"]
    res["ok"] = {"ediffsr": bool(e_ok), "msi": bool(m_ok)}
    print("SIDE_RESULT " + json.dumps(res, default=str), flush=True)
    return 0 if e_ok and m_ok else 1


def start_side(seed):
    """Start ``side_worker`` (phases 16-17) in the background; returns
    (process, log path, start time) for ``join_side``."""
    import atexit
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    log_path = os.path.join(work, "side.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--side-worker", "--seed", str(seed)], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True)
    if not _BACKGROUND:
        atexit.register(_stop_background)
    _BACKGROUND.append(proc)
    return proc, log_path, time.time()


def join_side(side, card, timeout=SIDE_TIMEOUT):
    """Wait for ``start_side``'s process (killing it after ``timeout``
    from its start), print its phase lines; returns (detail of phase 16,
    of phase 17, seconds of each, ok)."""
    proc, log_path, t0 = side
    t_wait = time.time()
    try:
        rc = proc.wait(timeout=max(1.0, timeout - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    with open(log_path) as f:
        lines = f.read().splitlines()
    for line in lines:
        if line.startswith("[ediffsr") or line.startswith("[msi"):
            print(line, flush=True)
    result = [json.loads(line[len("SIDE_RESULT "):]) for line in lines
              if line.startswith("SIDE_RESULT ")]
    ok = bool(result) and rc == 0 and all(result[0]["ok"].values())
    print(f"[side] {card} | phases 16-17 in a process of their own beside "
          f"phases 12, 15, 20, 24-25 and 18's plain runs: exit {rc}, {time.time() - t0:.1f} s from its "
          f"start, the smoke waited {time.time() - t_wait:.1f} s for it "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not result or rc != 0:
        print("\n".join(lines[-40:]), flush=True)
    res = result[0] if result else {"ediffsr": {}, "msi": {}, "seconds": {}}
    return res["ediffsr"], res["msi"], res["seconds"], ok


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
    join the group from torchrun's variables (NCCL); first, while the
    process's memory is fresh (in a long process's memory a capture took
    other cuDNN plans, PERF.md §6), the chained train step under the
    group on the train config, the state DDP-wrapped as under ``-dist``:
    a replay of CHAIN_N captured steps (the bare net, its gradients'
    all-reduce in the graph) against unchained DDP steps with a profile
    of the replay, and ``cli.sr_mfe -p train -dist`` chained against
    unchained (steps/s, reserved GiB); then the ``-dist`` jobs and the
    all-reduce timing. Writes the results for phase_dist."""
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
    own_phases_regime()
    card = card_line()
    out["chain"] = {}
    out["chain"]["parity"], p_ok = chain_parity(DIST_CHAIN_CONFIG, card,
                                                spec["seed"], " -dist")
    out["chain"]["cli"], c_ok = chain_cli(DIST_CHAIN_CONFIG, card,
                                          spec["seed"], dist=True)
    out["chain_ok"] = p_ok and c_ok
    out["chain_s"] = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
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


def dist_refs(seed, beside=""):
    """Phase 18's inputs and its plain reference runs in this process
    (``beside``: the phases they ran beside, for the printed rates);
    returns what ``phase_dist`` takes as ``pre``."""
    t0 = time.time()
    spec = dist_specs(seed)
    refs = run_jobs(dist_jobs(spec, dist=False))
    own_phases_regime()
    return {"spec": spec, "refs": refs, "beside": beside,
            "seconds": time.time() - t0}


def phase_dist(card, seed, pre=None):
    """Phase 18: data parallelism under torchrun at world size 1 on the
    card (module docstring), its plain references from ``pre``
    (``dist_refs``; run here if None). Returns (detail, launches of the
    kernels in it by name and K3 route, ok)."""
    import signal

    import numpy as np
    import torch

    from fastdiffsr_tpu_torch.cli import sr_mfe
    from fastdiffsr_tpu_torch.metrics import load_img
    from fastdiffsr_tpu_torch.ops import fused_conv, kernels

    t_phase = time.time()
    pre = pre or dist_refs(seed)
    spec, refs = pre["spec"], pre["refs"]
    without = f"without ({pre['beside']})" if pre["beside"] else "without"
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
    with open(log_path) as f:
        for line in f:
            if line.startswith("[chain"):
                print(line.rstrip(), flush=True)
    jobs = res["jobs"]
    ok = (res["backend"] == "nccl" and res["world"] == 1
          and res["device"] == "cuda:0" and res["chain_ok"])
    print(f"[dist] {card} | torch.distributed.run --standalone "
          f"--nproc_per_node=1: backend {res['backend']} (NCCL "
          f"{res['nccl']}), world {res['world']}, rank 0 on {res['device']},"
          f" the worker took {worker_wall:.1f} s (process start, NCCL init "
          f"and cuDNN's timing included) {'ok' if ok else 'FAIL'}",
          flush=True)
    detail = {"backend": res["backend"], "world": res["world"],
              "nccl": res["nccl"], "worker_wall_s": worker_wall,
              "allreduce_ms": res["allreduce_ms"],
              "n_params": res["n_params"], "buckets": res["buckets"],
              "chain": res["chain"], "chain_s": res["chain_s"]}

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
            "fused_gn_swish_conv3x3": 49 * n_val, "channel_stats": 4 * n_val,
            "quant_conv3": 0}
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
          f"{p_rate:.3f} {without} ({d_rate / p_rate:.4f}) | all-reduce of "
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
              f"{d_rate:.3f} steps/s with DDP, {p_rate:.3f} {without} "
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
    detail["refs_seconds"] = pre["seconds"]
    return detail, launches, ok


def serving_spec(seed):
    """Phase 19's cases as the workers read them: per case its config,
    variant, forward type, sampler, steps and run batches, and the files
    it writes (artifact, in-process inputs and outputs, the loader's)."""
    from fastdiffsr_tpu_torch.config import load_json_config

    work = os.path.join(ROOT, "build", "smoke", "serving")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cases = []
    for k, (name, cfg, dt, sampler, steps, runs) in enumerate(SERVING_CASES):
        config = os.path.join(ROOT, "fastdiffsr_tpu_torch", "configs",
                              f"{cfg}.json")
        cases.append({
            "name": name, "dtype": dt, "sampler": sampler, "steps": steps,
            "runs": list(runs), "turn": k + 1, "config": config,
            "scan": name in SERVING_SCAN,
            "unrolled_twin": SERVING_FORCED.get(name),
            "variant": load_json_config(config)["model"]["which_model_G"],
            "artifact": os.path.join(work, f"sampler_{name}.pt2"),
            # the DPM artifact is also saved for the CPU (serving's
            # move_to_device_pass), which its loader runs on image 0
            "platforms": "cuda,cpu" if name == "dpm_f32" else "cuda",
            "cpu_artifact": os.path.join(work, f"sampler_{name}.cpu.pt2"),
            # f32 and bf16 of one config and sampler share their inputs
            "inputs": os.path.join(
                work, f"inputs_{cfg}_{sampler}_{steps}"
                      f"{'_scan' if name in SERVING_SCAN else ''}.pt"),
            "export_out": os.path.join(work, f"export_{name}.json"),
            "ref_out": os.path.join(work, f"ref_{name}.pt"),
            "load_out": os.path.join(work, f"load_{name}.pt"),
            "twin_out": os.path.join(work, f"twin_{name}.pt")})
    return {"work": work, "seed": seed, "cases": cases,
            "ref_json": os.path.join(work, "ref.json")}


def _marker(spec, what, k):
    return os.path.join(spec["work"], f"{what}_{k}")


def _await(paths, timeout=SERVING_TIMEOUT):
    t0 = time.time()
    while not all(os.path.exists(p) for p in paths):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"waited {timeout} s for {paths}")
        time.sleep(0.1)


@contextlib.contextmanager
def gpu_turn(spec, k):
    """Every worker of phase 19 prepares (exports, loads or builds) at
    once, then, once the smoke writes the ``go`` marker (when it reaches
    phase 19: the workers may start phases earlier, ``start_serving``),
    they take the card in turns (k = 0 the in-process reference, then the
    loaders in case order), so no timed run shares the host with another
    worker's work or the card with another phase."""
    n = len(spec["cases"]) + 1
    with open(_marker(spec, "ready", k), "w"):
        pass
    try:
        _await([_marker(spec, "ready", j) for j in range(n)],
               timeout=GO_TIMEOUT)
        _await([_marker(spec, "go", 0)], timeout=GO_TIMEOUT)
        if k:
            _await([_marker(spec, "done", k - 1)])
        yield
    finally:
        with open(_marker(spec, "done", k), "w"):
            pass


def timed_run(fn):
    """(output, host seconds, launch counts, K3 launches by route) of one
    call, the counters read just before and just after."""
    import torch

    from fastdiffsr_tpu_torch.ops import fused_conv, kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    routes0 = dict(fused_conv.ROUTE_TAKEN)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, dict(kernels.LAUNCHES), {
        r: n - routes0[r] for r, n in fused_conv.ROUTE_TAKEN.items()}


def forced_scan_export(case) -> dict:
    """``serving.export_sampler(loop=True)`` of a case, in float32 on the
    card (the CLI takes the scan form above MAX_EXPORT_STEPS evals only),
    with the numbers ``serving.main`` returns."""
    import torch

    from fastdiffsr_tpu_torch import serving
    from fastdiffsr_tpu_torch.config import parse
    from fastdiffsr_tpu_torch.device import use_ieee_float32
    use_ieee_float32()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    _, meta, *_ = serving.export_sampler(
        parse(case["config"], phase="val"), case["artifact"],
        sampler=case["sampler"], steps=case["steps"], platforms=["cuda"],
        loop=True)
    return {"paths": [case["artifact"]], "export_s": time.time() - t0,
            "meta": meta, "selftest_err": None,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "mb": [os.path.getsize(case["artifact"]) / 1e6]}


def serving_export_worker(spec, case) -> int:
    """Phase 19: ``fastdiffsr_tpu_torch.serving``'s CLI (its ``main``)
    exports one case; the f32 64->256 case with ``--selftest``, the
    acceptance command; a forced scan form through ``export_sampler``."""
    sys.path.insert(0, ROOT)
    from fastdiffsr_tpu_torch import serving
    if case["unrolled_twin"]:
        res = forced_scan_export(case)
    else:
        argv = ["-c", case["config"], "-o", case["artifact"], "--dtype",
                case["dtype"], "--sampler", case["sampler"], "--platforms",
                case["platforms"]]
        if case["steps"]:
            argv += ["--steps", str(case["steps"])]
        if case["name"] == "f32":
            argv.append("--selftest")
        res = serving.main(argv)
        res["argv"] = argv
    with open(case["export_out"], "w") as f:
        json.dump(res, f, default=str)
    return 0


def serving_reference_worker(spec) -> int:
    """Phase 19, turn 0: the in-process sampler of every case (a fresh
    process, cuDNN on its heuristics as ``cli.infer``), on the forward
    ``cli.infer.resolve_fused`` picks, each run's images with their own
    generators (``pad_batch_with_keys``, indices counted over the case's
    runs). Before its turn it writes the inputs the loaders feed the
    artifacts: the same params, cond and the noise ``serving.draw_noise``
    draws from the same generators, or for a scan-form case the seeds
    ``serving.draw_seeds`` draws from them (and, for a forced one, the
    noise ``counter_noise`` makes of them, which the unrolled twin is
    fed); a scan-form case's in-process sampler is fed that noise. The
    cases of SERVING_EARLY_REF run before the turns, beside the exporters
    and the phases the smoke runs meanwhile (their in-process seconds are
    read under that load); the ``early`` marker says they are done."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from fastdiffsr_tpu_torch import serving
    from fastdiffsr_tpu_torch.cli.infer import (build_all, make_denoiser,
                                                resolve_fused)
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.device import (set_cudnn_autotuning,
                                             use_ieee_float32)
    from fastdiffsr_tpu_torch.diffusion import counter_noise
    from fastdiffsr_tpu_torch.train import make_sample_fn, pad_batch_with_keys

    use_ieee_float32()
    set_cudnn_autotuning(False)

    def counter_draws(gens, shape, draws, by_t):
        """(seeds, init_noise, noise_seq) of a scan-form case."""
        seeds = serving.draw_seeds(gens, "cuda")
        return (seeds, *counter_noise(seeds, draws, tuple(shape), by_t))

    seed = spec["seed"]
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    prepared = []
    for case in spec["cases"]:
        opt = load_json_config(case["config"])
        # the seeded parameters serving.main's export_sampler builds
        eng, net = build_all(opt, device="cuda", seed=0)
        r = int(opt["datasets"]["val"]["r_resolution"])
        sample = make_sample_fn(
            eng, make_denoiser(net, resolve_fused(case["variant"], None),
                               dtypes[case["dtype"]]),
            sampler=case["sampler"], ddim_steps=case["steps"])
        _, draws, by_t = serving._plan(eng, case["sampler"], case["steps"],
                                       0.0)
        runs, start = [], 0
        for b in case["runs"]:
            cond = np.random.default_rng([seed, start]).uniform(
                -1, 1, (b, r, r, 3)).astype(np.float32)
            runs.append((cond, start))
            start += b
        if not os.path.exists(case["inputs"]):
            feed = []
            for cond, start in runs:
                cond_t, gens = pad_batch_with_keys(cond, len(cond), seed,
                                                   start, device="cuda")
                if not case["scan"]:
                    init, seq = serving.draw_noise(gens, cond.shape[1:],
                                                   draws, by_t, "cuda")
                    feed.append({"cond": cond_t, "init": init, "seq": seq})
                    continue
                seeds, init, seq = counter_draws(gens, cond.shape[1:], draws,
                                                 by_t)
                feed.append({"cond": cond_t, "seeds": seeds})
                if case["unrolled_twin"]:
                    feed[-1].update(init=init, seq=seq)
            params = {k: v.detach() for k, v in net.state_dict().items()}
            tmp = case["inputs"] + ".tmp"
            torch.save({"params": params, "runs": feed}, tmp)
            os.replace(tmp, case["inputs"])
        prepared.append((case, sample, runs, draws, by_t))

    def run_case(case, sample, runs, draws, by_t):
        outs, rows = [], []
        for cond, start in runs:
            cond_t, gens = pad_batch_with_keys(cond, len(cond), seed, start,
                                               device="cuda")
            if case["scan"]:
                _, init, seq = counter_draws(gens, cond.shape[1:], draws,
                                             by_t)
                out, dt, launches, routes = timed_run(
                    lambda: sample(cond_t, init_noise=init, noise_seq=seq))
                del init, seq
            else:
                out, dt, launches, routes = timed_run(
                    lambda: sample(cond_t, gens))
            outs.append(out.cpu())
            rows.append({"batch": len(cond), "s": dt, "launches": launches,
                         "routes": routes})
        torch.save(outs, case["ref_out"])
        return rows

    # the long reference runs while the exporters trace, off the turns
    res = {c["name"]: run_case(c, *rest) for c, *rest in prepared
           if c["name"] in SERVING_EARLY_REF}
    open(_marker(spec, "early", 0), "a").close()
    with gpu_turn(spec, 0):
        for case, *rest in prepared:
            if case["name"] not in res:
                res[case["name"]] = run_case(case, *rest)
    with open(spec["ref_json"], "w") as f:
        json.dump(res, f)
    return 0


def serving_load_worker(spec, case) -> int:
    """Phase 19: a fresh process that imports torch and the port's op
    registry (``fastdiffsr_tpu_torch.ops``) and nothing else of the port,
    loads one artifact with ``torch.export.load`` once its export is
    written, runs the CPU copy (if any) before its turn and the artifact
    on the reference's inputs in its turn (a scan-form artifact on the
    seeds); an unrolled artifact that a forced scan form is held against
    also runs, after its own runs, on the noise the scan form drew."""
    import torch

    sys.path.insert(0, ROOT)
    import fastdiffsr_tpu_torch.ops  # noqa: F401  (the op registry)

    # as the reference: full float32, cuDNN's heuristics
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    _await([_marker(spec, "exported", case["turn"])], timeout=GO_TIMEOUT)
    if not os.path.exists(case["export_out"]):
        raise RuntimeError(f"{case['name']}: the export failed")
    t0 = time.time()
    extra = {"fdsr_sampler.json": ""}
    ep = torch.export.load(case["artifact"], extra_files=extra)
    module = ep.module()
    load_s = time.time() - t0
    _await([case["inputs"]])
    feed = torch.load(case["inputs"])
    res = {"load_s": load_s, "meta": json.loads(extra["fdsr_sampler.json"]),
           "rows": []}
    outs = []
    cpu_out = None
    if "," in case["platforms"]:
        # the CPU copy beside it: image 0 of the first run (the kernels'
        # plain versions), full float32, while the other workers prepare
        t0 = time.time()
        cpu_copy = torch.export.load(case["cpu_artifact"]).module()
        cpu_load_s = time.time() - t0
        run = feed["runs"][0]
        args = ({k: v.cpu() for k, v in feed["params"].items()},
                run["cond"][:1].cpu(), run["init"][:1].cpu())
        t0 = time.time()
        with torch.no_grad():
            cpu_out = cpu_copy(*args)
        res["cpu_copy"] = {"load_s": cpu_load_s, "s": time.time() - t0,
                           "device": str(cpu_out.device)}
    twins = [c for c in spec["cases"]
             if c["unrolled_twin"] == case["name"]]
    _await([c["inputs"] for c in twins])
    with gpu_turn(spec, case["turn"]):
        for run in feed["runs"]:
            if case["scan"]:
                args = (feed["params"], run["cond"], run["seeds"])
            else:
                args = (feed["params"], run["cond"], run["init"])
                if run["seq"] is not None:
                    args += (run["seq"],)
            with torch.no_grad():
                out, dt, launches, routes = timed_run(lambda: module(*args))
            outs.append(out.cpu())
            res["rows"].append({"batch": run["cond"].shape[0], "s": dt,
                                "launches": launches, "routes": routes})
        for twin in twins:
            tw = torch.load(twin["inputs"])
            t_outs, t_rows = [], []
            for run in tw["runs"]:
                args = (tw["params"], run["cond"], run["init"], run["seq"])
                with torch.no_grad():
                    out, dt, launches, _ = timed_run(lambda: module(*args))
                t_outs.append(out.cpu())
                t_rows.append({"batch": run["cond"].shape[0], "s": dt,
                               "launches": launches})
            torch.save({"outs": t_outs, "rows": t_rows}, twin["twin_out"])
    if cpu_out is not None:
        outs.append(cpu_out)
    res["port_modules"] = sorted(m for m in sys.modules
                                 if m.split(".")[0].startswith(
                                     "fastdiffsr_tpu"))
    res["jax"] = "jax" in sys.modules
    torch.save({"outs": outs, "res": res}, case["load_out"])
    return 0


def serving_worker(role, spec_path, name) -> int:
    # below the smoke's own phases on the host while it prepares beside
    # them (start_serving); alone on the host in its turn
    os.nice(SERVING_NICE)
    with open(spec_path) as f:
        spec = json.load(f)
    if spec.get("cpus") and role in ("export", "load"):
        os.sched_setaffinity(0, spec["cpus"])
    case = next((c for c in spec["cases"] if c["name"] == name), None)
    if role == "export":
        try:
            return serving_export_worker(spec, case)
        finally:
            # its loader waits for this, whether the export worked or not
            open(_marker(spec, "exported", case["turn"]), "a").close()
    k = 0 if role == "reference" else case["turn"]
    try:
        if role == "reference":
            return serving_reference_worker(spec)
        return serving_load_worker(spec, case)
    finally:
        # a worker that fails before or in its turn lets the others go on
        for what in ("ready", "done") + (("early",) if k == 0 else ()):
            open(_marker(spec, what, k), "a").close()


_BACKGROUND = []        # processes started ahead of their phase


def _stop_background():
    """Kill what a background process (and its group) left running: a
    smoke that fails or returns early stops every process it started."""
    for proc in _BACKGROUND:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()


def start_workers(spec_path, jobs, work):
    """Start ``jobs`` ((role, name) pairs) as processes of this script at
    once; returns [(role, name, log, process)]."""
    import atexit
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = []
    for role, name in jobs:
        log = open(os.path.join(work, f"{role}_{name}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--serving-worker", role, spec_path, name], cwd=work,
            stdout=log, stderr=subprocess.STDOUT, env=env,
            start_new_session=True)
        if not _BACKGROUND:
            atexit.register(_stop_background)
        _BACKGROUND.append(proc)
        procs.append((role, name, log, proc))
    return procs


def wait_workers(procs, t0, timeout=SERVING_TIMEOUT):
    """Wait for ``start_workers``' processes (killing what outlives
    ``timeout`` from now); returns {(role, name): (exit code, seconds
    since ``t0``, log tail)}."""
    t_wait = time.time()
    out = {}
    for role, name, log, proc in procs:
        try:
            rc = proc.wait(timeout=max(1.0, timeout - (time.time() - t_wait)))
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        log.close()
        with open(log.name) as f:
            tail = f.read()[-3000:]
        out[(role, name)] = (rc, time.time() - t0, tail)
    return out


def serving_alphas(config):
    """alpha-bar of a config's val schedule, for sampler_gains."""
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.diffusion import ScheduleBuffers
    sched = load_json_config(config)["model"]["beta_schedule"]["val"]
    return ScheduleBuffers.create(sched, device="cpu").alphas_cumprod.numpy()


def op_host_us(seed):
    """Host microseconds per K3 call at one bf16 block of a 128->512 eval
    (64x64, 256 -> 256 channels, batch 1), HOST_CALLS calls per reading:
    the direct wrapper and its registered operator (what an exported
    program calls), in turns direct, operator, operator, direct."""
    import torch

    from fastdiffsr_tpu_torch.ops.fused_conv import fused_gn_swish_conv3x3
    from fastdiffsr_tpu_torch.ops.groupnorm import channel_stats

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, 64, 64, 256), generator=g, device="cuda").to(
        torch.bfloat16)
    st = channel_stats(x)
    w = (torch.randn((3, 3, 256, 256), generator=g, device="cuda")
         * 0.02).to(torch.bfloat16)
    b = torch.zeros(256, device="cuda")
    sc, bi = torch.ones(256, device="cuda"), torch.zeros(256, device="cuda")
    shift = torch.zeros((1, 256), device="cuda")
    calls = {
        "direct": lambda: fused_gn_swish_conv3x3(x, sc, bi, st, w, b,
                                                 shift=shift, groups=32),
        "op": lambda: torch.ops.fdsr.fused_gn_swish_conv3x3(
            [x], sc, bi, [st], w, b, shift, None, 32, 1e-5, True, True)}
    got = {k: [] for k in calls}
    for name in ("direct", "op", "op", "direct"):
        fn = calls[name]
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        got[name].append((t1 - t0) / HOST_CALLS * 1e6)
    return got


def serving_want(case, evals):
    """Launches per call of the case's sampler: 49 K3 and 4 K2 per eval on
    the fused forward, K1_PER_FORWARD of the variant on the plain one."""
    if case["variant"] == "fastdiffsr":
        return {"fused_gn_swish_conv3x3": 49 * evals,
                "channel_stats": 4 * evals, "gn_swish": 0, "quant_conv3": 0}
    return {"fused_gn_swish_conv3x3": 0, "channel_stats": 0,
            "gn_swish": K1_PER_FORWARD[case["variant"]] * evals,
            "quant_conv3": 0}


def serving_cpus():
    """The last SERVING_CPUS of the cores this process may run on, where
    that leaves at least 5 to the rest (else None: any)."""
    cpus = sorted(os.sched_getaffinity(0))
    return (set(cpus[-SERVING_CPUS:]) if len(cpus) >= SERVING_CPUS + 5
            else None)


def start_serving(seed, cpus=None):
    """Phase 19's workers, started ahead of the phase (niced to
    SERVING_NICE; the exporters and loaders on ``cpus``): every one at
    once, the exports; the reference preparing, then running
    SERVING_EARLY_REF; each loader waiting for its export, then loading;
    then they wait for the ``go`` marker that ``phase_serving`` writes,
    and take the card in turns. Returns the pool ``phase_serving`` and
    ``await_early_reference`` take."""
    spec = serving_spec(seed)
    spec["cpus"] = sorted(cpus) if cpus else None
    spec_path = os.path.join(spec["work"], "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    names = [c["name"] for c in spec["cases"]]
    t0 = time.time()
    procs = start_workers(spec_path, [("export", n) for n in names]
                          + [("reference", "-")]
                          + [("load", n) for n in names], spec["work"])
    return {"spec": spec, "procs": procs, "t0": t0, "cpus": spec["cpus"]}


def await_early_reference(pool, card, timeout=SERVING_TIMEOUT):
    """Wait until phase 19's reference worker has run SERVING_EARLY_REF
    (the ``early`` marker), so that no phase that follows shares the
    card with it; prints how long the smoke waited."""
    t0 = time.time()
    try:
        _await([_marker(pool["spec"], "early", 0)], timeout=timeout)
        done = True
    except TimeoutError:
        done = False
    print(f"[serve export] {card} | phase 19's in-process references "
          f"({len(SERVING_EARLY_REF)} cases) "
          f"{'done' if done else 'NOT done'}, {time.time() - pool['t0']:.1f}"
          f" s after its workers started; the smoke waited "
          f"{time.time() - t0:.1f} s for them", flush=True)


def phase_serving(card, seed, pool=None):
    """Phase 19: the serving export at full width (module docstring), on
    the workers ``start_serving`` started (here if ``pool`` is None).
    Returns (detail, kernel launches of the artifacts' and the in-process
    runs: K3 by the route each launch took, K2, K1; ok)."""
    import torch

    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    if pool is None:
        pool = start_serving(seed)
    spec = pool["spec"]
    ahead = t_phase - pool["t0"]
    open(_marker(spec, "go", 0), "a").close()
    st = wait_workers(pool["procs"], pool["t0"])
    ok = True
    for key, (rc, _, tail) in st.items():
        if rc != 0:
            print(f"[serve export] {card} | {key[0]} {key[1]}: FAIL (exit "
                  f"{rc}):\n{tail}", flush=True)
            ok = False
    if not ok:
        return {"workers": {str(k): v[:2] for k, v in st.items()}}, {}, False
    with open(spec["ref_json"]) as f:
        ref = json.load(f)
    detail = {"workers_s": {f"{k[0]} {k[1]}": v[1] for k, v in st.items()},
              "started_ahead_s": ahead, "cpus": pool["cpus"], "cases": {}}
    launches = {"wgmma": 0, "cuda_cores": 0, "channel_stats": 0,
                "gn_swish": 0}
    for case in spec["cases"]:
        n = case["name"]
        with open(case["export_out"]) as f:
            ex = json.load(f)
        rows = ref[n]
        want = torch.load(case["ref_out"])
        got = torch.load(case["load_out"])
        lres = got["res"]
        cpu = lres.get("cpu_copy")
        if cpu is not None:
            # the CPU copy against the card's image 0: the kernels' plain
            # versions in another summation order, phase 10's tolerance
            out = got["outs"].pop()
            gains = sampler_gains(
                serving_alphas(case["config"]), case["steps"], "dpm")
            cpu["tol"] = SAMPLER_EPS_GAP * float(gains.sum())
            cpu["max_abs_err"] = (out - want[0][:1]).abs().max().item()
            cpu["ok"] = (cpu["device"] == "cpu"
                         and cpu["max_abs_err"] <= cpu["tol"])
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(got["outs"], want)]
        fin = all(bool(torch.isfinite(a).all()) for a in got["outs"])
        evals = ex["meta"]["evals"]
        # K3 and K2 take the batch in one launch, K1 too: the count is per
        # call, whatever the batch; every K3 launch took one route. The
        # scan form's Python loop may run its body once more than T (torch
        # 2.11's scan does, its result unchanged): the artifact's count is
        # then one eval's more than the in-process sampler's
        want_l = serving_want(case, evals)
        body = evals
        if case["scan"]:
            main_k = max(want_l, key=want_l.get)
            body = lres["rows"][0]["launches"][main_k] * evals // want_l[
                main_k] or evals        # none launched: the checks fail
        same_launch = len(lres["rows"]) == len(rows) and all(
            a["launches"] == serving_want(case, body)
            and b["launches"] == want_l
            and a["routes"] == {r: k * body // evals
                                for r, k in b["routes"].items()}
            for a, b in zip(lres["rows"], rows))
        calls_ok = ((body == evals or case["scan"] and body == evals + 1)
                    and all(sum(r["routes"].values())
                            == r["launches"]["fused_gn_swish_conv3x3"]
                            for r in lres["rows"] + rows))
        mods_ok = (not lres["jax"] and all(
            m in ("fastdiffsr_tpu_torch", "fastdiffsr_tpu_torch.ops")
            or m.startswith("fastdiffsr_tpu_torch.ops.")
            for m in lres["port_modules"]))
        c_ok = (len(errs) == len(case["runs"]) and max(errs) <= EXPORT_TOL
                and fin and same_launch and calls_ok and mods_ok
                and (ex["selftest_err"] is None
                     or ex["selftest_err"] <= EXPORT_TOL)
                and (cpu is None or cpu["ok"]))
        meta = ex["meta"]
        form = (meta["loop"], meta["noise"])
        c_ok &= form == (("scan", "counter") if case["scan"]
                         else ("unrolled", "inputs"))
        twin = None
        if case["unrolled_twin"]:
            # the scan artifact against the unrolled one on the noise the
            # scan drew; host time per step over it, the runs after the
            # first (the same inputs in both)
            tw = torch.load(case["twin_out"])
            twin = {"max_abs_err": max(
                (a - b).abs().max().item()
                for a, b in zip(got["outs"], tw["outs"])),
                "bit_equal": len(tw["outs"]) == len(got["outs"]) and all(
                    torch.equal(a, b) for a, b in zip(got["outs"],
                                                      tw["outs"])),
                "rows": tw["rows"], "extra_us_per_step": (
                    sum(r["s"] for r in lres["rows"][1:]) / body
                    - sum(r["s"] for r in tw["rows"][1:]) / evals)
                / max(len(tw["rows"]) - 1, 1) * 1e6}
            c_ok &= twin["bit_equal"]
        ok &= c_ok
        for r in lres["rows"] + rows:
            for route, k in r["routes"].items():
                launches[route] += k
            for k in ("channel_stats", "gn_swish"):
                launches[k] += r["launches"][k]

        def rate(rs):
            """img/s over the runs after the first of the largest batch
            (the first warms up; a case of one run times that one), and
            s/img."""
            big = max(r["batch"] for r in rs)
            timed = [r for r in rs if r["batch"] == big]
            timed = timed[1:] or timed
            s = sum(r["s"] for r in timed) / sum(r["batch"] for r in timed)
            return 1.0 / s, s, big, len(timed)

        ip, ip_s, big, n_t = rate(rows)
        xp, xp_s, _, _ = rate(lres["rows"])
        first = lres["rows"][0]
        per_eval = "/".join(f"{first['launches'][k] / body:g}" for k in
                            ("fused_gn_swish_conv3x3", "channel_stats",
                             "gn_swish"))
        print(f"[serve export] {card} | {n}: {os.path.basename(case['config'])}"
              f" {case['sampler']} {evals} evals, "
              + (f"fused {case['dtype']}" if ex["meta"]["fused"] else
                 f"plain {case['variant']} {case['dtype']}")
              + f" forward, symbolic batch, {form[0]} loop, noise from "
              f"{form[1]} | export+save {ex['export_s']:.1f}"
              f" s (beside the other workers), {ex['mb'][0]:.2f} MB, "
              f"export peak {ex['peak_gib'] or math.nan:.2f} GiB, load "
              f"{lres['load_s']:.1f} s in a process importing "
              f"{len(lres['port_modules'])} port modules (ops only: "
              f"{mods_ok}) | batches {case['runs']}: max|d| artifact vs "
              f"in-process {max(errs):.3g} (tol {EXPORT_TOL}), launches per "
              f"eval K3/K2/K1 {per_eval} (want "
              + "/".join(f"{want_l[k] // evals}" for k in
                         ("fused_gn_swish_conv3x3", "channel_stats",
                          "gn_swish"))
              + f"), K3 routes {first['routes']}, the artifact's loop ran "
              f"{body} evals, launches and routes equal "
              f"{same_launch} | B={big} over {n_t} timed run(s): in-process "
              + ("(beside phases 12-17) " if n in SERVING_EARLY_REF else "")
              + f"{ip:.3f} img/s ({ip_s:.4f} s/img), exported {xp:.3f} img/s "
              f"({xp_s:.4f} s/img)"
              + (f" | --selftest max|d| {ex['selftest_err']:.3g}"
                 if ex["selftest_err"] is not None else "")
              + (f" | CPU copy ({ex['mb'][1]:.2f} MB, move_to_device_pass):"
                 f" load {cpu['load_s']:.1f} s, image 0 on {cpu['device']} "
                 f"in {cpu['s']:.1f} s before the turns, max|d| vs the card "
                 f"{cpu['max_abs_err']:.3g} (tol {cpu['tol']:.3g})"
                 if cpu is not None else "")
              + (f" | against the {case['unrolled_twin']} case's unrolled "
                 f"artifact fed the noise drawn from the seeds: max|d| "
                 f"{twin['max_abs_err']:.3g}, bit-equal {twin['bit_equal']}, "
                 f"the scan form's time over it per eval run "
                 f"{twin['extra_us_per_step']:.1f} us"
                 if twin is not None else "")
              + f" {'ok' if c_ok else 'FAIL'}", flush=True)
        detail["cases"][n] = {
            "export_s": ex["export_s"], "mb": ex["mb"][0],
            "export_peak_gib": ex["peak_gib"], "evals": evals,
            "load_s": lres["load_s"], "max_abs_err": max(errs),
            "selftest_err": ex["selftest_err"],
            "in_process": rows, "exported": lres["rows"],
            "img_per_s_in_process": ip, "img_per_s_exported": xp,
            "s_per_img_in_process": ip_s, "s_per_img_exported": xp_s,
            "loader_modules": lres["port_modules"], "cpu_copy": cpu,
            "loop": form[0], "noise": form[1], "unrolled_twin": twin,
            "evals_run": body,
            "ok": c_ok}
    host = op_host_us(seed)
    detail["host_us"] = host
    rng = {k: f"{min(v):.1f}-{max(v):.1f}" for k, v in host.items()}
    print(f"[serve host] {card} | K3 host time per call, bf16 64x64 "
          f"256->256 B=1 ({HOST_CALLS} calls a reading, in turns "
          f"direct/op/op/direct): direct wrapper {rng['direct']} us, the "
          f"registered operator (what an exported program calls) "
          f"{rng['op']} us; eager calls take the direct route", flush=True)
    detail["seconds"] = time.time() - t_phase
    slowest = max(st.items(), key=lambda kv: kv[1][1])
    print(f"[serve export] {card} | phase 19 took {detail['seconds']:.1f} s "
          f"from its go, its workers {max(v[1] for v in st.values()):.1f} s "
          f"from their start {ahead:.1f} s before it (exporters and loaders "
          f"on cores {pool['cpus'] or 'any'}; the last "
          f"{slowest[0][0]} {slowest[0][1]}) {'ok' if ok else 'FAIL'}",
          flush=True)
    return detail, launches, ok


def phase_ddpm(card, seed):
    """Phase 20: ``model_api.DDPM`` at full width (module docstring).
    Returns (detail, K1 launches of its training, K3 launches by route and
    K2 launches of its sampling, ok)."""
    import copy

    import torch

    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.model_api import create_model
    from fastdiffsr_tpu_torch.ops import kernels
    from fastdiffsr_tpu_torch.train import make_train_step, step_generator
    from fastdiffsr_tpu_torch.utils.profiling import param_count

    t_phase = time.time()
    work = os.path.join(ROOT, "build", "smoke", "ddpm")
    cfg = load_json_config(os.path.join(
        ROOT, "fastdiffsr_tpu_torch", "configs",
        "sr_fastdiffsr_train_64_256.json"))
    cfg["seed"] = seed
    cfg["path"] = {"checkpoint": os.path.join(work, "checkpoint"),
                   "resume_state": None}
    dev = torch.device("cuda")
    m = create_model(cfg, device="cuda")
    twin = create_model(cfg, device="cuda")
    ema = cfg["train"]["ema_scheduler"]
    direct = make_train_step(twin.engine, ema_decay=float(ema["ema_decay"]),
                             ema_start=int(ema["step_start_ema"]))
    r = int(cfg["datasets"]["train"]["r_resolution"])
    g = torch.Generator(device="cuda").manual_seed(seed)
    batch = {k: torch.rand((B_TRAIN, r, r, 3), generator=g, device="cuda")
             * 2 - 1 for k in ("HR", "SR")}
    m.feed_data(batch)
    steps, ok = [], True
    for _ in range(DDPM_STEPS):
        # the twin takes the same step from the same parameters, through
        # make_train_step with the step's generator
        twin.state.net.load_state_dict(m.state.net.state_dict())
        k = m.state.step
        launches_m = timed_run(m.optimize_parameters)[2]
        _, met = direct(twin.state, batch, step_generator(seed, k, dev))
        l_direct = float(met["l_pix"])
        steps.append({"l_pix": m.log_dict["l_pix"], "l_pix_direct": l_direct,
                      "k1": launches_m["gn_swish"]})
    step_ok = all(s["l_pix"] == s["l_pix_direct"]
                  and s["k1"] == K1_PER_FORWARD["fastdiffsr"] for s in steps)
    del twin
    m.set_new_noise_schedule(schedule_phase="val")
    T = m.engine.buffers.num_timesteps
    traj, t_traj, l_traj, r_traj = timed_run(lambda: m.test(continous=True))
    final, t_final, l_final, r_final = timed_run(m.test)
    want_l = {"fused_gn_swish_conv3x3": 49 * T, "channel_stats": 4 * T,
              "gn_swish": 0, "quant_conv3": 0}
    test_ok = (tuple(traj.shape) == (T, B_TRAIN, r, r, 3)
               and torch.equal(traj[-1], final)
               and bool(torch.isfinite(traj).all())
               and l_traj == want_l and l_final == want_l
               and sum(r_traj.values()) == sum(r_final.values()) == 49 * T)
    path = m.save_network(epoch=1, iter_step=DDPM_STEPS)
    cfg2 = copy.deepcopy(cfg)
    cfg2["path"]["resume_state"] = path
    m2 = create_model(cfg2, device="cuda")
    sd, sd2 = m.state.net.state_dict(), m2.state.net.state_dict()
    reload_ok = (m2.begin_step == DDPM_STEPS and m2.begin_epoch == 1
                 and all(torch.equal(sd[k], sd2[k]) for k in sd)
                 and all(torch.equal(m.state.ema_params[k],
                                     m2.state.ema_params[k])
                         for k in m.state.ema_params))
    n_par = m.count_parameters()
    count_ok = n_par == param_count(m.net) == sum(
        p.numel() for p in m.net.parameters())
    ok = step_ok and test_ok and reload_ok and count_ok
    k1 = sum(s["k1"] for s in steps)
    print(f"[ddpm] {card} | model_api.create_model("
          f"sr_fastdiffsr_train_64_256.json) full width, B={B_TRAIN} "
          f"{r}x{r}: {DDPM_STEPS} optimize_parameters, l_pix "
          + ", ".join(f"{s['l_pix']:.6g}" for s in steps)
          + f", equal to make_train_step with the step's generator bit for "
          f"bit: {all(s['l_pix'] == s['l_pix_direct'] for s in steps)}; K1 "
          f"launches per step {[s['k1'] for s in steps]} (want "
          f"{K1_PER_FORWARD['fastdiffsr']}) | test(continous=True) "
          f"trajectory {tuple(traj.shape)} in {t_traj:.2f} s, last frame "
          f"equal to test() {torch.equal(traj[-1], final)}, launches per "
          f"test K3 {l_final['fused_gn_swish_conv3x3']} K2 "
          f"{l_final['channel_stats']} (want {49 * T}, {4 * T}), K3 routes "
          f"{r_final} | "
          f"save_network/load_network {os.path.basename(path)} bit-equal "
          f"{reload_ok} | count_parameters {n_par:,} = param_count "
          f"{count_ok} | {time.time() - t_phase:.1f} s "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    del m, m2, traj, final
    gc.collect()
    torch.cuda.empty_cache()
    detail = {"steps": steps, "test_s": t_final, "trajectory_s": t_traj,
              "n_params": n_par, "checkpoint": path,
              "seconds": time.time() - t_phase, "ok": ok}
    sampled = {r: r_traj[r] + r_final[r] for r in r_traj}
    sampled["channel_stats"] = (l_traj["channel_stats"]
                                + l_final["channel_stats"])
    return detail, k1, sampled, ok


def write_demo_sources(root, n, seed):
    """``n`` seeded DEMO_SIDE^2 RGB PNGs with spatial structure: bicubic
    upsampled 8x8 noise, a bright or dark rectangle and a one-pixel line
    (edges at random places), written without an image library."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from fastdiffsr_tpu_torch.metrics import save_img
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    small = torch.from_numpy(rng.uniform(40, 215, (n, 3, 8, 8))
                             .astype(np.float32))
    base = F.interpolate(small, size=DEMO_SIDE, mode="bicubic",
                         align_corners=False).permute(0, 2, 3, 1).numpy()
    for i, img in enumerate(base):
        y0, x0 = rng.integers(0, DEMO_SIDE - 16, 2)
        h, w = rng.integers(8, 32, 2)
        img[y0:y0 + h, x0:x0 + w] += rng.choice([-60.0, 60.0])
        k = rng.integers(0, DEMO_SIDE)
        if i % 2:
            img[k, :] = 255.0
        else:
            img[:, k] = 0.0
        save_img(np.clip(img, 0, 255).round().astype(np.uint8),
                 os.path.join(root, f"{i:05d}.png"))
    return root


def demo_prepare(work, src, card):
    """data/prepare.py on the sources at both demo sizes in the three
    formats: the seconds each takes to write and to read back (the
    device cache's raw_uint8, and LR through __getitem__); the three must
    decode to the same uint8 arrays. Returns ({(l, r): {format: root}},
    rows, ok)."""
    import numpy as np

    from fastdiffsr_tpu_torch.data import LRHRDataset
    from fastdiffsr_tpu_torch.data.prepare import prepare
    roots, rows, ok = {}, [], True
    for l_res, r_res in DEMO_SIZES:
        got = {}
        for fmt, datatype in DEMO_FORMATS.items():
            out = os.path.join(work, f"{fmt}_{l_res}_{r_res}")
            shutil.rmtree(out, ignore_errors=True)
            t0 = time.time()
            n = prepare(src, out, n_worker=DEMO_WORKERS, sizes=(l_res, r_res),
                        pack=fmt == "pack", lmdb=fmt == "lmdb", verbose=False)
            write_s = time.time() - t0
            t0 = time.time()
            ds = LRHRDataset(out, datatype=datatype, l_resolution=l_res,
                             r_resolution=r_res, split="val", need_LR=True)
            raw = ds.raw_uint8()
            read_s = time.time() - t0
            lr = np.stack([ds[i]["LR"] for i in range(len(ds))])
            got[fmt] = (raw, lr)
            roots.setdefault((l_res, r_res), {})[fmt] = out
            rows.append({"sizes": [l_res, r_res], "format": fmt, "images": n,
                         "write_s": write_s, "read_s": read_s})
        ref_raw, ref_lr = got["folder"]
        same = all(np.array_equal(raw[k], ref_raw[k])
                   and raw[k].shape == (DEMO_SOURCES, r_res, r_res, 3)
                   for raw, _ in got.values() for k in ("HR", "SR")) \
            and all(np.array_equal(lr, ref_lr) for _, lr in got.values())
        ok &= same
        times = ", ".join(f"{r['format']} write {r['write_s']:.3f} s read "
                          f"{r['read_s']:.3f} s" for r in rows
                          if r["sizes"] == [l_res, r_res])
        print(f"[demo prepare] {card} | data.prepare of {DEMO_SOURCES} "
              f"{DEMO_SIDE}x{DEMO_SIDE} PNGs at {l_res}->{r_res}, "
              f"{DEMO_WORKERS} spawn workers (host seconds): {times} | the "
              f"three decode to equal uint8 HR/SR/LR: {same} "
              f"{'ok' if same else 'FAIL'}", flush=True)
    return roots, rows, ok


def phase_demo(card, seed):
    """Phase 21, the demo path: prepare a corpus, train the x8 demo
    config with its SSIM term on it (folder and lmdb), validate, and hold
    each kernel against its plain version at the 64x64 UNet's maps.
    Returns (detail, launches of the path's runs, ok)."""
    import torch

    from fastdiffsr_tpu_torch.cli import sr_mfe
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr_fused import (
        prepare_fused_params)
    from fastdiffsr_tpu_torch.ops import fused_conv, kernels

    t_phase = time.time()
    dev = torch.device("cuda")
    work = os.path.join(ROOT, "build", "smoke", "demo")
    src = write_demo_sources(os.path.join(work, "src"), DEMO_SOURCES, seed)
    roots, prep_rows, ok = demo_prepare(work, src, card)

    def config(name):
        return load_json_config(os.path.join(
            ROOT, "fastdiffsr_tpu_torch", "configs", f"{name}.json"))

    cfg = config("demo_ucm_native_8_64_s8hg")
    l_res = int(cfg["datasets"]["train"]["l_resolution"])
    r_res = int(cfg["datasets"]["train"]["r_resolution"])
    batch = int(cfg["datasets"]["train"]["batch_size"])
    T = int(cfg["model"]["beta_schedule"]["val"]["n_timestep"])
    k1_fwd = K1_PER_FORWARD["fastdiffsr"]
    detail = {"prepare": prep_rows}

    # one train step on K1 against gn_swish_reference, the SSIM term on
    detail["train_step"], step_ok = phase_train_parity(
        cfg, batch, card, seed, tag="demo s8hg")
    ok &= step_ok

    def train(cfg, name, fmt, deterministic):
        """cli.sr_mfe -p train on the prepared corpus in ``fmt``, the
        device cache on (as the config has it); ``deterministic``: cuDNN
        restricted to its deterministic algorithms."""
        c = json.loads(json.dumps(cfg))
        c["name"] = f"chip_smoke_demo_{name}"
        c["path"]["resume_state"] = None
        for ds in c["datasets"].values():
            ds.update(dataroot=roots[l_res, r_res][fmt],
                      datatype=DEMO_FORMATS[fmt])
        c["datasets"]["val"]["data_len"] = DEMO_VAL
        c["train"].update(n_iter=DEMO_STEPS, val_freq=10 ** 9,
                          save_checkpoint_freq=10 ** 9, print_freq=4)
        path = os.path.join(work, f"{c['name']}.json")
        with open(path, "w") as f:
            json.dump(c, f)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.backends.cudnn.deterministic = deterministic
        t0 = time.time()
        try:
            out = sr_mfe.main(["-p", "train", "-c", path, "--device", "cuda",
                               "--seed", str(seed)])
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        out["wall_s"] = time.time() - t0
        launches = dict(kernels.LAUNCHES)
        run_ok = (c["datasets"]["train"]["device_cache"]
                  and out["steps"] == DEMO_STEPS
                  and all(map(math.isfinite, out["l_pix"]))
                  and launches == {"gn_swish": k1_fwd * DEMO_STEPS,
                                   "fused_gn_swish_conv3x3": 0,
                                   "channel_stats": 0, "quant_conv3": 0}
                  and out["steady_steps_per_s"] is not None)
        return c, out, launches, run_ok

    # the rates in the CLI's own regime (cuDNN's timed algorithms, some
    # of which are not deterministic: two such runs drift apart after the
    # first step); the folder and lmdb corpora compared bit for bit on
    # cuDNN's deterministic algorithms
    runs = {}
    for name, cfg_name, fmt, det in (
            ("s8hg", "demo_ucm_native_8_64_s8hg", "folder", False),
            ("s8h", "demo_ucm_native_8_64_s8h", "folder", False),
            ("s8hg_det", "demo_ucm_native_8_64_s8hg", "folder", True),
            ("s8hg_lmdb_det", "demo_ucm_native_8_64_s8hg", "lmdb", True)):
        c, out, launches, run_ok = train(config(cfg_name), name, fmt, det)
        runs[name] = {"config": cfg_name, "format": fmt,
                      "cudnn_deterministic": det, "l_pix": out["l_pix"],
                      "steady_steps_per_s": out["steady_steps_per_s"],
                      "wall_s": out["wall_s"], "launches": launches,
                      "checkpoint": out["checkpoint"], "ok": run_ok, "cfg": c}
        ok &= run_ok
    same = runs["s8hg_lmdb_det"]["l_pix"] == runs["s8hg_det"]["l_pix"]
    ok &= same
    rate_g = runs["s8hg"]["steady_steps_per_s"]
    rate_h = runs["s8h"]["steady_steps_per_s"]
    k1_train = sum(r["launches"]["gn_swish"] for r in runs.values())
    for name, r in runs.items():
        print(f"[demo train {name}] {card} | cli.sr_mfe -p train "
              f"{r['config']}.json on the {r['format']} corpus (datatype "
              f"{DEMO_FORMATS[r['format']]}), full width, B={batch} "
              f"{l_res}->{r_res}, device cache, {DEMO_STEPS} steps: l_pix "
              f"first {r['l_pix'][0]:.6f} last {r['l_pix'][-1]:.6f} | K1 "
              f"launches {r['launches']['gn_swish']} (want "
              f"{k1_fwd * DEMO_STEPS}), K3 "
              f"{r['launches']['fused_gn_swish_conv3x3']}, K2 "
              f"{r['launches']['channel_stats']} | cuDNN "
              f"{'deterministic' if r['cudnn_deterministic'] else 'timed'}"
              f", steady {r['steady_steps_per_s']:.3f} steps/s excluding "
              f"the first step; the run's wall {r['wall_s']:.1f} s (set-up "
              f"and checkpoint included) {'ok' if r['ok'] else 'FAIL'}",
              flush=True)
    print(f"[demo train] {card} | on cuDNN's deterministic algorithms, "
          f"l_pix of the lmdb run bit-equal to the folder run's over "
          f"{DEMO_STEPS} steps: {same}; on the timed ones the folder run's "
          f"last l_pix {runs['s8hg']['l_pix'][-1]:.6f} against "
          f"{runs['s8hg_det']['l_pix'][-1]:.6f} | the SSIM term's cost: "
          f"s8hg {rate_g:.3f} against s8h {rate_h:.3f} steps/s, ratio "
          f"{rate_g / rate_h:.3f} {'ok' if same else 'FAIL'}", flush=True)

    # -p val of the s8hg checkpoint: x8, fused f32, batch 1
    c = runs["s8hg"]["cfg"]
    c["path"]["resume_state"] = runs["s8hg"]["checkpoint"]
    path = os.path.join(work, "chip_smoke_demo_val.json")
    with open(path, "w") as f:
        json.dump(c, f)
    kernels.reset_launch_counts()
    routes0 = dict(fused_conv.ROUTE_TAKEN)
    t0 = time.time()
    res = sr_mfe.main(["-p", "val", "-c", path, "--device", "cuda",
                       "--seed", str(seed)])
    torch.cuda.synchronize()
    own_phases_regime()
    vwall = time.time() - t0
    val_launches = dict(kernels.LAUNCHES)
    routes = {k: n - routes0[k] for k, n in fused_conv.ROUTE_TAKEN.items()}
    n_eval = T * DEMO_VAL
    val_ok = (val_launches == {"fused_gn_swish_conv3x3": 49 * n_eval,
                               "channel_stats": 4 * n_eval, "gn_swish": 0,
                               "quant_conv3": 0}
              and routes == {"wgmma": 0, "cuda_cores": 49 * n_eval}
              and math.isfinite(res.get("psnr", math.nan))
              and math.isfinite(res.get("ssim", math.nan)))
    ok &= val_ok
    s_img = res.get("avg_time", math.nan)
    print(f"[demo val] {card} | cli.sr_mfe -p val of the s8hg checkpoint, "
          f"x{r_res // l_res} {l_res}->{r_res}, fused f32, batch 1, T={T}, "
          f"{DEMO_VAL} tiles: psnr {res.get('psnr', math.nan):.4f} ssim "
          f"{res.get('ssim', math.nan):.4f} | K3 launches "
          f"{val_launches['fused_gn_swish_conv3x3']} (want {49 * n_eval}; "
          f"{routes['cuda_cores']} on the CUDA cores), K2 "
          f"{val_launches['channel_stats']} (want {4 * n_eval}), K1 "
          f"{val_launches['gn_swish']} | {s_img:.4f} s per image after the "
          f"first, wall {vwall:.1f} s {'ok' if val_ok else 'FAIL'}",
          flush=True)
    detail["runs"] = {k: {kk: vv for kk, vv in v.items() if kk != "cfg"}
                      for k, v in runs.items()}
    detail["val"] = {"result": res, "launches": val_launches,
                     "routes": routes, "s_per_image": s_img, "wall_s": vwall}

    # the kernels at the 64x64 UNet's maps: K3 f32 and K2 at batch 1 (the
    # -p val shapes), K1 at the training batch
    unet_opt = cfg["model"]["unet"]
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    net = unet_from_config(unet_opt, dtype=torch.float32, device=dev,
                           seed=seed)
    x = torch.randn((1, r_res, r_res, 6), generator=g, device=dev)
    level = torch.rand((1,), generator=g, device=dev)
    k3_sigs, k2_sigs = record_calls(prepare_fused_params(net, torch.float32),
                                    x, level)
    x = torch.randn((batch, r_res, r_res, 6), generator=g, device=dev)
    level = torch.rand((batch,), generator=g, device=dev)
    k1_sigs, strided = record_k1(net, x, level)
    del net, x
    shapes_ok = (sum(k3_sigs.values()) == 49 and sum(k2_sigs.values()) == 4
                 and sum(k1_sigs.values()) == k1_fwd and strided == 0)
    ok &= shapes_ok
    maps = sorted({sg[1] for sg in k3_sigs} | {sg[0] for sg in k1_sigs})
    print(f"[demo shapes] {card} | one {r_res}x{r_res} eval: "
          f"{sum(k3_sigs.values())} K3 calls in {len(k3_sigs)} shapes, "
          f"{sum(k2_sigs.values())} K2 calls in {len(k2_sigs)}; one "
          f"training forward: {sum(k1_sigs.values())} K1 calls in "
          f"{len(k1_sigs)} shapes; maps {maps} "
          f"{'ok' if shapes_ok else 'FAIL'}", flush=True)
    k3_rows, k3_ok = phase_k3(k3_sigs, 1, REPS, card, seed, dtypes=("f32",))
    k2_rows, k2_ok = phase_k2(k2_sigs, 1, REPS, card, seed, dtypes=("f32",))
    k1_rows, k1_ok = phase_k1(k1_sigs, batch, REPS, card, seed,
                              dtypes=("f32",))
    print_k3_totals(k3_rows, card, f" {r_res}x{r_res}")
    print_k2_totals(k2_rows, card, f" {r_res}x{r_res}")
    k1_tot = {k: total(k1_rows, k, "f32", "calls_per_forward")
              for k in ("ms", "plain_ms", "bound_ms", "two_call_library_ms")}
    print(f"[K1 total f32 B={batch} {r_res}x{r_res}] {card} | per training "
          f"forward, device: kernel {k1_tot['ms']:.4f} ms, plain "
          f"{k1_tot['plain_ms']:.4f} ms, F.group_norm+F.silu "
          f"{k1_tot['two_call_library_ms']:.4f} ms | bound "
          f"{k1_tot['bound_ms']:.4f} ms", flush=True)
    ok &= k3_ok and k2_ok and k1_ok
    detail.update(k3=k3_rows, k2=k2_rows, k1=k1_rows, k1_total=k1_tot,
                  seconds=time.time() - t_phase, ok=ok)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"gn_swish": k1_train,
                "cuda_cores": routes["cuda_cores"],
                "channel_stats": val_launches["channel_stats"]}
    print(f"[demo] {card} | phase 21 took {detail['seconds']:.1f} s "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return detail, launches, ok


# phase 22: the W8A8 path (FASTDIFFSR_TPU_QUANT)
Q1_PER_FORWARD = {"64_256": 21, "128_512": 31}
QUANT_MODES = ("w8a8", "w8a8s")
QUANT_SERVE_BATCH = 16
QUANT_INFER_IMAGES = 2
QUANT_TRAIN_STEPS = 3
QUANT_EXPORT_STEPS = 2
QUANT_EXPORT_BATCH = 2
# Q1 per 64->256 eval at batch 16 with the earlier mma.sync kernel, the one
# the wgmma kernel replaced (this script's phase 22 on an NVIDIA H100 80GB
# HBM3 at 700 W)
Q1_EARLIER_MS = {"bf16": 12.985, "f32": 13.089}


@contextlib.contextmanager
def environ(values):
    """Within the block, each environment variable of ``values`` set to
    its value (None: unset)."""
    def put(vals):
        for k, v in vals.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    prev = {k: os.environ.get(k) for k in values}
    put(values)
    try:
        yield
    finally:
        put(prev)


def quant_mode(mode):
    """FASTDIFFSR_TPU_QUANT set to ``mode`` within the block."""
    return environ({"FASTDIFFSR_TPU_QUANT": mode})


@contextlib.contextmanager
def plain_q1():
    """Within the block, Q1's wrapper runs Q1's plain version on CUDA
    tensors too: the oracle of the W8A8 train-step check."""
    from fastdiffsr_tpu_torch.ops import quant
    orig = quant.quant_conv3_apply
    quant.quant_conv3_apply = quant.quant_conv3_apply_plain
    try:
        yield
    finally:
        quant.quant_conv3_apply = orig


def record_q1(net, x, level):
    """The distinct (H, W, Ci, Co) of the quantized convs of one forward
    of ``net`` (its ``quant`` set), with their counts."""
    import torch

    from fastdiffsr_tpu_torch.models import unet_fastdiffsr as tu
    sigs, orig = {}, tu.quant_conv3

    def rec(h, weight, bias, dtype, static_scale=False, cache=None):
        sig = (*h.shape[1:], weight.shape[0])
        sigs[sig] = sigs.get(sig, 0) + 1
        return orig(h, weight, bias, dtype, static_scale, cache=cache)

    tu.quant_conv3 = rec
    try:
        with torch.no_grad():
            net(x, level)
    finally:
        tu.quant_conv3 = orig
    return sigs


def im2col_s8(q_h):
    """(B*H*W, 9*Ci) int8 rows of the 3x3 SAME neighbourhoods of an int8
    NHWC map, tap-major: the A operand of the ``torch._int_mm`` yardstick."""
    import torch
    import torch.nn.functional as F
    B, H, W, ci = q_h.shape
    p = F.pad(q_h, (0, 0, 1, 1, 1, 1))
    return torch.cat([p[:, dy:dy + H, dx:dx + W] for dy in range(3)
                      for dx in range(3)], dim=-1).reshape(B * H * W, 9 * ci)


def q1_operands(B, H, W, ci, co, g):
    """Q1's operands at one shape, drawn from the CUDA generator ``g``:
    (OIHW float weight, bias, its int8 weight and scales, the packed
    weight, a float32 NHWC map of post-swish-like activations: a long
    positive tail and a short negative one, so the static scale clips a
    few of them)."""
    import torch
    import torch.nn.functional as F

    from fastdiffsr_tpu_torch.ops import quant
    w = torch.randn((co, ci, 3, 3), generator=g, device="cuda") / (
        3.0 * math.sqrt(ci))
    b = torch.randn(co, generator=g, device="cuda") * 0.1
    q_w, s_w = quant.quantize_weights(w)
    x32 = F.silu(torch.randn((B, H, W, ci), generator=g, device="cuda")
                 * 2.5)
    return w, b, q_w, s_w, quant.pack_weights(q_w), x32


def q1_shapes(card, seed):
    """The quantized convs of one w8a8 forward of the full-width 64->256
    UNet and of its 128->512 eval, recorded by hooks: ({(H, W, Ci, Co):
    calls} of the 64->256 eval, the 128-row shapes of the 128->512 eval
    beyond those, the calls per eval of each, ok if both make the
    expected number)."""
    import torch

    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    dev = torch.device("cuda")
    cfg = load_json_config(os.path.join(
        ROOT, "fastdiffsr_tpu_torch", "configs",
        "sr_fastdiffsr_test_64_256.json"))
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    sigs = {}
    for key, side in (("64_256", 256), ("128_512", 512)):
        with quant_mode("w8a8"):
            net = unet_from_config(cfg["model"]["unet"], device=dev,
                                   seed=seed)
        x = torch.randn((1, side, side, 6), generator=g, device=dev)
        sigs[key] = record_q1(net, x, torch.rand((1,), generator=g,
                                                 device=dev))
        del net, x
    n = {k: sum(v.values()) for k, v in sigs.items()}
    extra = {s: c for s, c in sigs["128_512"].items() if s[0] == 128
             and s not in sigs["64_256"]}
    ok = (n["64_256"] == Q1_PER_FORWARD["64_256"]
          and n["128_512"] == Q1_PER_FORWARD["128_512"])
    print(f"[shapes] {card} | w8a8 forwards: {n['64_256']} quantized convs "
          f"in {len(sigs['64_256'])} shapes per 64->256 eval, "
          f"{n['128_512']} in {len(sigs['128_512'])} per 128->512 eval "
          f"(want {Q1_PER_FORWARD['64_256']} and "
          f"{Q1_PER_FORWARD['128_512']}); {len(extra)} 128-row shapes of "
          f"the 128->512 eval beyond the 64->256 ones "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return sigs["64_256"], extra, n, ok


def phase_q1(sigs, B, card, seed):
    """Q1 against its plain version at every (H, W, Ci, Co) of ``sigs`` at
    batch ``B``, f32 and bf16 maps, both scale modes: the int32
    accumulators and the outputs bit-equal, one launch per call. Then, in
    the dynamic mode, the device and wall times of Q1 per type, the device
    time of the dynamic scale (``activation_scale``: the abs-max the path
    computes before each call), of the plain version (f32 map), and of two
    yardsticks the port never calls:
    ``torch._int_mm`` of the im2col of the quantized map and the packed
    weight (the GEMM alone; Co padded to 8 where it is 3, which _int_mm
    refuses), and cuDNN's bf16 conv of the same float shape."""
    import torch
    import torch.nn.functional as F

    from fastdiffsr_tpu_torch.ops import kernels, quant
    g = torch.Generator(device="cuda").manual_seed(seed + 22)
    rows, ok = [], True
    for (H, W, ci, co), count in sorted(sigs.items(), reverse=True):
        w, b, q_w, s_w, packed, x32 = q1_operands(B, H, W, ci, co, g)
        row = {"H": H, "W": W, "Ci": ci, "Co": co, "B": B,
               "calls_per_eval": count, "checks": {}}
        for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            h = x32.to(dt)
            for mode in QUANT_MODES:
                s_a = quant.activation_scale(h, mode == "w8a8s")
                y, acc = quant.quant_conv3_launch(h, packed, s_w, s_a, b, dt,
                                                  want_acc=True)
                y_p, acc_p = quant.quant_conv3_apply_plain(
                    h, packed, s_w, s_a, b, dt, want_acc=True)
                torch.cuda.synchronize()
                err = (y.float() - y_p.float()).abs().max().item()
                err_acc = (acc - acc_p).abs().max().item()
                same = (torch.equal(acc, acc_p) and torch.equal(y, y_p)
                        and bool(torch.isfinite(y).all()))
                row["checks"][f"{dt_name}/{mode}"] = {
                    "bit_equal": same, "max_abs_err": err,
                    "max_abs_err_acc": err_acc}
                ok &= same
                del y, acc, y_p, acc_p
            s_a = quant.activation_scale(h, False)
            per_call = kernels.kernels_per_call(
                lambda: quant.quant_conv3_launch(h, packed, s_w, s_a, b, dt))
            ok &= per_call == 1
            ms, wall_ms = timed(lambda: quant.quant_conv3_launch(
                h, packed, s_w, s_a, b, dt), REPS)
            # the dynamic scale each quantized conv of the path computes
            absmax_ms = device_ms(lambda: quant.activation_scale(h, False),
                                  REPS)
            es = 2 if dt_name == "bf16" else 4
            n_in, n_out = B * H * W * ci, B * H * W * co
            b_ms, b_by = bound(2.0 * n_out * 9 * ci,
                               (n_in + n_out) * es + packed.numel() + 8 * co,
                               "int8")
            row.update({f"{k}_{dt_name}": v for k, v in (
                ("ms", ms), ("wall_ms", wall_ms), ("bound_ms", b_ms),
                ("absmax_ms", absmax_ms),
                ("bound_by", b_by), ("launches_per_call", per_call))})
        h = x32
        s_a = quant.activation_scale(h, False)
        row["plain_ms"], row["plain_wall_ms"] = timed(
            lambda: quant.quant_conv3_apply_plain(h, packed, s_w, s_a, b,
                                                  torch.float32), REPS)
        a_mat = im2col_s8(quant.quantize_activations(h, s_a))
        co8 = max(co, 8)
        b_mat = F.pad(q_w.permute(0, 2, 3, 1).reshape(co, 9 * ci),
                      (0, 0, 0, co8 - co)).contiguous().t()
        row["int_mm_ms"], row["int_mm_wall_ms"] = timed(
            lambda: torch._int_mm(a_mat, b_mat), REPS)
        row["int_mm_co"] = co8
        del a_mat
        x_nchw = x32.to(torch.bfloat16).permute(0, 3, 1, 2)
        w16, b16 = w.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last), b.to(torch.bfloat16)
        row["cudnn_bf16_ms"], row["cudnn_bf16_wall_ms"] = timed(
            lambda: F.conv2d(x_nchw, w16, b16, padding=1), REPS)
        del x_nchw, x32, h
        rows.append(row)
        r_ok = all(c["bit_equal"] for c in row["checks"].values())
        print(f"[Q1] {card} | B={B} {H}x{W} {ci}->{co} x{count}/eval | "
              f"acc and y bit-equal to the plain version in f32/bf16 x "
              f"w8a8/w8a8s: {r_ok}, launches/call "
              f"{row['launches_per_call_f32']}/{row['launches_per_call_bf16']}"
              f" | device: Q1 f32 {row['ms_f32']:.4f} ms bf16 "
              f"{row['ms_bf16']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"_int_mm (GEMM of the im2col, Co {co8}) {row['int_mm_ms']:.4f}"
              f" ms, cuDNN bf16 conv {row['cudnn_bf16_ms']:.4f} ms, abs-max "
              f"scale f32 {row['absmax_ms_f32']:.4f} ms bf16 "
              f"{row['absmax_ms_bf16']:.4f} ms | wall: "
              f"Q1 f32 {row['wall_ms_f32']:.4f} ms bf16 "
              f"{row['wall_ms_bf16']:.4f} ms | bound f32 "
              f"{row['bound_ms_f32']:.4f} ms ({row['bound_by_f32']}) bf16 "
              f"{row['bound_ms_bf16']:.4f} ms ({row['bound_by_bf16']}) "
              f"{'ok' if r_ok else 'FAIL'}", flush=True)
        torch.cuda.empty_cache()
    return rows, ok


def q1_total(rows, key):
    """Per eval: the sum over the shapes of ``key`` times the calls."""
    return sum(r[key] * r["calls_per_eval"] for r in rows)


def q1_per_eval(rows, card):
    """Phase 22's per-eval sums of phase_q1's 64->256 rows, printed beside
    the earlier mma.sync kernel's times."""
    tot = {f"{k}_{dt}": q1_total(rows, f"{k}_{dt}") for dt in ("f32", "bf16")
           for k in ("ms", "wall_ms", "bound_ms", "absmax_ms")}
    tot.update({k: q1_total(rows, k) for k in ("plain_ms", "int_mm_ms",
                                               "cudnn_bf16_ms")})
    calls = sum(r["calls_per_eval"] for r in rows)
    print(f"[Q1 total] {card} | per 64->256 eval (B={rows[0]['B']}, "
          f"{calls} calls), device: Q1 f32 {tot['ms_f32']:.3f} ms bf16 "
          f"{tot['ms_bf16']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
          f"_int_mm GEMMs {tot['int_mm_ms']:.3f} ms, cuDNN bf16 convs "
          f"{tot['cudnn_bf16_ms']:.3f} ms, abs-max scales f32 "
          f"{tot['absmax_ms_f32']:.3f} ms bf16 {tot['absmax_ms_bf16']:.3f} "
          f"ms | wall: Q1 f32 "
          f"{tot['wall_ms_f32']:.3f} ms bf16 {tot['wall_ms_bf16']:.3f} ms | "
          f"bound f32 {tot['bound_ms_f32']:.3f} ms bf16 "
          f"{tot['bound_ms_bf16']:.3f} ms | the mma.sync kernel f32 "
          f"{Q1_EARLIER_MS['f32']:.3f} ms bf16 {Q1_EARLIER_MS['bf16']:.3f} ms"
          f" (x{Q1_EARLIER_MS['f32'] / tot['ms_f32']:.2f} / "
          f"x{Q1_EARLIER_MS['bf16'] / tot['ms_bf16']:.2f})", flush=True)
    return tot


def quant_serve(cfg, card, seed):
    """Sampling 64->256 at T=20, batch QUANT_SERVE_BATCH, on the plain
    forward with each quant mode and without, from the same weights, cond
    and per-image generators, in bf16 and f32, on cuDNN's heuristics as
    cli.infer has it: img/s, launches (Q1 21 and K1 45 per eval), and each
    quantized output's relative RMS against the unquantized one."""
    import numpy as np
    import torch

    from fastdiffsr_tpu_torch.cli.infer import make_denoiser
    from fastdiffsr_tpu_torch.device import set_cudnn_autotuning
    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.ops import kernels
    from fastdiffsr_tpu_torch.train import make_sample_fn, pad_batch_with_keys
    dev = torch.device("cuda")
    T = int(cfg["model"]["beta_schedule"]["val"]["n_timestep"])
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(
                              cfg["model"]["beta_schedule"]["val"],
                              device=dev))
    B = QUANT_SERVE_BATCH
    cond = np.random.default_rng(seed + 23).uniform(
        -1, 1, (B, 256, 256, 3)).astype(np.float32)
    out, ok, launches = {}, True, {"quant_conv3": 0, "gn_swish": 0}
    set_cudnn_autotuning(False)
    for dt_name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        ys = {}
        for mode in ("",) + QUANT_MODES:
            with quant_mode(mode):
                net = unet_from_config(cfg["model"]["unet"], dtype=dt,
                                       device=dev, seed=seed)
            fn = make_sample_fn(eng, make_denoiser(net, False, dt))
            x, _ = pad_batch_with_keys(cond, B, seed, 0, device=dev)
            with torch.no_grad():          # one eval: plans, the packing
                net(torch.cat([x, x], -1), torch.ones(B, device=dev))
            _, gens = pad_batch_with_keys(cond, B, seed, 0, device=dev)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            y = fn(x, gens)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            got = dict(kernels.LAUNCHES)
            want = {"fused_gn_swish_conv3x3": 0, "channel_stats": 0,
                    "gn_swish": 45 * T,
                    "quant_conv3": Q1_PER_FORWARD["64_256"] * T if mode
                    else 0}
            fin = bool(torch.isfinite(y).all())
            r_ok = got == want and fin
            ok &= r_ok
            for k in launches:
                launches[k] += got[k]
            ys[mode] = y.float()
            rel = (None if not mode else
                   ((y.float() - ys[""]).pow(2).mean().sqrt()
                    / ys[""].pow(2).mean().sqrt()).item())
            out[f"{dt_name}/{mode or 'none'}"] = {
                "img_per_s": B / sec, "seconds": sec, "launches": got,
                "rel_rms_vs_unquantized": rel, "ok": r_ok}
            print(f"[quant serve] {card} | 64->256 plain forward {dt_name}, "
                  f"quant {mode or 'none'}, T={T}, batch {B}: "
                  f"{B / sec:.3f} img/s ({sec:.3f} s), finite {fin} | "
                  f"launches Q1 {got['quant_conv3']} (want "
                  f"{want['quant_conv3']}), K1 {got['gn_swish']} (want "
                  f"{want['gn_swish']}), K3 {got['fused_gn_swish_conv3x3']}"
                  f", K2 {got['channel_stats']} | rel RMS vs unquantized "
                  f"{'-' if rel is None else f'{rel:.4g}'} "
                  f"{'ok' if r_ok else 'FAIL'}", flush=True)
            del net, fn, y
        del ys
        torch.cuda.empty_cache()
    own_phases_regime()
    return out, launches, ok


def quant_infer(cfg, card, seed):
    """cli.infer of the 64->256 test config with FASTDIFFSR_TPU_QUANT=w8a8
    on QUANT_INFER_IMAGES images in one batch (the plain forward: Q1 21
    and K1 45 per eval, no K3/K2), and its refusal of --fused."""
    from fastdiffsr_tpu_torch.cli import infer
    from fastdiffsr_tpu_torch.data import write_pack
    n = QUANT_INFER_IMAGES
    T = int(cfg["model"]["beta_schedule"]["val"]["n_timestep"])
    droot = os.path.join(ROOT, "build", "smoke", "quant", f"pack_{seed}")
    write_pack(droot, n, seed)
    cfg = json.loads(json.dumps(cfg))
    cfg["name"] = "chip_smoke_infer_w8a8"
    cfg["datasets"]["val"].update(dataroot=droot, datatype="npy",
                                  batch_size=n, data_len=n)
    with quant_mode("w8a8"):
        row, ok = run_infer(
            cfg, cfg["name"], card, ["--seed", str(seed)], "quant infer",
            {"fused_gn_swish_conv3x3": 0, "channel_stats": 0,
             "gn_swish": 45 * T, "quant_conv3": Q1_PER_FORWARD["64_256"]
             * T})
        run_cfg = os.path.join(ROOT, "build", "smoke", f"{cfg['name']}.json")
        try:
            infer.main(["-c", run_cfg, "--device", "cuda", "--fused"])
            refused = ""
        except ValueError as e:        # the refusal is the check
            refused = str(e)
    r_ok = "--fused" in refused and "FASTDIFFSR_TPU_QUANT" in refused
    print(f"[quant infer --fused] {card} | cli.infer --fused with "
          f"FASTDIFFSR_TPU_QUANT=w8a8 refused: {refused!r} "
          f"{'ok' if r_ok else 'FAIL'}", flush=True)
    row["fused_refusal"] = refused
    return row, ok and r_ok


def quant_train(cfg, card, seed):
    """The 64->256 train config at batch 4 with w8a8: one step with Q1 and
    one with Q1's plain version from the same weights, batch and draws
    (dropout off, Adam eps STEP_ADAM_EPS): loss and gradient norm within
    phase 8's tolerances, Q1 launched 21 times (0 on the plain arm); then
    QUANT_TRAIN_STEPS steps with the config's dropout, with and without
    quant: losses finite, steps/s after the first."""
    import torch

    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.ops import kernels
    from fastdiffsr_tpu_torch.train import (create_train_state,
                                            make_optimizer, make_train_step,
                                            step_generator)
    dev = torch.device("cuda")
    B = B_TRAIN
    r = int(cfg["datasets"]["train"]["r_resolution"])
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(
                              cfg["model"]["beta_schedule"]["train"],
                              device=dev))
    g = torch.Generator(device=dev).manual_seed(seed + 24)
    batch = {k: torch.rand((B, r, r, 3), generator=g, device=dev) * 2 - 1
             for k in ("HR", "SR")}
    gamma = eng.sample_gammas(g, B)[0]
    noise = torch.randn((B, r, r, 3), generator=g, device=dev)
    step = make_train_step(eng, ema_start=0)
    arms = {}
    with quant_mode("w8a8"):
        net = unet_from_config(dict(cfg["model"]["unet"], dropout=0.0),
                               device=dev, seed=seed)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    for arm in ("plain", "q1"):
        net.load_state_dict(start)
        state = create_train_state(net, torch.optim.Adam(
            net.parameters(), lr=1e-4, eps=STEP_ADAM_EPS))
        kernels.reset_launch_counts()
        with plain_q1() if arm == "plain" else contextlib.nullcontext():
            _, m = step(state, batch, None, noise=noise, gamma=gamma)
        torch.cuda.synchronize()
        arms[arm] = {"loss": m["l_pix"].item(),
                     "grad_norm": m["grad_norm"].item(),
                     "q1": kernels.LAUNCHES["quant_conv3"]}
        del state
    del net, start
    a, q = arms["plain"], arms["q1"]
    d_loss = abs(a["loss"] - q["loss"]) / abs(a["loss"])
    d_gn = abs(a["grad_norm"] - q["grad_norm"]) / a["grad_norm"]
    ok = (d_loss <= STEP_TOL["loss"] and d_gn <= STEP_TOL["grad_norm"]
          and a["q1"] == 0 and q["q1"] == Q1_PER_FORWARD["64_256"])
    print(f"[quant train step] {card} | full width B={B} {r}x{r} f32 w8a8, "
          f"dropout off, injected gamma+noise, Q1's plain version vs Q1: "
          f"loss {a['loss']:.6f} vs {q['loss']:.6f} (rel {d_loss:.3g}), "
          f"grad_norm {a['grad_norm']:.6g} vs {q['grad_norm']:.6g} (rel "
          f"{d_gn:.3g}) | Q1 launches {a['q1']} / {q['q1']} (want 0 / "
          f"{Q1_PER_FORWARD['64_256']}) {'ok' if ok else 'FAIL'}", flush=True)
    out = {"parity": dict(arms, rel_loss=d_loss, rel_grad_norm=d_gn,
                          ok=ok)}
    launches = 0
    for mode in ("w8a8", ""):
        with quant_mode(mode):
            net = unet_from_config(cfg["model"]["unet"], device=dev,
                                   seed=seed)
        state = create_train_state(net, make_optimizer(
            net.parameters(), cfg["train"]["optimizer"]))
        fn = make_train_step(eng)
        losses, t_first = [], None
        kernels.reset_launch_counts()
        for i in range(QUANT_TRAIN_STEPS):
            state, m = fn(state, batch, step_generator(seed, i, dev))
            losses.append(m["l_pix"])
            if i == 0:
                torch.cuda.synchronize()
                t_first = time.perf_counter()
        torch.cuda.synchronize()
        rate = (QUANT_TRAIN_STEPS - 1) / (time.perf_counter() - t_first)
        losses = torch.stack(losses).tolist()
        got = dict(kernels.LAUNCHES)
        want_q1 = Q1_PER_FORWARD["64_256"] * QUANT_TRAIN_STEPS if mode else 0
        r_ok = (all(map(math.isfinite, losses))
                and got["quant_conv3"] == want_q1
                and got["gn_swish"] == 45 * QUANT_TRAIN_STEPS)
        ok &= r_ok
        launches += got["quant_conv3"]
        out[mode or "none"] = {"l_pix": losses, "steps_per_s": rate,
                               "launches": got, "ok": r_ok}
        print(f"[quant train] {card} | {QUANT_TRAIN_STEPS} steps of the "
              f"train config, B={B} {r}x{r} f32, dropout "
              f"{cfg['model']['unet'].get('dropout')}, quant "
              f"{mode or 'none'}: l_pix {[round(v, 5) for v in losses]}, "
              f"{rate:.3f} steps/s after the first | launches Q1 "
              f"{got['quant_conv3']} (want {want_q1}), K1 {got['gn_swish']} "
              f"{'ok' if r_ok else 'FAIL'}", flush=True)
        del net, state
    torch.cuda.empty_cache()
    return out, launches, ok


def quant_export(cfg, card, seed):
    """A w8a8 DPM-Solver++ sampler of QUANT_EXPORT_STEPS steps at batch
    QUANT_EXPORT_BATCH, f32, exported (serving.build_sample_export), its
    fdsr::quant_conv3 nodes counted (21 per eval), saved, loaded in this
    process and run against the in-process sampler with the same
    per-image generators: bit-equal, with the same Q1 launches."""
    import numpy as np
    import torch

    from fastdiffsr_tpu_torch import serving
    from fastdiffsr_tpu_torch.cli.infer import make_denoiser
    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.ops import kernels
    from fastdiffsr_tpu_torch.train import make_sample_fn, pad_batch_with_keys
    dev = torch.device("cuda")
    S, B = QUANT_EXPORT_STEPS, QUANT_EXPORT_BATCH
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(
                              cfg["model"]["beta_schedule"]["val"],
                              device=dev))
    with quant_mode("w8a8"):
        net = unet_from_config(cfg["model"]["unet"], device=dev, seed=seed)
    t0 = time.time()
    ep, meta = serving.build_sample_export(eng, net, 256, batch=B,
                                           sampler="dpm", steps=S,
                                           fused=False)
    export_s = time.time() - t0
    nodes = sum(1 for n in ep.graph.nodes if n.op == "call_function"
                and str(n.target).startswith("fdsr.quant_conv3"))
    path = os.path.join(ROOT, "build", "smoke", "quant", "w8a8_dpm.pt2")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    serving.save_exported(ep, meta, path)
    del ep
    t0 = time.time()
    loaded = serving.load_exported(path)
    load_s = time.time() - t0
    cond = np.random.default_rng(seed + 25).uniform(
        -1, 1, (B, 256, 256, 3)).astype(np.float32)
    params = {k: v.detach() for k, v in net.state_dict().items()}
    x, gens = pad_batch_with_keys(cond, B, seed, 0, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = loaded(params, x, gens)
    torch.cuda.synchronize()
    l_art = dict(kernels.LAUNCHES)
    fn = make_sample_fn(eng, make_denoiser(net, False, torch.float32),
                        sampler="dpm", ddim_steps=S)
    _, gens = pad_batch_with_keys(cond, B, seed, 0, device=dev)
    kernels.reset_launch_counts()
    want = fn(x, gens)
    torch.cuda.synchronize()
    l_in = dict(kernels.LAUNCHES)
    err = (got - want).abs().max().item()
    q1 = Q1_PER_FORWARD["64_256"] * S
    ok = (torch.equal(got, want) and nodes == q1
          and l_art["quant_conv3"] == l_in["quant_conv3"] == q1)
    print(f"[quant export] {card} | w8a8 DPM-Solver++ {S} steps, batch {B} "
          f"f32, 256x256: export {export_s:.1f} s, load {load_s:.1f} s, "
          f"{os.path.getsize(path) / 2 ** 20:.1f} MB, {nodes} "
          f"fdsr::quant_conv3 nodes (want {q1}) | loaded vs in-process: "
          f"bit-equal {torch.equal(got, want)} (max |d| {err:.3g}), Q1 "
          f"launches {l_art['quant_conv3']} / {l_in['quant_conv3']} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    del net, loaded, got, want
    torch.cuda.empty_cache()
    return {"export_s": export_s, "load_s": load_s, "nodes": nodes,
            "max_abs_err": err, "launches": l_art, "ok": ok}, \
        l_art["quant_conv3"] + l_in["quant_conv3"], ok


def quant_gn_variants(sigs, groups, card, seed):
    """gn_swish_stats and gn_swish_dot (the JAX package's other forms of
    GroupNorm -> Swish) at the GroupNorm inputs of the quantized Blocks of
    a 64->256 eval, batch 16, f32 and bf16: each within K1's tolerance of
    gn_swish_reference, with its device ms beside K1's."""
    import torch

    from fastdiffsr_tpu_torch.ops.groupnorm import (gn_swish, gn_swish_dot,
                                                    gn_swish_reference,
                                                    gn_swish_stats)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 26)
    rows, ok = [], True
    fns = {"k1": gn_swish, "stats": gn_swish_stats, "dot": gn_swish_dot}
    for H, W, ci in sorted({s[:3] for s in sigs}, reverse=True):
        for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = (torch.randn((B_KERNEL, H, W, ci), generator=g, device=dev)
                 * 2 + 0.5).to(dt)
            scale = torch.randn(ci, generator=g, device=dev) * 0.1 + 1
            bias = torch.randn(ci, generator=g, device=dev) * 0.1
            want = gn_swish_reference(x, scale, bias, groups).float()
            row = {"H": H, "W": W, "C": ci, "B": B_KERNEL, "dtype": dt_name}
            for name, fn in fns.items():
                dy = (fn(x, scale, bias, groups).float() - want).abs()
                if dt_name == "f32":
                    f_ok = dy.max().item() <= K1_TOL["f32"]
                else:
                    rel, atol = K1_TOL["bf16"]
                    f_ok = bool((dy <= want.abs() * rel + atol).all())
                ok &= f_ok
                row[f"{name}_max_abs_err"] = dy.max().item()
                row[f"{name}_ok"] = f_ok
                row[f"{name}_ms"] = device_ms(
                    lambda: fn(x, scale, bias, groups), REPS)
                del dy
            rows.append(row)
            r_ok = all(row[f"{k}_ok"] for k in fns)
            print(f"[gn variants] {card} | {dt_name} B={B_KERNEL} {H}x{W} "
                  f"C={ci} G={groups} vs gn_swish_reference: max|dy| K1 "
                  f"{row['k1_max_abs_err']:.3g}, stats "
                  f"{row['stats_max_abs_err']:.3g}, dot "
                  f"{row['dot_max_abs_err']:.3g} (K1's tolerance) | device: "
                  f"K1 {row['k1_ms']:.4f} ms, gn_swish_stats "
                  f"{row['stats_ms']:.4f} ms, gn_swish_dot "
                  f"{row['dot_ms']:.4f} ms {'ok' if r_ok else 'FAIL'}",
                  flush=True)
            del x, want
    return rows, ok


def phase_quant(card, seed):
    """Phase 22, the W8A8 path: Q1 against its plain version at every
    quantized shape of a 64->256 eval (batch 16) and the further ones of a
    128->512 eval (batch 1), serving with and without quant, cli.infer
    with w8a8, training with w8a8, a w8a8 export, and the GroupNorm
    variants. Returns (detail, Q1 launches of the path's runs, ok)."""
    from fastdiffsr_tpu_torch.config import load_json_config
    t_phase = time.time()

    def config(name):
        return load_json_config(os.path.join(
            ROOT, "fastdiffsr_tpu_torch", "configs", f"{name}.json"))

    cfg = config("sr_fastdiffsr_test_64_256")
    sigs, extra, n, ok = q1_shapes(card, seed)
    detail = {"calls_per_eval": n}
    rows, q_ok = phase_q1(sigs, B_KERNEL, card, seed)
    rows_512, q512_ok = phase_q1(extra, 1, card, seed)
    ok &= q_ok and q512_ok
    tot = q1_per_eval(rows, card)
    detail.update(q1=rows, q1_512=rows_512, q1_total=tot)
    detail["serve"], serve_l, s_ok = quant_serve(cfg, card, seed)
    detail["infer"], i_ok = quant_infer(cfg, card, seed)
    detail["train"], train_l, t_ok = quant_train(
        config("sr_fastdiffsr_train_64_256"), card, seed)
    detail["export"], export_l, e_ok = quant_export(cfg, card, seed)
    detail["gn_variants"], gn_ok = quant_gn_variants(
        sigs, cfg["model"]["unet"].get("norm_groups") or 32, card, seed)
    ok &= s_ok and i_ok and t_ok and e_ok and gn_ok
    launches = (serve_l["quant_conv3"] + detail["infer"]["launches"][
        "quant_conv3"] + train_l + export_l)
    detail.update(seconds=time.time() - t_phase, ok=ok, launches=launches)
    print(f"[quant] {card} | phase 22 took {detail['seconds']:.1f} s "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return detail, launches, ok


def q1_entry(quant):
    """The ``kernels`` line's Q1 entry from phase 22's detail: per
    64->256 eval at batch 16 (bf16 maps; ``*_f32`` keys for f32), every
    number measured in this run."""
    rows = quant["q1"] + quant["q1_512"]
    tot = quant["q1_total"]
    ops = sum(r["bound_ms_bf16"] * r["calls_per_eval"] for r in quant["q1"]
              if r["bound_by_bf16"] == "operations")
    return {"name": "quant_conv3", "route": "cuda",
            "source": "fastdiffsr_tpu_torch/csrc/quant_conv.cu",
            "replaces": "fastdiffsr_tpu/ops/quant.py:60",
            "launches": quant["launches"],
            "max_abs_err": max(c["max_abs_err"] for r in rows
                               for c in r["checks"].values()),
            "ms": tot["ms_bf16"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms_bf16"],
            "bound_by": ("operations" if ops >= tot["bound_ms_bf16"] / 2
                         else "bytes"),
            "library_ms": None, "wall_ms": tot["wall_ms_bf16"],
            "ms_f32": tot["ms_f32"], "bound_ms_f32": tot["bound_ms_f32"],
            "int_mm_ms": tot["int_mm_ms"],
            "cudnn_bf16_ms": tot["cudnn_bf16_ms"],
            "launches_per_call": max(max(r["launches_per_call_f32"],
                                         r["launches_per_call_bf16"])
                                     for r in rows)}


def rewrite_env(mode):
    """The builders' variables for phase 23's ``mode``: one rewrite over
    the literal forms (the Upsample 'dense'), no quant."""
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import resblock_names
    base = {"FASTDIFFSR_TPU_UPSAMPLE": "dense", "FASTDIFFSR_TPU_FOLD": "",
            "FASTDIFFSR_TPU_SKIP_CONCAT": "", "FASTDIFFSR_TPU_CONV_SPLIT": "",
            "FASTDIFFSR_TPU_QUANT": ""}
    ups = ",".join(sorted((n for n in resblock_names(4, 2)
                           if n.startswith("ups_")),
                          key=lambda n: int(n[4:])))
    return dict(base, **{
        "literal": {}, "tconv": {"FASTDIFFSR_TPU_UPSAMPLE": "tconv"},
        "d2s2": {"FASTDIFFSR_TPU_UPSAMPLE": "d2s2"},
        "fold_down": {"FASTDIFFSR_TPU_FOLD": "down"},
        "fold_all": {"FASTDIFFSR_TPU_FOLD": "all"},
        "split": {"FASTDIFFSR_TPU_SKIP_CONCAT": "split"},
        "swap": {"FASTDIFFSR_TPU_SKIP_CONCAT": "swap"},
        "conv_split": {"FASTDIFFSR_TPU_CONV_SPLIT": ups}}[mode])


def upsample_forms(card, seed):
    """Phase 23a: the three Upsample forms at UPS_SHAPES, f32 and bf16:
    tconv and d2s2 against the literal form, and the device and wall ms of
    each (one call of ``apply_upsample2_conv3``)."""
    import torch

    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import \
        apply_upsample2_conv3
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 23)
    rows, ok = [], True
    for B, C, H in UPS_SHAPES:
        w = torch.randn((C, C, 3, 3), generator=g, device=dev) / math.sqrt(
            9 * C)
        b = torch.randn(C, generator=g, device=dev) * 0.1
        xf = torch.randn((B, C, H, H), generator=g, device=dev).contiguous(
            memory_format=torch.channels_last)
        for dt_name in ("f32", "bf16"):
            dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt_name]
            x = xf.to(dt)
            want = apply_upsample2_conv3(x, w, b, "", dt).float()
            scale = max(1.0, want.abs().max().item())
            es = 2 if dt_name == "bf16" else 4
            # the least work of the function: 4 taps per output pixel
            b_ms, b_by = bound(2.0 * 16 * B * H * H * C * C,
                               5.0 * B * H * H * C * es + 9 * C * C * es,
                               dt_name)
            row = {"B": B, "C": C, "H": H, "dtype": dt_name,
                   "bound_ms": b_ms, "bound_by": b_by}
            for mode in ("", "tconv", "d2s2"):
                name = mode or "dense"
                got = apply_upsample2_conv3(x, w, b, mode, dt)
                again = torch.equal(got, apply_upsample2_conv3(x, w, b,
                                                               mode, dt))
                err = (got.float() - want).abs().max().item()
                tol = UPS_TOL[dt_name] * scale
                r_ok = (err <= tol and again
                        and bool(torch.isfinite(got).all())
                        and got.is_contiguous(
                            memory_format=torch.channels_last))
                ok &= r_ok
                ms, wall = timed(
                    lambda: apply_upsample2_conv3(x, w, b, mode, dt), REPS)
                row[name] = {"ms": ms, "wall_ms": wall, "max_abs_err": err,
                             "tol": tol, "ok": r_ok, "repeat_equal": again}
                del got
            rows.append(row)
            ok_row = all(row[m]["ok"] for m in ("dense", "tconv", "d2s2"))
            print(f"[upsample] {card} | {dt_name} B={B} {H}x{H} C={C} -> "
                  f"{2 * H}x{2 * H} | device ms: dense "
                  f"{row['dense']['ms']:.4f} tconv {row['tconv']['ms']:.4f} "
                  f"d2s2 {row['d2s2']['ms']:.4f} (wall "
                  f"{row['dense']['wall_ms']:.4f} / "
                  f"{row['tconv']['wall_ms']:.4f} / "
                  f"{row['d2s2']['wall_ms']:.4f}) | bound {b_ms:.4f} ms "
                  f"({b_by}) | vs dense max|dy| tconv "
                  f"{row['tconv']['max_abs_err']:.3g} d2s2 "
                  f"{row['d2s2']['max_abs_err']:.3g} (tol "
                  f"{row['tconv']['tol']:.3g}) | a second call bit-equal: "
                  + " ".join(f"{m} {row[m]['repeat_equal']}"
                             for m in ("dense", "tconv", "d2s2"))
                  + f" {'ok' if ok_row else 'FAIL'}",
                  flush=True)
            del x, want
        del xf
    per_eval = {}
    for dt_name in ("f32", "bf16"):
        for tag, Bs in (("64_256", REWRITE_B), ("128_512", 1)):
            sel = [r for r in rows if r["dtype"] == dt_name and r["B"] == Bs]
            per_eval[f"{dt_name}_{tag}"] = {
                m: sum(r[m]["ms"] for r in sel)
                for m in ("dense", "tconv", "d2s2")}
            pe = per_eval[f"{dt_name}_{tag}"]
            print(f"[upsample total] {card} | {dt_name} per {tag} eval "
                  f"(3 Upsamples, B={Bs}), device ms: dense "
                  f"{pe['dense']:.4f} tconv {pe['tconv']:.4f} d2s2 "
                  f"{pe['d2s2']:.4f}", flush=True)
    return {"rows": rows, "per_eval": per_eval}, ok


def rewrite_forwards(card, seed):
    """Phase 23b: the plain forward of sr_fastdiffsr_test_64_256.json at
    full width, B=REWRITE_B, 256x256, built by ``unet_from_config`` in each
    of REWRITE_MODES from the same randomized weights, in f32 and bf16:
    each mode against the literal forward of its type, its K1 launches
    per forward and ms per eval. Returns (detail, K1 signatures by mode
    (f32), K1 launches, ok)."""
    import torch

    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.ops import kernels
    cfg = load_json_config(os.path.join(ROOT, "fastdiffsr_tpu_torch",
                                        "configs",
                                        "sr_fastdiffsr_test_64_256.json"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 24)
    x = torch.randn((REWRITE_B, 256, 256, 6), generator=g, device=dev)
    level = torch.rand((REWRITE_B,), generator=g, device=dev)
    weights, refs, detail, sigs, ok, k1 = None, {}, {}, {}, True, 0
    for mode in REWRITE_MODES:
        with environ(rewrite_env(mode)):
            net = unet_from_config(cfg["model"]["unet"], device=dev,
                                   seed=seed)
        if weights is None:
            weights = {k: v.clone() for k, v in randomize_params(
                net, seed + 25).state_dict().items()}
        net.load_state_dict(weights)

        def fwd():
            with torch.no_grad():
                return net(x, level)

        for dt_name in ("f32", "bf16"):
            net.dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[
                dt_name]
            kernels.reset_launch_counts()
            y, s, strided = record_k1_batch(fwd)
            torch.cuda.synchronize()
            n_k1 = kernels.LAUNCHES["gn_swish"]
            ms = time_ms(fwd, REWRITE_EVALS, warmup=1)
            again = torch.equal(y, fwd())
            k1 += kernels.LAUNCHES["gn_swish"]
            if dt_name == "f32":
                sigs[mode] = s
            ref = refs.setdefault(dt_name, y)
            tol = UNET_TOL[dt_name] * max(1.0, ref.abs().max().item())
            err = (y - ref).abs().max().item()
            r_ok = (err <= tol and again and bool(torch.isfinite(y).all())
                    and strided == 0
                    and n_k1 == sum(s.values()) >= K1_PER_FORWARD[
                        "fastdiffsr"])
            ok &= r_ok
            detail[f"{mode}_{dt_name}"] = {
                "ms": ms, "k1_per_forward": n_k1, "max_abs_err": err,
                "tol": tol, "k1_shapes": len(s), "repeat_equal": again,
                "ok": r_ok}
            print(f"[rewrite {mode}] {card} | plain forward {dt_name} "
                  f"B={REWRITE_B} 256x256 full width via unet_from_config: "
                  f"{ms:.3f} ms per eval (CUDA events over "
                  f"{REWRITE_EVALS} evals) | K1 {n_k1} launches per "
                  f"forward in {len(s)} shapes, {strided} not contiguous "
                  f"NHWC | vs literal max|dy|={err:.3g} (tol {tol:.3g}); a "
                  f"second forward bit-equal {again} "
                  f"{'ok' if r_ok else 'FAIL'}", flush=True)
            del y
        del net
    del refs
    torch.cuda.empty_cache()
    return detail, sigs, k1, ok


def rewrite_k1(sigs, card, seed):
    """Phase 23c: K1 against its plain version at every K1 shape the
    rewrites add to the literal forward's (fold's 2C maps at half the
    batch, the split parts); fold's three 256x256 maps must be among
    them."""
    lit = set(sigs["literal"])
    new = {}
    for mode, s in sigs.items():
        for sg, n in s.items():
            if sg not in lit:
                new.setdefault(sg, {})[mode] = n
    want = {(8, 256, 256, 128, 64), (8, 256, 256, 384, 64),
            (8, 256, 256, 256, 64)}
    ok = want <= set(new)
    print(f"[rewrite K1 shapes] {card} | {len(new)} K1 shapes beyond the "
          f"literal forward's: "
          + ", ".join(f"{sg[:4]} G={sg[4]} ({'/'.join(sorted(m))})"
                      for sg, m in sorted(new.items()))
          + f" | fold's three present {ok} {'ok' if ok else 'FAIL'}",
          flush=True)
    rows = []
    for B in sorted({sg[0] for sg in new}):
        by = {sg[1:]: max(new[sg].values()) for sg in new if sg[0] == B}
        r, r_ok = phase_k1(by, B, REPS, card, seed)
        rows += r
        ok &= r_ok
    return rows, ok


def set_upsample_mode(net, mode):
    """Every Upsample form of ``net`` (SR3's Upsample modules, the guided
    up ResBlocks, the ConditionalUNet) set to ``mode``."""
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import Upsample
    for m in net.modules():
        if isinstance(m, Upsample):
            m.mode = mode
        elif hasattr(m, "upsample_mode"):
            m.upsample_mode = mode


def upsample_modes(net):
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import Upsample
    return {m.mode if isinstance(m, Upsample) else m.upsample_mode
            for m in net.modules()
            if isinstance(m, Upsample) or hasattr(m, "upsample_mode")}


def rewrite_nets(card, seed):
    """Phase 23d: SR3 (ddpm), guided (gdp) and ConditionalUNet at their
    shipped widths, built with the builders' default Upsample (tconv: the
    variable unset), randomized weights, one forward with it and one with
    the literal form, f32, B=2, 256x256, and the ms of each. Returns
    (detail, K1 launches, ok)."""
    import torch

    from fastdiffsr_tpu_torch.cli.infer import build_unet
    from fastdiffsr_tpu_torch.models.cond_unet import cond_unet_from_config
    from fastdiffsr_tpu_torch.ops import kernels
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 26)
    B = 2
    x = torch.randn((B, 256, 256, 6), generator=g, device=dev)
    t = torch.randint(0, 1000, (B,), generator=g, device=dev).float()
    detail, ok, k1 = {}, True, 0
    for name in ("ddpm", "gdp", "cond_unet"):
        with environ({"FASTDIFFSR_TPU_UPSAMPLE": None}):
            net = (cond_unet_from_config({"nf": 64, "depth": 4}, device=dev,
                                         seed=seed) if name == "cond_unet"
                   else build_unet(variant_cfg(name)["model"], device=dev,
                                   seed=seed))
        built = upsample_modes(net)
        randomize_params(net, seed + 27).eval()

        def fwd():
            with torch.no_grad():
                if name == "cond_unet":
                    return net(x[..., :3], x[..., 3:], t)
                return net(x, t)

        outs = {}
        for mode in ("tconv", ""):
            set_upsample_mode(net, mode)
            kernels.reset_launch_counts()
            outs[mode] = fwd()
            detail[f"{name}_{mode or 'dense'}_ms"] = time_ms(fwd, 2,
                                                             warmup=1)
            k1 += kernels.LAUNCHES["gn_swish"]
        err = (outs["tconv"] - outs[""]).abs().max().item()
        tol = UNET_TOL["f32"] * max(1.0, outs[""].abs().max().item())
        r_ok = (built == {"tconv"} and err <= tol
                and bool(torch.isfinite(outs["tconv"]).all()))
        ok &= r_ok
        detail[f"{name}_max_abs_err"] = err
        print(f"[rewrite {name}] {card} | f32 B={B} 256x256, randomized "
              f"weights, built with {sorted(built)}: tconv Upsample "
              f"{detail[f'{name}_tconv_ms']:.3f} ms, literal "
              f"{detail[f'{name}_dense_ms']:.3f} ms per forward | "
              f"max|dy|={err:.3g} (tol {tol:.3g}) {'ok' if r_ok else 'FAIL'}",
              flush=True)
        del outs, net
        torch.cuda.empty_cache()
    return detail, k1, ok


def rewrite_train(card, seed):
    """Phase 23e: REWRITE_TRAIN_STEPS train steps (after one untimed) of
    sr_fastdiffsr_train_64_256.json at full width, B=4, built with the
    builder's default Upsample (tconv: the variable unset), then the same
    with the literal one, from the same initial weights and step
    generators: steps/s of each, and the first step's loss equal within
    STEP_TOL["loss"]. Returns (detail, K1 launches, ok)."""
    import torch

    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import unet_from_config
    from fastdiffsr_tpu_torch.ops import kernels
    from fastdiffsr_tpu_torch.train import (create_train_state,
                                            make_train_step, step_generator)
    cfg = load_json_config(os.path.join(ROOT, "fastdiffsr_tpu_torch",
                                        "configs",
                                        "sr_fastdiffsr_train_64_256.json"))
    dev = torch.device("cuda")
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(
                              cfg["model"]["beta_schedule"]["train"],
                              device=dev))
    r = int(cfg["datasets"]["train"]["r_resolution"])
    g = torch.Generator(device=dev).manual_seed(seed + 28)
    batch = {k: torch.rand((B_TRAIN, r, r, 3), generator=g, device=dev)
             * 2 - 1 for k in ("HR", "SR")}
    lr = float(cfg["train"]["optimizer"]["lr"])
    with environ({"FASTDIFFSR_TPU_UPSAMPLE": None}):
        net = unet_from_config(cfg["model"]["unet"], device=dev, seed=seed)
    built = upsample_modes(net)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    step = make_train_step(eng, ema_start=0)
    detail, ok, k1 = {}, built == {"tconv"}, 0
    for mode in ("tconv", ""):
        set_upsample_mode(net, mode)
        net.load_state_dict(start)
        state = create_train_state(net, torch.optim.Adam(
            net.parameters(), lr=lr))
        losses = []
        kernels.reset_launch_counts()
        for k in range(1 + REWRITE_TRAIN_STEPS):
            if k == 1:
                torch.cuda.synchronize()
                t0 = time.time()
            state, m = step(state, batch, step_generator(seed, k, dev))
            losses.append(m["l_pix"])
        torch.cuda.synchronize()
        rate = REWRITE_TRAIN_STEPS / (time.time() - t0)
        n_k1 = kernels.LAUNCHES["gn_swish"]
        k1 += n_k1
        losses = [v.item() for v in losses]
        detail[mode or "dense"] = {"steps_per_s": rate, "l_pix": losses,
                                   "k1": n_k1}
        ok &= (n_k1 == K1_PER_FORWARD["fastdiffsr"]
               * (1 + REWRITE_TRAIN_STEPS)
               and all(math.isfinite(v) for v in losses))
        del state
    del net
    torch.cuda.empty_cache()
    a, b = detail["tconv"]["l_pix"][0], detail["dense"]["l_pix"][0]
    d_loss = abs(a - b) / abs(b)
    ok &= d_loss <= STEP_TOL["loss"]
    detail["rel_loss_first_step"] = d_loss
    print(f"[rewrite train] {card} | sr_fastdiffsr_train_64_256.json full "
          f"width B={B_TRAIN} f32, built with {sorted(built)}, "
          f"{REWRITE_TRAIN_STEPS} steps after one: tconv "
          f"{detail['tconv']['steps_per_s']:.3f} steps/s, dense "
          f"{detail['dense']['steps_per_s']:.3f} steps/s | first l_pix "
          f"{a:.6f} vs {b:.6f} (rel {d_loss:.3g}, tol {STEP_TOL['loss']}) | "
          f"K1 launches {detail['tconv']['k1']} / {detail['dense']['k1']} "
          f"(want {K1_PER_FORWARD['fastdiffsr'] * (1 + REWRITE_TRAIN_STEPS)}"
          f") {'ok' if ok else 'FAIL'}", flush=True)
    return detail, k1, ok


def phase_rewrites(card, seed):
    """Phase 23, the exact rewrites (module docstring). Returns (detail,
    K1 launches of the path's runs, ok)."""
    t_phase = time.time()
    laps, t_lap = {}, [time.time()]

    def lap(name):
        now = time.time()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    detail = {}
    detail["upsample"], u_ok = upsample_forms(card, seed)
    lap("upsample")
    detail["forwards"], sigs, k1_fwd, f_ok = rewrite_forwards(card, seed)
    lap("forwards")
    detail["k1"], k_ok = rewrite_k1(sigs, card, seed)
    lap("K1")
    detail["nets"], k1_nets, n_ok = rewrite_nets(card, seed)
    lap("nets")
    detail["train"], k1_train, t_ok = rewrite_train(card, seed)
    lap("train")
    ok = u_ok and f_ok and k_ok and n_ok and t_ok
    launches = k1_fwd + k1_nets + k1_train
    detail.update(seconds=time.time() - t_phase, ok=ok, launches=launches,
                  part_seconds=laps)
    print(f"[rewrites] {card} | phase 23 took {detail['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
          + f"), {launches} K1 launches {'ok' if ok else 'FAIL'}",
          flush=True)
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
             "gn_swish": K1_PER_FORWARD["gdp"] * T, "quant_conv3": 0})
        rows.append(dict(row, dtype=dt, T=T, ok=r_ok))
        ok &= r_ok
    print(json.dumps({"card": card, "gdp_reference": rows}))
    return 0 if ok else 1


def phase_naf_modes(card, seed):
    """Phase 24, NAFNet's layout modes: the paper's full-width NAFNet
    (setting_mfe_Train_x4.yml, phase 16's) built through
    ``ediffsr.train.naf_modes`` in each of NAF_MODES from the literal
    net's weights (randomized by ``randomize_naf``), at B=NAF_B on 256x256
    inputs: forward ms (CUDA events, NAF_REPS calls), max|dy| to the
    literal forward (within NAF_TOL * max(1, max|y|)) and a second call
    bit-equal, on cuDNN's deterministic algorithms; then NAF_STEPS timed
    train steps (L1 to a seeded target, AdamW as the option file has it)
    from the same weights, the first step's loss against the literal's.
    No kernel of ours runs. Returns (detail, ok)."""
    import torch

    from fastdiffsr_tpu_torch.ediffsr import train as etrain
    from fastdiffsr_tpu_torch.ediffsr.options import load_yaml
    from fastdiffsr_tpu_torch.models.nafnet import nafnet_from_config
    from fastdiffsr_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    with open(os.path.join(ROOT, "fastdiffsr_tpu_torch", "ediffsr",
                           "options_yml", "setting_mfe_Train_x4.yml")) as f:
        opt = load_yaml(f.read())
    setting = opt["network_G"]["setting"]
    g = torch.Generator(device=dev).manual_seed(seed + 41)
    x, c, target = (torch.rand((NAF_B, 256, 256, 3), generator=g,
                               device=dev) * 2 - 1 for _ in range(3))
    t = torch.tensor([17.0, 71.0], device=dev)[:NAF_B]
    lit = randomize_naf(nafnet_from_config(setting, device=dev, seed=seed),
                        seed + 5)
    start = {k: v.clone() for k, v in lit.state_dict().items()}
    detail, ok, want = {}, True, None
    kernels.reset_launch_counts()
    for dw, fold in NAF_MODES:
        name = "+".join(m for m in (dw, fold and f"fold {fold}") if m) \
            or "literal"
        with environ({"FASTDIFFSR_TPU_NAF_DW": dw or None,
                      "FASTDIFFSR_TPU_NAF_FOLD": fold or None}):
            modes = etrain.naf_modes()
        net = nafnet_from_config(setting, device=dev, seed=seed, **modes)
        net.load_state_dict(start, strict=True)
        net.eval()
        torch.backends.cudnn.deterministic = True
        try:
            with torch.no_grad():
                y = net(x, c, t)
                again = net(x, c, t)
        finally:
            torch.backends.cudnn.deterministic = False
        if want is None:
            want = y
        err = (y - want).abs().max().item()
        tol = NAF_TOL * max(1.0, want.abs().max().item())
        repeat = torch.equal(y, again)

        def fwd():
            with torch.no_grad():
                net(x, c, t)
        fwd_ms = time_ms(fwd, NAF_REPS)
        net.train()
        optim = torch.optim.AdamW(net.parameters(), lr=4e-5,
                                  betas=(0.9, 0.99), eps=1e-8,
                                  weight_decay=1e-4)
        losses = []

        def step():
            loss = (net(x, c, t) - target).abs().mean()
            optim.zero_grad(set_to_none=True)
            loss.backward()
            optim.step()
            losses.append(loss.detach())
        step_ms = time_ms(step, NAF_STEPS, warmup=1)
        first = losses[0].item()
        row = {"modes": modes, "fwd_ms": fwd_ms, "max_abs_err": err,
               "tol": tol, "repeats_bit_equal": repeat,
               "train_step_ms": step_ms, "first_loss": first}
        detail[name] = row
        base = detail["literal"]["first_loss"]
        d_loss = abs(first - base) / abs(base)
        row_ok = (err <= tol and repeat and math.isfinite(first)
                  and d_loss <= STEP_TOL["loss"])
        ok &= row_ok
        print(f"[naf {name}] {card} | setting_mfe_Train_x4 NAFNet full "
              f"width, B={NAF_B} 256x256 f32, modes {modes}: forward "
              f"{fwd_ms:.3f} ms, train step {step_ms:.3f} ms "
              f"({1e3 / step_ms:.3f} steps/s) | max|dy| to literal "
              f"{err:.3g} (tol {tol:.3g}), second call bit-equal {repeat} "
              f"| first loss {first:.6f} (rel to literal {d_loss:.3g}, tol "
              f"{STEP_TOL['loss']}) {'ok' if row_ok else 'FAIL'}",
              flush=True)
        del net, optim
    launches = dict(kernels.LAUNCHES)
    ok &= not any(launches.values())
    detail["launches"] = launches
    del lit, x, c, target
    torch.cuda.empty_cache()
    return detail, ok


def write_decode_dirs(root, seed):
    """Two LRHR folder trees under ``root`` (``sr_64_256`` and
    ``hr_256``), DECODE_IMAGES seeded smooth 256x256 tiles each, one in
    PNG and one in JPEG (quality 95), written by PIL."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from PIL import Image

    g = torch.Generator(device="cuda").manual_seed(seed)
    small = torch.rand((DECODE_IMAGES, 3, 24, 24), generator=g,
                       device="cuda")
    img = (F.interpolate(small, size=256, mode="bicubic",
                         align_corners=False).clamp(0, 1) * 255).round()
    img = img.to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    roots = {}
    for ext in ("png", "jpg"):
        base = os.path.join(root, ext)
        for sub, imgs in (("hr_256", img), ("sr_64_256",
                                            np.ascontiguousarray(
                                                img[:, ::-1]))):
            d = os.path.join(base, sub)
            os.makedirs(d, exist_ok=True)
            for j, a in enumerate(imgs):
                kw = {"quality": 95} if ext == "jpg" else {}
                Image.fromarray(a).save(os.path.join(d, f"{j:04d}.{ext}"),
                                        **kw)
        roots[ext] = base
    return roots


def phase_decode(card, seed):
    """Phase 25, the native PNG/JPEG decoder on the host
    (``fastdiffsr_tpu_torch.native``, built with g++ on this machine):
    whether it built (and why not), then a seeded folder of DECODE_IMAGES
    256x256 PNG pairs and one of JPEG pairs read through ``LRHRDataset``
    with the native decoder and with FASTDIFFSR_TPU_NO_NATIVE=1 (PIL):
    seconds per image for each, PNG bit-equal, JPEG's max|d| (in [-1, 1]
    units) reported. Returns (detail, ok)."""
    import numpy as np

    from fastdiffsr_tpu_torch import native
    from fastdiffsr_tpu_torch.data import dataset

    roots = write_decode_dirs(os.path.join(ROOT, "build", "smoke", "decode",
                                           f"d_{seed}"), seed + 43)
    t0 = time.time()
    built = native.get_lib() is not None
    build_s = time.time() - t0
    print(f"[decode build] {card} | native decoder "
          f"{'built and loaded' if built else 'NOT built'} in {build_s:.2f} "
          f"s ({native.library_path()})"
          + ("" if built else f": {native.FAILURE}"), flush=True)
    detail, ok = {"built": built, "build_s": build_s,
                  "failure": native.FAILURE}, True
    for ext, root in roots.items():
        out = {}
        for dec, flag in (("native", None), ("pil", "1")):
            with environ({"FASTDIFFSR_TPU_NO_NATIVE": flag}):
                ds = dataset.LRHRDataset(root, "img", 64, 256, split="val")
                t0 = time.time()
                items = [ds[i] for i in range(len(ds))]
                dt = time.time() - t0
            out[dec] = (items, dt / (2 * len(ds)))
        err = max(float(np.abs(a[k] - b[k]).max())
                  for a, b in zip(out["native"][0], out["pil"][0])
                  for k in ("HR", "SR"))
        row = {"images": 2 * len(out["pil"][0]),
               "s_per_image_native": out["native"][1],
               "s_per_image_pil": out["pil"][1], "max_abs_err": err}
        detail[ext] = row
        row_ok = len(out["pil"][0]) == DECODE_IMAGES and (
            err == 0.0 if ext == "png" else err <= DECODE_JPEG_TOL)
        ok &= row_ok
        first = "native" if built else "PIL (the native decoder did not build)"
        print(f"[decode {ext}] {card} | LRHRDataset over {row['images']} "
              f"256x256 {ext.upper()} files: {first} "
              f"{row['s_per_image_native'] * 1e3:.3f} ms, NO_NATIVE=1 (PIL) "
              f"{row['s_per_image_pil'] * 1e3:.3f} ms per image (host) | "
              f"max|d| native vs PIL {err:.3g} "
              f"({'want 0' if ext == 'png' else f'tol {DECODE_JPEG_TOL}'}) "
              f"{'ok' if row_ok else 'FAIL'}", flush=True)
    return detail, ok


def chain_setup(cfg_name, seed, dev):
    """(config, train engine, state, device uint8 data) of a train config
    as ``cli.sr_mfe`` builds them, from ``seed``: the net and Adam (on
    the device: capturable) of ``build_all``, CHAIN_TILES seeded tiles."""
    import torch

    from fastdiffsr_tpu_torch.cli.sr_mfe import build_all
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.train import create_train_state, make_optimizer
    cfg = load_json_config(os.path.join(ROOT, "fastdiffsr_tpu_torch",
                                        "configs", f"{cfg_name}.json"))
    eng, _, net = build_all(cfg, dev, seed)
    state = create_train_state(net, make_optimizer(
        net.parameters(), cfg["train"]["optimizer"]))
    r = int(cfg["datasets"]["train"]["r_resolution"])
    g = torch.Generator(device=dev).manual_seed(seed + 47)
    data = {k: torch.randint(0, 256, (CHAIN_TILES, r, r, 3), generator=g,
                             device=dev, dtype=torch.uint8)
            for k in ("HR", "SR")}
    return cfg, eng, state, data


def idle_share(fn, n_steps):
    """(device busy ms per step, idle share) of ``fn`` under
    torch.profiler (tools/torch_train_profile.py's method: the union of
    the device's kernel intervals over the traced window), or (None,
    None) when the profiler sees no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None, None
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    window = max(s[1] for s in spans) - min(s[0] for s in spans)
    total, end = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in kern):
        if end is None or s > end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total / 1e3 / n_steps, 1 - total / window


def device_kernels(fn):
    """Counter of the names of the device kernels (and copies) that one
    call of ``fn`` runs, from a torch.profiler trace: a CUDA-graph replay's
    kernels are traced one by one."""
    import collections

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


def chain_parity(cfg_name, card, seed, tag=""):
    """A chain of CHAIN_N steps replayed from a CUDA graph against eager
    steps from the same state, on cuDNN's deterministic algorithms in the
    script's timed regime, the chain first (the order in which a capture
    once took other plans; PERF.md §6): a state is warmed up and captured
    by its first call (CHAIN_N eager steps; the allocator's
    out-of-memory errors in it counted) and replays once under
    torch.profiler; then a state built alike takes 2 * CHAIN_N eager
    steps and is compared with it (the EMA starts at step
    CHAIN_EMA_START, inside the replay). Prints max|d| of parameters, EMA
    and l_pix and whether they are bit-equal, the card's free memory, the
    replay's device kernels and K1 launches (by kernel name), the host
    counts of the replay and the Adam step count. Passes within CHAIN_TOL
    (parameters, EMA; l_pix relative). ``tag`` marks the printed line
    (" -dist": in phase 18's rank, the states DDP-wrapped, the
    replay's NCCL kernels counted too). Returns (detail, ok)."""
    import torch

    from fastdiffsr_tpu_torch.ops import kernels
    from fastdiffsr_tpu_torch.train import make_cached_train_step

    dev = torch.device("cuda")
    n = CHAIN_N
    torch.backends.cudnn.deterministic = True
    try:
        cfg, eng, state, data = chain_setup(cfg_name, seed, dev)
        bsz = int(cfg["datasets"]["train"]["batch_size"])
        free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
        step = make_cached_train_step(eng, bsz, ema_start=CHAIN_EMA_START,
                                      n_sub=n)
        ooms = torch.cuda.memory_stats().get("num_ooms", 0)
        step(state, data, seed)
        ooms = torch.cuda.memory_stats().get("num_ooms", 0) - ooms
        kernels.reset_launch_counts()
        res = {}
        names = device_kernels(
            lambda: res.update(l=step(state, data, seed)[1]["l_pix"]))
        host = dict(kernels.LAUNCHES)
        nodes = {"all": sum(names.values()),
                 **{k: sum(v for name, v in names.items() if k in name)
                    for k in ("gn_swish_apply_kernel",
                              "channel_stats_kernel")},
                 "nccl": sum(v for name, v in names.items()
                             if "nccl" in name.lower())}
        steps = {int(s["step"].item())
                 for s in state.optimizer.state.values()}
        at, lg = state.step, res["l"].reshape(-1)
        del step
        ref = chain_setup(cfg_name, seed, dev)[2]
        eager = make_cached_train_step(eng, bsz, ema_start=CHAIN_EMA_START)
        le = torch.stack([eager(ref, data, seed)[1]["l_pix"]
                          for _ in range(2 * n)][n:])
        torch.cuda.synchronize()
        pe = dict(ref.net.named_parameters())
        d_param = max((p - pe[k]).abs().max().item()
                      for k, p in state.net.named_parameters())
        d_ema = max((v - ref.ema_params[k]).abs().max().item()
                    for k, v in state.ema_params.items())
        d_loss = (lg - le).abs().max().item()
        rel_loss = d_loss / le.abs().max().item()
    finally:
        torch.backends.cudnn.deterministic = False
    bit = d_param == 0.0 and d_ema == 0.0 and d_loss == 0.0
    want_k1 = K1_PER_FORWARD["fastdiffsr"] * n
    ok = (max(d_param, d_ema) <= CHAIN_TOL and rel_loss <= CHAIN_TOL
          and at == 2 * n and steps == {2 * n}
          and nodes["gn_swish_apply_kernel"] == want_k1
          and nodes["channel_stats_kernel"] == want_k1
          and not any(host.values()))
    print(f"[chain parity{tag} {cfg_name}] {card} | B={bsz}: one replay of {n} "
          f"captured steps vs {n} eager steps from the same state, the "
          f"chain first (EMA from step {CHAIN_EMA_START}; cuDNN "
          f"deterministic): max|d| params {d_param:.3g}, EMA {d_ema:.3g}, "
          f"l_pix {d_loss:.3g} (rel {rel_loss:.3g}; tol {CHAIN_TOL}), "
          f"bit-equal {bit} | {free_gib:.1f} GiB free before the chain, "
          f"out-of-memory errors in its warm-up and capture {ooms} | Adam "
          f"step {sorted(steps)} (want {2 * n}) | per replay "
          f"(torch.profiler): {nodes['all']} device kernels, K1 "
          f"{nodes['gn_swish_apply_kernel']} gn_swish + "
          f"{nodes['channel_stats_kernel']} channel_stats launches (want "
          f"{want_k1} each), {nodes['nccl']} NCCL kernels, host counts "
          f"of the replay {host} {'ok' if ok else 'FAIL'}", flush=True)
    del state, ref, data
    torch.cuda.empty_cache()
    return {"max_abs_param": d_param, "max_abs_ema": d_ema,
            "max_abs_l_pix": d_loss, "bit_equal": bit, "capture_ooms": ooms,
            "free_gib": free_gib, "kernels_per_replay": nodes}, ok


def chain_rates(cfg_name, card, seed, tag=""):
    """Steps/s, peak GiB and the device idle share of the config's train
    step unchained (CHAIN_TIMED eager steps) and chained by CHAIN_N (the
    same steps as CHAIN_TIMED / CHAIN_N replays), in the trainer's cuDNN
    regime, one arm after the other, each alone on the card: the arm's
    state is built and warmed up (the chained one captured), the cache
    the warm-up left (cuDNN's timing workspaces among it) is emptied and
    the allocator's peaks reset, the arm is timed and then profiled
    (CHAIN_PROFILED steps), and freed before the next arm. The peaks are
    the timed steps', counted from before the state's build: allocated
    (live tensors) and reserved (the allocator's segments: the card's
    memory the arm holds, the graph's pool included). Returns (detail,
    ok)."""
    import torch

    from fastdiffsr_tpu_torch.train import make_cached_train_step

    dev = torch.device("cuda")
    detail = {}
    for arm, n in (("unchained", 1), ("chained", CHAIN_N)):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        base_res = torch.cuda.memory_reserved()
        cfg, eng, state, data = chain_setup(cfg_name, seed, dev)
        bsz = int(cfg["datasets"]["train"]["batch_size"])
        step = make_cached_train_step(eng, bsz, n_sub=n)
        for _ in range(max(2, CHAIN_N // n)):      # warm-up (and capture)
            step(state, data, seed)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timed = CHAIN_TIMED[cfg_name]
        t0 = time.time()
        for _ in range(timed // n):
            step(state, data, seed)
        torch.cuda.synchronize()
        rate = timed / (time.time() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        peak_res = (torch.cuda.max_memory_reserved() - base_res) / 2 ** 30
        busy, idle = idle_share(
            lambda: [step(state, data, seed)
                     for _ in range(CHAIN_PROFILED // n)], CHAIN_PROFILED)
        detail[arm] = {"steps_per_s": rate, "peak_gib": peak,
                       "peak_reserved_gib": peak_res, "batch": bsz,
                       "busy_ms_per_step": busy, "idle_share": idle}
        del cfg, eng, state, data, step
    gc.collect()
    torch.cuda.empty_cache()
    u, c = detail["unchained"], detail["chained"]

    def fmt(v, f):
        return "not measured" if v is None else format(v, f)

    def arm_text(d):
        return (f"{d['steps_per_s']:.3f} steps/s, peak {d['peak_gib']:.2f} "
                f"GiB allocated, {d['peak_reserved_gib']:.2f} reserved, "
                f"idle share {fmt(d['idle_share'], '.3f')} (busy "
                f"{fmt(d['busy_ms_per_step'], '.2f')} ms/step)")
    print(f"[chain rate{tag} {cfg_name}] {card} | B={u['batch']}, "
          f"{CHAIN_TIMED[cfg_name]} timed steps an arm: unchained "
          f"{arm_text(u)} | "
          f"chained by {CHAIN_N} (one replay per call) {arm_text(c)} | "
          f"chained / unchained "
          f"{c['steps_per_s'] / u['steps_per_s']:.3f}", flush=True)
    ok = all(math.isfinite(d["steps_per_s"]) for d in (u, c))
    return detail, ok


def chain_cli(cfg_name, card, seed, dist=False):
    """``cli.sr_mfe -p train`` of a config (the device cache on) on a
    seeded npy pack for CHAIN_CLI_STEPS steps, a checkpoint at the last,
    unchained and with FASTDIFFSR_TPU_STEPS_PER_CALL=CHAIN_N, on cuDNN's
    deterministic algorithms: the checkpoints' params and EMA and the
    losses equal bit for bit; steady steps/s and the peak of reserved
    device memory over the run, of both. ``dist`` runs both
    with ``-dist`` (in phase 18's torchrun process). Returns (detail,
    ok)."""
    import torch

    from fastdiffsr_tpu_torch.cli import sr_mfe
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.data import write_pack

    work = os.path.join(ROOT, "build", "smoke", "chain")
    cfg = load_json_config(os.path.join(ROOT, "fastdiffsr_tpu_torch",
                                        "configs", f"{cfg_name}.json"))
    l_res = int(cfg["datasets"]["train"]["l_resolution"])
    r_res = int(cfg["datasets"]["train"]["r_resolution"])
    pack = os.path.join(work, f"pack_{l_res}_{r_res}_{seed}")
    write_pack(pack, CHAIN_TILES, seed + 53, l_res, r_res)
    runs = {}
    for chain in ("1", str(CHAIN_N)):
        c = json.loads(json.dumps(cfg))
        c["name"] = (f"chip_smoke_chain{'_dist' if dist else ''}_{r_res}_"
                     f"{chain}")
        c["path"]["resume_state"] = None
        for ds in c["datasets"].values():
            ds.update(dataroot=pack, datatype="npy")
        c["datasets"]["train"]["device_cache"] = True
        c["train"].update(n_iter=CHAIN_CLI_STEPS, val_freq=10 ** 9,
                          save_checkpoint_freq=CHAIN_CLI_STEPS,
                          print_freq=CHAIN_N)
        path = os.path.join(work, f"{c['name']}.json")
        with open(path, "w") as f:
            json.dump(c, f)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        torch.backends.cudnn.deterministic = True
        try:
            with environ({"FASTDIFFSR_TPU_STEPS_PER_CALL": chain}):
                out = sr_mfe.main(["-p", "train", "-c", path, "--device",
                                   "cuda", "--seed", str(seed)]
                                  + (["-dist"] if dist else []))
        finally:
            torch.backends.cudnn.deterministic = False
        out["peak_reserved_gib"] = (torch.cuda.max_memory_reserved()
                                    - base) / 2 ** 30
        runs[chain] = out
    a, b = (torch.load(os.path.join(runs[k]["checkpoint"], "state.pt"),
                       map_location="cpu", weights_only=True)
            for k in ("1", str(CHAIN_N)))
    same = all(torch.equal(v, b[key][k]) for key in ("params", "ema_params")
               for k, v in a[key].items())
    same_loss = runs["1"]["l_pix"] == runs[str(CHAIN_N)]["l_pix"]
    u, ch = runs["1"], runs[str(CHAIN_N)]
    ok = (same and same_loss and a["step"] == b["step"] == CHAIN_CLI_STEPS
          and os.path.basename(ch["checkpoint"]).startswith(
              f"I{CHAIN_CLI_STEPS}_"))
    print(f"[chain cli{' -dist' if dist else ''} {cfg_name}] {card} | "
          f"cli.sr_mfe -p train{' -dist' if dist else ''} "
          f"(B={cfg['datasets']['train']['batch_size']}, {l_res}->{r_res}, "
          f"device cache) {CHAIN_CLI_STEPS} steps, cuDNN deterministic: "
          f"checkpoint {os.path.basename(ch['checkpoint'])} with "
          f"FASTDIFFSR_TPU_STEPS_PER_CALL={CHAIN_N} equals the unchained one"
          f" bit for bit {same}, losses {same_loss} | steady "
          f"{u['steady_steps_per_s']:.3f} unchained, "
          f"{ch['steady_steps_per_s']:.3f} chained steps/s | peak reserved "
          f"{u['peak_reserved_gib']:.2f} GiB unchained, "
          f"{ch['peak_reserved_gib']:.2f} chained (the run's set-up "
          f"included) {'ok' if ok else 'FAIL'}", flush=True)
    return {"bit_equal": same, "losses_equal": same_loss,
            "steps_per_s_unchained": u["steady_steps_per_s"],
            "steps_per_s_chained": ch["steady_steps_per_s"],
            "peak_reserved_gib_unchained": u["peak_reserved_gib"],
            "peak_reserved_gib_chained": ch["peak_reserved_gib"]}, ok


def chain_worker(seed) -> int:
    """Phase 26's own process (``--chain-worker``): the replay-vs-eager
    parity of each of CHAIN_CONFIGS and their ``cli.sr_mfe`` runs chained
    and unchained, in a process of their own as a training run is: the
    smoke's process holds what 25 phases left in the card's memory and in
    cuDNN's plan cache, where a capture ran out of memory for a plan's
    workspace (PERF.md §6). Prints the phases' lines, then one line
    ``CHAIN_RESULT {detail, nodes, ok}``."""
    sys.path.insert(0, ROOT)
    from fastdiffsr_tpu_torch.device import use_ieee_float32
    from fastdiffsr_tpu_torch.ops import kernels

    use_ieee_float32()
    own_phases_regime()
    kernels.load()
    card = card_line()
    detail, nodes, ok = {}, {}, True
    for cfg_name in CHAIN_CONFIGS:
        d, p_ok = chain_parity(cfg_name, card, seed)
        detail[f"chain_{cfg_name}"] = d
        nodes[f"{cfg_name} n={CHAIN_N}"] = d["kernels_per_replay"][
            "gn_swish_apply_kernel"]
        ok &= p_ok
    for cfg_name in CHAIN_CONFIGS:
        detail[f"chain_cli_{cfg_name}"], c_ok = chain_cli(cfg_name, card,
                                                          seed)
        ok &= c_ok
    print("CHAIN_RESULT " + json.dumps(
        {"detail": detail, "nodes": nodes, "ok": bool(ok)}), flush=True)
    return 0 if ok else 1


def phase_naf_decode(card, seed):
    """Phases 24-25 (module docstring): NAFNet's layout modes, the native
    decoder. Returns (detail, seconds of each, ok)."""
    t0 = time.time()
    detail = {}
    detail["naf"], ok = phase_naf_modes(card, seed)
    laps = {"naf": time.time() - t0}
    detail["decode"], d_ok = phase_decode(card, seed)
    ok &= d_ok
    laps["decode"] = time.time() - t0 - laps["naf"]
    return detail, laps, ok


def start_chain_worker(seed):
    """Start ``chain_worker`` (phase 26's parity and CLI runs) in the
    background; returns (process, log path, start time) for
    ``phase_slice``."""
    import atexit
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    log_path = os.path.join(work, "chain_worker.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--chain-worker", "--seed", str(seed)], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True)
    if not _BACKGROUND:
        atexit.register(_stop_background)
    _BACKGROUND.append(proc)
    return proc, log_path, time.time()


def phase_slice(card, seed, early=None, chain=None):
    """Phases 24-26 (module docstring): NAFNet's layout modes and the
    native decoder (from ``early``, ``phase_naf_decode``'s result, or run
    here), chained train steps (parity and the CLI in ``chain_worker``'s
    process, ``chain`` from ``start_chain_worker`` or started here; the
    rates and profiles here, last). Returns (detail, K1 launches per
    replay by config and chain, ok)."""
    import torch

    t0 = time.time()
    detail, laps, ok = early or phase_naf_decode(card, seed)
    detail, laps = dict(detail), dict(laps)
    if early:
        t0 -= sum(laps.values())        # the phases' own seconds
    gc.collect()
    torch.cuda.empty_cache()
    proc, log_path, t_chain = chain or start_chain_worker(seed)
    try:
        rc = proc.wait(timeout=max(1.0, CHAIN_TIMEOUT
                                   - (time.time() - t_chain)))
        err = ""
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc, err = None, f"the chain worker outlived {CHAIN_TIMEOUT} s"
    with open(log_path) as f:
        out = f.read()
    err = err or out
    lines = out.splitlines()
    for line in lines:
        if line.startswith("[chain"):
            print(line, flush=True)
    result = [json.loads(line[len("CHAIN_RESULT "):]) for line in lines
              if line.startswith("CHAIN_RESULT ")]
    if not result or rc != 0:
        print(f"[chain worker] {card} | exit {rc}: {err[-1500:]} FAIL",
              flush=True)
    res = result[0] if result else {"detail": {}, "nodes": {}, "ok": False}
    detail.update(res["detail"])
    nodes = res["nodes"]
    ok &= bool(res["ok"]) and rc == 0
    laps["parity, cli (worker, the wait)"] = (time.time() - t0
                                              - sum(laps.values()))
    detail["chain_worker_s"] = time.time() - t_chain
    for cfg_name in CHAIN_CONFIGS:
        detail[f"chain_rates_{cfg_name}"], r_ok = chain_rates(cfg_name, card,
                                                              seed)
        ok &= r_ok
    laps["rates"] = time.time() - t0 - sum(laps.values())
    detail["seconds"] = time.time() - t0
    print(f"[slice] {card} | phases 24-26 took {detail['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()) + ") "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return detail, nodes, ok


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
    ap.add_argument("--serving-only", action="store_true",
                    help="in place of phases 2-18: only phases 19-20 (the "
                         "serving export and the DDPM wrapper), one after "
                         "the other")
    ap.add_argument("--demo-only", action="store_true",
                    help="in place of phases 2-20: only phase 21 (the demo "
                         "path: data.prepare, the x8 demo config with its "
                         "SSIM term, the kernels at 64x64)")
    ap.add_argument("--quant-only", action="store_true",
                    help="in place of phases 2-21: only phase 22 (the W8A8 "
                         "path: Q1, serving, infer, training and export "
                         "with FASTDIFFSR_TPU_QUANT)")
    ap.add_argument("--rewrites-only", action="store_true",
                    help="in place of phases 2-22: only phase 23 (the exact "
                         "rewrites: Upsample forms, fold, skip_concat, "
                         "conv_split)")
    ap.add_argument("--slice-only", action="store_true",
                    help="in place of phases 2-23: only phases 24-26 "
                         "(NAFNet's layout modes, the native decoder, "
                         "chained train steps)")
    ap.add_argument("--serving-worker", nargs=3,
                    metavar=("ROLE", "SPEC", "CASE"),
                    help="a worker process of phase 19")
    ap.add_argument("--chain-worker", action="store_true",
                    help="phase 26's process (replay vs eager, the CLI "
                         "chained)")
    ap.add_argument("--side-worker", action="store_true",
                    help="phases 16-17's process (EDiffSR, MSI), which "
                         "runs beside phases 12, 15, 20 and 24-25")
    args = ap.parse_args(argv)
    if args.dist_worker:
        return dist_worker(args.dist_worker)
    if args.chain_worker:
        return chain_worker(args.seed)
    if args.side_worker:
        return side_worker(args.seed)
    if args.serving_worker:
        return serving_worker(*args.serving_worker)

    t_start = time.time()
    # a SIGTERM exits through atexit, which stops the background workers
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
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
    if args.serving_only:
        detail["serving"], _, s_ok = phase_serving(card, args.seed)
        detail["ddpm"], _, _, d_ok = phase_ddpm(card, args.seed)
        with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
            json.dump(detail, f, indent=1, default=str)
        return 0 if s_ok and d_ok else 1
    if args.demo_only:
        detail["demo"], _, demo_ok = phase_demo(card, args.seed)
        with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
            json.dump(detail, f, indent=1, default=str)
        return 0 if demo_ok else 1
    if args.quant_only:
        detail["quant"], _, quant_ok = phase_quant(card, args.seed)
        with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
            json.dump(detail, f, indent=1, default=str)
        return 0 if quant_ok else 1
    if args.rewrites_only:
        detail["rewrites"], _, rw_ok = phase_rewrites(card, args.seed)
        with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
            json.dump(detail, f, indent=1, default=str)
        return 0 if rw_ok else 1
    if args.slice_only:
        detail["slice"], _, sl_ok = phase_slice(card, args.seed)
        with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
            json.dump(detail, f, indent=1, default=str)
        return 0 if sl_ok else 1
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
                  "channel_stats": 4 * n_eval, "gn_swish": 0,
                  "quant_conv3": 0},
        {"wgmma": 49 * n_eval, "cuda_cores": 0})
    # the same in float32, infer's default (K3 on the CUDA cores)
    cfg["name"] = "chip_smoke_infer_f32"
    detail["serve_f32"], serve32_ok = run_infer(
        cfg, cfg["name"], card, ["--seed", str(args.seed)], "serve f32",
        {"fused_gn_swish_conv3x3": 49 * n_eval, "channel_stats": 4 * n_eval,
         "gn_swish": 0, "quant_conv3": 0},
        {"wgmma": 0, "cuda_cores": 49 * n_eval})
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
    ok &= samp_ok and k1v_ok

    # 13. K3/K2 at the 128->512 shapes; 14. the 128->512 path (both
    # alone on the card, before the phases that run beside others)
    detail["k512"], k512_ok = phase_512_kernels(card, args.seed)
    lap("13 K3, K2 at 512")
    detail["infer_512"], i512_ok = phase_512_infer(card, args.seed)
    lap("14 infer 128->512")
    ok &= k512_ok and i512_ok

    # from here to phase 18, two more processes beside the smoke's: phase
    # 19's workers preparing (niced: exports, loads, the in-process
    # references), and phases 16-17 (EDiffSR, MSI)
    gc.collect()
    torch.cuda.empty_cache()
    pool = start_serving(args.seed, serving_cpus())
    side = start_side(args.seed)

    # 12. the ddpm/tesr/gdp variants end to end; 15. cli.fid; phase 18's
    # plain references; 20. the DDPM wrapper; 24. NAFNet's layout modes;
    # 25. the native decoder
    detail["variants"], k1_variant_launches, var_ok = phase_variants(
        card, args.seed, droot)
    lap("12 variants (beside 16-17)")
    detail["fid"], fid_ok = phase_fid(card, args.seed)
    lap("15 fid (beside 16-17)")
    ok &= var_ok and fid_ok
    dist_pre = dist_refs(args.seed, beside="beside phases 16-17")
    lap("18 plain references (beside 16-17)")
    detail["ddpm"], ddpm_k1, ddpm_launches, ddpm_ok = phase_ddpm(card,
                                                                 args.seed)
    lap("20 DDPM wrapper (beside 16-17)")
    naf_decode = phase_naf_decode(card, args.seed)
    lap("24-25 NAFNet modes, decoder (beside 16-17)")
    ok &= ddpm_ok and naf_decode[2]

    # 16. EDiffSR: training, --test with the three samplers, card vs CPU;
    # 17. MSI: the five baselines through msi.main, GAN, card vs CPU
    detail["ediffsr"], detail["msi"], side_s, side_ok = join_side(side, card)
    detail["side_seconds"] = side_s
    lap("16-17 ediffsr, msi (the wait)")
    ok &= side_ok

    # 18. data parallel under torchrun (world size 1, NCCL), alone on the
    # card once phase 19's in-process references are done
    await_early_reference(pool, card)
    gc.collect()
    torch.cuda.empty_cache()
    detail["dist"], dist_launches, dist_ok = phase_dist(card, args.seed,
                                                        dist_pre)
    lap("18 dist")
    ok &= dist_ok

    # 19. the serving export (its workers' turns)
    gc.collect()
    torch.cuda.empty_cache()
    detail["serving"], serve_launches, export_ok = phase_serving(
        card, args.seed, pool)
    lap("19 serving export")
    ok &= export_ok

    # 21. the demo path: data.prepare, the x8 demo config, 64x64 kernels
    gc.collect()
    torch.cuda.empty_cache()
    detail["demo"], demo_launches, demo_ok = phase_demo(card, args.seed)
    lap("21 demo")
    ok &= demo_ok

    # 22. the W8A8 path: Q1, serving, infer, training, export
    gc.collect()
    torch.cuda.empty_cache()
    detail["quant"], _, quant_ok = phase_quant(card, args.seed)
    lap("22 W8A8")
    ok &= quant_ok

    # 23. the exact rewrites: Upsample forms, fold, skip_concat, conv_split
    # (beside phase 26's chain worker)
    gc.collect()
    torch.cuda.empty_cache()
    chain = start_chain_worker(args.seed)
    detail["rewrites"], rewrite_k1_launches, rw_ok = phase_rewrites(
        card, args.seed)
    lap("23 rewrites (beside 26's worker)")
    ok &= rw_ok

    # 26. chained train steps (its profiles last)
    gc.collect()
    torch.cuda.empty_cache()
    detail["slice"], chain_nodes, sl_ok = phase_slice(card, args.seed,
                                                      naf_decode, chain)
    # the train config's chain, under -dist in phase 18's rank
    chain_nodes[f"-dist {DIST_CHAIN_CONFIG} n={CHAIN_N}"] = detail[
        "dist"].get("chain", {}).get("parity", {}).get(
            "kernels_per_replay", {}).get("gn_swish_apply_kernel")
    lap("26 chained steps")
    ok &= sl_ok
    demo = detail["demo"]
    k3_512, k2_512 = detail["k512"]["k3"], detail["k512"]["k2"]
    k1_all_rows = k1_rows + demo["k1"] + detail["rewrites"]["k1"] + [
        r for v in detail["k1_variants"].values() for r in v["rows"]]
    # per SR3 forward (the shapes of phase 6) at batch 1, the batch of
    # the variants' -p val runs
    k1_b1 = detail["k1_variants"]["ddpm"]["total"]["f32_b1"]
    wgmma_launches = detail["serve"]["routes"]["wgmma"] + sum(
        detail["samplers"][s]["routes"]["wgmma"] for s in ("ddim", "dpm")) \
        + detail["infer_512"]["bf16"]["routes"]["wgmma"] \
        + serve_launches.get("wgmma", 0) + ddpm_launches.get("wgmma", 0)
    k2_launches = (detail["serve"]["launches"]["channel_stats"]
                   + detail["serve_f32"]["launches"]["channel_stats"]
                   + detail["train"]["val_launches"]["channel_stats"]
                   + sum(detail["samplers"][s]["launches"]["channel_stats"]
                         for s in ("ddim", "dpm"))
                   + sum(detail["infer_512"][dt]["launches"]["channel_stats"]
                         for dt in ("f32", "bf16"))
                   + dist_launches.get("channel_stats", 0)
                   + serve_launches.get("channel_stats", 0)
                   + ddpm_launches["channel_stats"]
                   + demo_launches["channel_stats"])

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

    def at_64(rows, err="max_abs_err_y"):
        """Per 64x64 eval at batch 1 in f32 (phase 21): the ``*_64`` keys
        of an entry."""
        return {"ms_64": total(rows, "ms", "f32"),
                "plain_ms_64": total(rows, "plain_ms", "f32"),
                "bound_ms_64": total(rows, "bound_ms", "f32"),
                "library_ms_64": (total(rows, "library_ms", "f32")
                                  if rows[0]["library_ms"] is not None
                                  else None),
                "max_abs_err_64": max(r[err] for r in rows)}

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
         + dist_launches.get("gn_swish", 0) + ddpm_k1
         + serve_launches.get("gn_swish", 0) + demo_launches["gn_swish"]
         + rewrite_k1_launches,
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
         "floor_ms": detail["floor_ms"],
         # K1's launches per CUDA-graph replay of a chained train step
         # (gn_swish kernels in a profile of one replay), by config and
         # chain
         "chained_launches_per_replay": chain_nodes,
         # per training forward of the demo configs' 64x64 UNet, B=16
         **{f"{k}_64": v for k, v in demo["k1_total"].items()}},
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
         + dist_launches.get("cuda_cores", 0)
         + serve_launches.get("cuda_cores", 0)
         + ddpm_launches.get("cuda_cores", 0)
         + demo_launches["cuda_cores"],
         "kernel_route": k3_route_of("f32"),
         "max_abs_err": max(r["max_abs_err_y"] for r in k3_rows + demo["k3"]
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
         **at_512(k3_512, "f32"), **at_64(demo["k3"])},
        {"name": "channel_stats", "route": "cuda",
         "source": "fastdiffsr_tpu_torch/csrc/channel_stats.cu",
         "replaces": "fastdiffsr_tpu/ops/groupnorm.py:143",
         "launches": k2_launches,
         "max_abs_err": max(r["max_abs_err"] for r in k2_rows + demo["k2"]
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
            at_512(k2_512, "f32", "max_abs_err").items()},
         **at_64(demo["k2"], "max_abs_err")},
        q1_entry(detail["quant"]),
    ]
    detail["kernels"] = kern
    detail["seconds"] = time.time() - t_start
    detail["phase_seconds"] = laps
    print(f"[phase seconds] {card} | " + ", ".join(
        f"{k} {v:.1f}" for k, v in laps.items()), flush=True)
    print(f"[time] {card} | the run took {detail['seconds']:.1f} s, of which "
          f"{build_s:.1f} s built the kernels", flush=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
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
