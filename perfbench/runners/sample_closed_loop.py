"""The ``sample_closed_loop`` runner: one client upscales batches of tiles
through the program's serving path, sending the next batch when the last
one's images have reached the host.

Per batch, as ``cli/infer.py::main`` does: ``train.pad_batch_with_keys``
(the conditioning uploaded, one generator per image from its global
index), then ``sample_fn(cond, gens).cpu()`` with ``sample_fn`` =
``train.make_sample_fn(engine, cli.infer.make_denoiser(net, fused,
dtype), **cli.infer.sampler_options(config))`` on the engine and net of
``cli.infer.build_all``. The tiles' decoding and the PNG writing of the
CLI are not part of the cell.

``peak_mem_gib`` is the allocator's peak over the window alone (set-up's
is reported apart).

Mix parameters (``traffic/<mix>.json``): ``batch``, ``dtype`` (bf16 or
f32), ``fused``, ``pool_tiles`` (distinct tiles, drawn per batch from the
seed), ``warmup_batches``, ``trace_batches``, ``check_images``.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from perfbench.harness import inputs
from perfbench.harness.check import sr_gap
from perfbench.harness.outcome import Outcome
from perfbench.harness.trace import Spans, traced_window
from perfbench.reference import diffusion as rd
from perfbench.reference import unets

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
CHECK = 14


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> Outcome:
    from fastdiffsr_tpu_torch.cli import infer as cli_infer
    from fastdiffsr_tpu_torch.device import (set_cudnn_autotuning,
                                             use_ieee_float32)
    from fastdiffsr_tpu_torch.train import make_sample_fn, pad_batch_with_keys

    tr, opt = cell.traffic, cell.config
    model = opt["model"]
    use_ieee_float32()
    set_cudnn_autotuning(False)
    t_load = time.perf_counter()
    if device.type == "cuda":
        from fastdiffsr_tpu_torch.ops import kernels
        kernels.load()
    t_load = time.perf_counter() - t_load
    dtype = DTYPES[tr["dtype"]]
    eng, net = cli_infer.build_all(opt, device=device, dtype=dtype, seed=seed)
    net.load_state_dict(inputs.make_weights(model, seed, device),
                        strict=True)
    fused = cli_infer.resolve_fused(model["which_model_G"], tr["fused"])
    sample_fn = make_sample_fn(
        eng, cli_infer.make_denoiser(net, fused, dtype),
        **cli_infer.sampler_options(opt))
    size = int(model["diffusion"]["image_size"])
    bsz = int(tr["batch"])
    _, sr_pool = inputs.make_tiles(seed, int(tr["pool_tiles"]), size,
                                   int(opt["scale"]), device)
    pool = sr_pool.cpu().numpy()
    del sr_pool
    order = inputs.order(seed, int(tr["max_batches"]), bsz, len(pool))
    done = []               # (first image index, SR on the host)
    latencies = []
    span = Spans()

    def batch(k: int, keep: bool):
        first = k * bsz
        t_sent = time.perf_counter()
        with span("batch_draw"):
            cond, gens = pad_batch_with_keys(pool[order[k % len(order)]],
                                             bsz, seed, first, device=device)
        with span("sample_fn"):
            out = sample_fn(cond, gens)
        with span("sync"):
            out = out.cpu()
        if keep:
            latencies.extend([time.perf_counter() - t_sent] * bsz)
            done.append((first, out))

    warm = int(tr["warmup_batches"])
    for k in range(warm):
        batch(k, False)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start
    setup_peak = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    k = warm
    summary = pace_s = None
    if traced:
        # the same number of batches untraced first: the pace that the
        # device's busy time is set against
        n_traced = int(tr["trace_batches"])
        t0 = time.perf_counter()
        for _ in range(n_traced):
            batch(k, True)
            k += 1
        pace_s = time.perf_counter() - t0
        with traced_window(span, sync) as w:
            for _ in range(n_traced):
                batch(k, True)
                k += 1
        summary = w.summary()
        window_s = summary.window_s + pace_s
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            batch(k, True)
            k += 1
        window_s = time.perf_counter() - t0
        n_traced = 0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    images = len(done) * bsz
    failed = sum(int((~torch.isfinite(o.flatten(1))).any(1).sum())
                 for _, o in done)

    del sample_fn, net, eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gap = check(cell, seed, device, pool, order, done, bsz)
    return Outcome(
        e2e={"sr_img_per_s": images / window_s,
             "sr_latency_p95_s": float(np.percentile(latencies, 95)),
             "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
        units={"sr_img_per_s": "img/s", "sr_latency_p95_s": "s",
               "peak_mem_gib": "GiB", "setup_s": "s"},
        attempted=images, failed=failed, checks={"sr_gap": gap},
        peak_bytes=peak, setup_peak_bytes=setup_peak,
        setup_parts={"kernel_load_s": t_load}, summary=summary,
        work={"kind": "sample", "batch": bsz, "dtype": tr["dtype"],
              "evals": n_traced * int(
                  model["beta_schedule"]["val"]["n_timestep"]),
              "pace_s": pace_s,
              "model": model, "size": size})


def check(cell, seed, device, pool, order, done, bsz) -> float:
    """sr_gap of the images the seed picks among those ``done`` holds,
    against the float32 reference, in blocks of 16 images."""
    model = cell.config["model"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n_batches = max(1, math.ceil(int(cell.traffic["check_images"]) / bsz))
    rng = np.random.default_rng(inputs.derived_seed(seed, CHECK))
    picks = sorted(rng.choice(len(done), min(n_batches, len(done)),
                              replace=False))
    net = unets.build_unet(model, "f32", device)
    net.load_state_dict(inputs.make_weights(model, seed, device))
    tab = rd.tables(model["beta_schedule"]["val"], device)
    conditioning, residual = rd.VARIANTS[model["which_model_G"]]
    rows = []
    for i in picks:
        first, out = done[i]
        k = first // bsz
        cond = torch.from_numpy(pool[order[k % len(order)]])
        for j in range(bsz):
            rows.append((first + j, cond[j], out[j]))
    worst = 0.0
    for at in range(0, len(rows), 16):
        block = rows[at:at + 16]
        cond = torch.stack([c for _, c, _ in block]).to(device)
        gens = [torch.Generator(device=device).manual_seed(
            rd.image_seed(seed, n)) for n, _, _ in block]
        ref = rd.sample_ancestral(net, tab, cond, gens, conditioning,
                                  residual)
        prog = torch.stack([o for _, _, o in block]).to(device)
        worst = max(worst, sr_gap(prog.float(), ref, cond))
    return worst
