"""The ``train_steps`` runner: the program's train step, one call after
another, as ``cli/sr_mfe.py -p train`` runs it without a device cache.

Set-up builds one ``TrainState`` (the net of ``cli.sr_mfe.build_all``
with the benchmark's weights, ``train.make_optimizer``'s Adam) and
``train.make_train_step(engine, ema_decay=, ema_start=)``, and drives it
through its first ``warmup_steps`` steps with the window's own call and
feed: step s takes ``step_generator(seed, s)`` and B distinct tiles of a
pool made on the device from the seed (indices drawn from the seed). The
steps are numbered from the configuration's ``step_start_ema``, as in a
run resumed there, so that the EMA blends (decay 0.9999) in every
checked and timed step. The first three are read for the check; the
window then goes on with the same object. cuDNN times its algorithms, as
the CLI has it. ``peak_mem_gib`` is the allocator's peak over the window
alone (set-up's, cuDNN's algorithm timing included, is reported apart).

Mix parameters: ``batch``, ``pool_tiles``, ``max_steps`` (the length of
the drawn index table; steps past it wrap), ``warmup_steps``,
``trace_steps``.
"""

from __future__ import annotations

import gc
import time

import torch

from perfbench.harness import inputs
from perfbench.harness.check import train_gaps
from perfbench.harness.outcome import Outcome
from perfbench.harness.trace import Spans, traced_window
from perfbench.reference import diffusion as rd
from perfbench.reference import unets

CHECKED_STEPS = 3


def leaf_norms(named) -> dict:
    return {n: float(v) for n, v in named}


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> Outcome:
    from fastdiffsr_tpu_torch.cli import sr_mfe
    from fastdiffsr_tpu_torch.device import (set_cudnn_autotuning,
                                             use_ieee_float32)
    from fastdiffsr_tpu_torch.train import (create_train_state,
                                            make_optimizer, make_train_step,
                                            step_generator)

    tr, opt = cell.traffic, cell.config
    model = opt["model"]
    use_ieee_float32()
    set_cudnn_autotuning(True)
    t_load = time.perf_counter()
    if device.type == "cuda":
        from fastdiffsr_tpu_torch.ops import kernels
        kernels.load()
    t_load = time.perf_counter() - t_load
    eng_train, _, net = sr_mfe.build_all(opt, device, seed)
    w0 = inputs.make_weights(model, seed, device)
    net.load_state_dict(w0, strict=True)
    state = create_train_state(
        net, make_optimizer(net.parameters(), opt["train"]["optimizer"]))
    ema_cfg = opt["train"]["ema_scheduler"]
    ema = dict(ema_decay=float(ema_cfg["ema_decay"]),
               ema_start=int(ema_cfg["step_start_ema"]))
    step_fn = make_train_step(eng_train, **ema)
    # number the steps from the EMA's start, as a resumed run past it
    first = first_step(opt["train"])
    state.step = first
    size = int(model["diffusion"]["image_size"])
    bsz = int(tr["batch"])
    hr, sr = inputs.make_tiles(seed, int(tr["pool_tiles"]), size,
                               int(opt["scale"]), device)
    order = torch.from_numpy(inputs.order(seed, int(tr["max_steps"]), bsz,
                                          hr.shape[0])).to(device)
    losses = []
    span = Spans()

    def step(s: int):
        nonlocal state
        with span("batch_draw"):
            idx = order[(s - first) % order.shape[0]]
            batch = {"HR": hr[idx], "SR": sr[idx]}
            gen = step_generator(seed, s, device)
        with span("train_step"):
            state, metrics = step_fn(state, batch, gen)
        losses.append(metrics["l_pix"])

    named = list(state.net.named_parameters())
    prog = {}
    for i in range(int(tr["warmup_steps"])):
        step(first + i)
        if i == 0:
            # Adam's first moment after one step is (1 - b1) * gradient;
            # a leaf it holds none of has had no gradient
            prog["grad1"] = leaf_norms(
                (n, state.optimizer.state[p]["exp_avg"].norm()
                 / (1.0 - rd.ADAM_B1)
                 if "exp_avg" in state.optimizer.state[p] else 0.0)
                for n, p in named)
        if i == CHECKED_STEPS - 1:
            prog["losses"] = [float(v) for v in losses]
            prog["change"] = leaf_norms(
                (n, (p.detach() - w0[n]).norm()) for n, p in named)
            prog["ema_change"] = leaf_norms(
                (n, (state.ema_params[n] - w0[n]).norm()) for n, _ in named)
            del w0
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start
    setup_peak = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    s = start = first + int(tr["warmup_steps"])
    losses.clear()
    summary = pace_s = None
    if traced:
        # the same number of steps untraced first: the pace that the
        # device's busy time is set against
        n_traced = int(tr["trace_steps"])
        t0 = time.perf_counter()
        for _ in range(n_traced):
            step(s)
            s += 1
        sync()
        pace_s = time.perf_counter() - t0
        with traced_window(span, sync) as w:
            for _ in range(n_traced):
                step(s)
                s += 1
        summary = w.summary()
        window_s = summary.window_s + pace_s
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            step(s)
            s += 1
        sync()
        window_s = time.perf_counter() - t0
        n_traced = 0
    steps = s - start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) * bsz

    del state, step_fn, net, named, eng_train
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(model, opt["train"], seed, device, hr, sr,
                             order, bsz)
    return Outcome(
        e2e={"train_img_per_s": steps * bsz / window_s,
             "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
        attempted=steps * bsz, failed=failed,
        units={"train_img_per_s": "img/s", "peak_mem_gib": "GiB",
               "setup_s": "s"},
        checks=train_gaps(prog, ref), peak_bytes=peak,
        setup_peak_bytes=setup_peak, setup_parts={"kernel_load_s": t_load},
        summary=summary,
        work={"kind": "train", "batch": bsz, "dtype": "f32", "steps": n_traced,
              "pace_s": pace_s,
              "model": model, "size": size})


def first_step(train_opt: dict) -> int:
    """The number of a run's first step: the EMA's start, so that every
    checked and timed step blends the EMA, as more than 99 % of a
    training run's steps do."""
    return int(train_opt["ema_scheduler"]["step_start_ema"])


def reference_readings(model, train_opt, seed, device, hr, sr, order, bsz,
                       precision: str = "f32", rows=None,
                       ema_decay=None) -> dict:
    """The reference's first three steps from the same weights, tiles and
    draws: each step's loss, the first gradient's leaf norms, each leaf's
    change and its EMA's. ``rows`` keeps only those rows of each batch
    (a fault: part of the batch left out, the mean over the rest);
    ``ema_decay`` replaces the configuration's (a fault)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = unets.build_unet(model, precision, device).train()
    w0 = inputs.make_weights(model, seed, device)
    net.load_state_dict(w0)
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]
    ema = [p.detach().clone() for p in params]
    adam = rd.Adam(params, train_opt["optimizer"]["lr"])
    tab = rd.tables(model["beta_schedule"]["train"], device)
    ema_cfg = train_opt["ema_scheduler"]
    decay = float(ema_cfg["ema_decay"] if ema_decay is None else ema_decay)
    first = first_step(train_opt)
    out = {"losses": []}
    for s in range(first, first + CHECKED_STEPS):
        idx = order[(s - first) % order.shape[0]]
        if rows is not None:
            idx = idx[rows]
        gen = torch.Generator(device=device).manual_seed(rd.step_seed(seed,
                                                                      s))
        loss = rd.training_loss(net, tab, hr[idx], sr[idx], gen,
                                model["which_model_G"])
        grads = torch.autograd.grad(loss, params)
        out["losses"].append(float(loss.detach()))
        if s == first:
            out["grad1"] = {n: float(g.norm()) for n, g in zip(names, grads)}
        adam.step(list(grads))
        rd.ema_update(ema, [p.detach() for p in params],
                      rd.ema_decay(decay, int(ema_cfg["step_start_ema"]),
                                   s))
    with torch.no_grad():
        out["change"] = {n: float((p - w0[n]).norm())
                         for n, p in zip(names, params)}
        out["ema_change"] = {n: float((e - w0[n]).norm())
                             for n, e in zip(names, ema)}
    return out

