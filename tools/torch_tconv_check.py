#!/usr/bin/env python3
"""The Upsample forms of the FastDiffSR UNet in ``chip_smoke.py``'s phase-10
sampler check, on one GPU: how far the plain f32 forward in each form
carries DDIM and DPM-Solver++ away from the fused f32 forward, and whether
a second run repeats the first bit for bit.

    python3 tools/torch_tconv_check.py [--seeds 3] [--json OUT]

Forms: the literal Upsample, 'tconv' as the port runs it
(``ops.tconv.upsample_tconv``: cuDNN's deterministic algorithms, picked by
its heuristics), 'tconv_timed' (``F.conv_transpose2d`` under the process's
cuDNN settings, the form before ``upsample_tconv``) and 'd2s2'. Each runs
in two cuDNN regimes, one process each: 'timed' (``cudnn.benchmark`` on,
as chip_smoke's own phases run) and 'heuristics' (off). For each input
seed, form and sampler: max|plain - fused| at the end of phase 10's
10-step chain (B=2, 256x256, the net of sr_fastdiffsr_test_64_256.json
from seed 0), the same for the first eval alone, and the max difference
of a second run of the same chain. Then the device ms (CUDA graph) of the
Upsample forms at phase 23's shapes in f32 and bf16. Ends with one JSON
line; writes it to ``--json`` too.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMS = ("literal", "tconv", "tconv_timed", "d2s2")


def timed_tconv(x, w, b):
    """The transposed conv as before ``upsample_tconv``: cuDNN under the
    process's settings."""
    import torch
    import torch.nn.functional as F
    y = F.conv_transpose2d(x, w, b, stride=2, padding=1)
    return y.contiguous(memory_format=torch.channels_last)


def timed_det_tconv(x, w, b):
    """The transposed conv on cuDNN's deterministic algorithms, the
    fastest of them by cuDNN's timing."""
    import torch
    import torch.nn.functional as F
    cudnn = torch.backends.cudnn
    prev = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = True, True
    try:
        y = F.conv_transpose2d(x, w, b, stride=2, padding=1)
    finally:
        cudnn.benchmark, cudnn.deterministic = prev
    return y.contiguous(memory_format=torch.channels_last)


def use_form(form):
    """Set the builders' variable for ``form`` and the module's transposed
    conv (the operator, or the one under the process's settings)."""
    from fastdiffsr_tpu_torch.models import unet_fastdiffsr as m
    from fastdiffsr_tpu_torch.ops.tconv import upsample_tconv
    os.environ["FASTDIFFSR_TPU_UPSAMPLE"] = {
        "literal": "dense", "tconv": "tconv", "tconv_timed": "tconv",
        "tconv_timed_det": "tconv", "d2s2": "d2s2"}[form]
    m.upsample_tconv = {"tconv_timed": timed_tconv,
                        "tconv_timed_det": timed_det_tconv}.get(
                            form, upsample_tconv)


def regime(name, seeds):
    """One regime's rows, in this process."""
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.diffusion import (DiffusionEngine,
                                                DiffusionSpec,
                                                ScheduleBuffers)
    from fastdiffsr_tpu_torch.device import (set_cudnn_autotuning,
                                             use_ieee_float32)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import (
        apply_upsample2_conv3, unet_from_config)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr_fused import (
        fused_apply, prepare_fused_params)
    from fastdiffsr_tpu_torch.ops import kernels

    use_ieee_float32()
    set_cudnn_autotuning(name == "timed")
    kernels.load()
    dev = torch.device("cuda")
    cfg = load_json_config(os.path.join(
        REPO, "fastdiffsr_tpu_torch", "configs",
        "sr_fastdiffsr_test_64_256.json"))
    nets = {}
    for form in FORMS:
        use_form(form)
        nets[form] = unet_from_config(cfg["model"]["unet"], device=dev,
                                      seed=0)
    fp = prepare_fused_params(nets["literal"], torch.float32)
    eng = DiffusionEngine(DiffusionSpec.for_variant("fastdiffsr"),
                          ScheduleBuffers.create(
                              cfg["model"]["beta_schedule"]["val"],
                              device=dev))
    shape = (cs.B_SAMPLER, 256, 256, 3)
    rows = []
    for seed in range(seeds):
        g = torch.Generator(device=dev).manual_seed(11 + seed)
        cond = torch.rand(shape, generator=g, device=dev) * 2 - 1
        init = torch.randn(shape, generator=g, device=dev)
        for sampler in ("ddim", "dpm"):
            fn = getattr(eng, f"sample_{sampler}")
            first = {}

            def fused(x, lv):
                first.setdefault("x", (x.clone(), lv.clone()))
                return fused_apply(fp, x, lv)

            got = fn(fused, cond, steps=cs.SAMPLER_STEPS, init_noise=init)
            x0, lv0 = first["x"]
            eps_fused = fused_apply(fp, x0, lv0)
            for form in FORMS:
                use_form(form)
                net = nets[form]
                with cs.reference_norm():
                    runs = [fn(lambda x, lv: net(x, lv), cond,
                               steps=cs.SAMPLER_STEPS, init_noise=init)
                            for _ in range(2)]
                    eps = net(x0, lv0)
                torch.cuda.synchronize()
                rows.append({
                    "regime": name, "seed": seed, "sampler": sampler,
                    "form": form,
                    "end_vs_fused": (runs[0] - got).abs().max().item(),
                    "first_eval_vs_fused":
                        (eps - eps_fused).abs().max().item(),
                    "second_run_max_diff":
                        (runs[1] - runs[0]).abs().max().item(),
                    "second_run_equal": bool(torch.equal(runs[0], runs[1]))})
                r = rows[-1]
                print(f"[tconv check] {name} seed {seed} {sampler} {form}: "
                      f"end vs fused {r['end_vs_fused']:.3g}, first eval "
                      f"{r['first_eval_vs_fused']:.3g}, second run "
                      f"{r['second_run_max_diff']:.3g}", flush=True)
    times = []
    g = torch.Generator(device=dev).manual_seed(23)
    for B, C, H in cs.UPS_SHAPES:
        w = torch.randn((C, C, 3, 3), generator=g, device=dev) / (9 * C) ** .5
        b = torch.randn(C, generator=g, device=dev) * 0.1
        xf = torch.randn((B, C, H, H), generator=g, device=dev).contiguous(
            memory_format=torch.channels_last)
        for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = xf.to(dt)
            row = {"regime": name, "B": B, "C": C, "H": H, "dtype": dt_name}
            for form in FORMS:
                use_form(form)
                mode = {"literal": "", "d2s2": "d2s2"}.get(form, "tconv")
                row[form] = cs.device_ms(
                    lambda: apply_upsample2_conv3(x, w, b, mode, dt),
                    cs.REPS)
            times.append(row)
            print(f"[tconv ms] {name} {dt_name} B={B} C={C} {H}x{H}: "
                  + " ".join(f"{f} {row[f]:.4f}" for f in FORMS), flush=True)
    return {"rows": rows, "times": times}


TIME_FORMS = ("literal", "tconv", "tconv_timed", "tconv_timed_det", "d2s2")


def timing(seed):
    """In this process (cuDNN timed, as chip_smoke's own phases): the
    device ms of each form in TIME_FORMS at phase 23's Upsample shapes,
    with a digest of each tconv form's output bits, and the ms of one
    f32 forward+backward of the full-width FastDiffSR UNet at B=4 (the
    train config's batch) in each form."""
    import hashlib

    import torch
    import chip_smoke as cs
    from fastdiffsr_tpu_torch.config import load_json_config
    from fastdiffsr_tpu_torch.device import (set_cudnn_autotuning,
                                             use_ieee_float32)
    from fastdiffsr_tpu_torch.models.unet_fastdiffsr import (
        apply_upsample2_conv3, unet_from_config)
    from fastdiffsr_tpu_torch.ops import kernels

    use_ieee_float32()
    set_cudnn_autotuning(True)
    kernels.load()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23 + seed)
    times = []
    shapes = list(cs.UPS_SHAPES) + [(4, 256, 32), (4, 256, 64),
                                    (4, 128, 128)]
    for B, C, H in shapes:
        w = torch.randn((C, C, 3, 3), generator=g, device=dev) / (9 * C) ** .5
        b = torch.randn(C, generator=g, device=dev) * 0.1
        xf = torch.randn((B, C, H, H), generator=g, device=dev).contiguous(
            memory_format=torch.channels_last)
        for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = xf.to(dt)
            row = {"B": B, "C": C, "H": H, "dtype": dt_name, "digest": {}}
            for form in TIME_FORMS:
                use_form(form)
                mode = {"literal": "", "d2s2": "d2s2"}.get(form, "tconv")
                row[form] = cs.device_ms(
                    lambda: apply_upsample2_conv3(x, w, b, mode, dt),
                    cs.REPS)
                y = apply_upsample2_conv3(x, w, b, mode, dt)
                row["digest"][form] = hashlib.sha1(
                    y.float().cpu().numpy().tobytes()).hexdigest()[:12]
            times.append(row)
            print(f"[tconv ms] {dt_name} B={B} C={C} {H}x{H}: "
                  + " ".join(f"{f} {row[f]:.4f}" for f in TIME_FORMS),
                  flush=True)
    cfg = load_json_config(os.path.join(
        REPO, "fastdiffsr_tpu_torch", "configs",
        "sr_fastdiffsr_test_64_256.json"))
    x = torch.randn((4, 256, 256, 6), generator=g, device=dev)
    lv = torch.rand((4,), generator=g, device=dev)
    train = {}
    for form in TIME_FORMS:
        use_form(form)
        net = unet_from_config(cfg["model"]["unet"], device=dev, seed=0)
        net.train()

        gen = torch.Generator(device=dev).manual_seed(1)

        def step():
            net.zero_grad(set_to_none=True)
            net(x, lv, generator=gen).abs().mean().backward()

        train[form] = cs.time_ms(step, 5)
        print(f"[tconv train] f32 B=4 forward+backward {form}: "
              f"{train[form]:.3f} ms", flush=True)
        del net
    return {"times": times, "train_ms": train}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--json", default=None)
    ap.add_argument("--times", action="store_true",
                    help="only the timing (two processes, their tconv "
                         "output digests compared)")
    ap.add_argument("--regime", choices=("timed", "heuristics", "times"),
                    help="run one regime in this process (the parent "
                         "starts one process per regime)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    if args.regime == "times":
        print(json.dumps(timing(0)))
        return 0
    if args.regime:
        print(json.dumps(regime(args.regime, args.seeds)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_tconv_check: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from fastdiffsr_tpu_torch.ops import kernels
    kernels.build()
    out = {"card": cs.card_line(), "torch": torch.__version__}
    runs = (("times", "times"), ("times_again", "times")) if args.times \
        else (("timed", "timed"), ("heuristics", "heuristics"))
    for key, name in runs:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--regime", name, "--seeds", str(args.seeds)],
                           stdout=subprocess.PIPE, text=True, check=True)
        lines = p.stdout.strip().splitlines()
        print("\n".join(lines[:-1]), flush=True)
        out[key] = json.loads(lines[-1])
    if args.times:
        for r0, r1 in zip(out["times"]["times"], out["times_again"]["times"]):
            same = {f: r0["digest"][f] == r1["digest"][f] for f in TIME_FORMS}
            print(f"[tconv bits] {r0['dtype']} B={r0['B']} C={r0['C']} "
                  f"{r0['H']}x{r0['H']}: output bits equal in two processes: "
                  + " ".join(f"{f} {v}" for f, v in same.items()), flush=True)
    line = json.dumps(out)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(f"card: {out['card']}")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
