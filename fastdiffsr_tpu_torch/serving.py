"""Serving export: the whole T-step sampler as one ``torch.export`` artifact.

Counterpart of ``fastdiffsr_tpu/serving.py`` (which serialises the jitted
sampler with ``jax.export``). The complete reverse-diffusion program of
``train.make_sample_fn`` -- every UNet eval, the schedule constants and
the residual fold-back -- is traced by ``torch.export.export`` into one
``ExportedProgram`` and saved with ``torch.export.save``. The net comes
from the config as the CLIs build it (``cli.infer.build_all``), with the
forward ``cli.infer.resolve_fused`` picks: the fused forward (kernels K3
and K2) for FastDiffSR, the plain UNet forward (K1 under every GroupNorm
-> Swish) for ddpm, tesr and gdp. The kernels enter the graph as the
registered operators of ``ops/library.py``.

- Weights are call arguments (a dict of tensors, the net's state-dict
  keys, swapped in with ``torch.func.functional_call``), so one artifact
  serves every checkpoint of an architecture. The fused forward's casts
  and permutes (``prepare_fused_params``) run once per call, before the
  loop.
- The batch dimension is symbolic by default (``torch.export.Dim``, min
  1); ``--batch N`` makes it static, and any other batch is rejected.
- A ``torch.Generator`` cannot enter a graph, so the unrolled artifact
  takes the noise as inputs, the engine's own overrides: ``init_noise``
  (B,H,W,C) and, where the sampler draws per step (ancestral; DDIM with
  eta > 0), ``noise_seq`` (T,B,H,W,C; by timestep for the ancestral
  sampler, by step for DDIM). :func:`load_exported` returns a callable
  ``(params, cond, generators)`` that draws them from the per-image
  generators of ``train.pad_batch_with_keys`` in the in-process
  sampler's order, so both give the same image.
- ``--platforms`` names the devices the artifact is saved for (``cuda``
  by default; ``cpu``). The first is traced on its device and written to
  ``-o``; each further one is a copy made by
  ``torch.export.passes.move_to_device_pass``, written beside it as
  ``<name>.<platform><ext>``. On CPU tensors the operators run the
  kernels' plain versions.
- Two forms of the loop. Up to ``MAX_EXPORT_STEPS`` UNet evals the loop
  is unrolled, and the export's time and the artifact's size grow with
  the evals. Above it (ddpm's T=1000 ancestral sampler, as the shipped
  ``sr_ddpm_*`` configs run it) the sampler is one
  ``torch._higher_order_ops.scan`` over its stacked per-step constants
  (``DiffusionEngine.sample_scan``): the graph holds one UNet eval
  whatever T, and the scan carries only the map. That form draws its
  noise inside, as JAX's artifact draws it from ``keys``: it takes
  ``seeds`` (B,) int64 in place of the noise, and
  ``diffusion.counter_normal`` hashes (seed, draw, element) into normal
  draws, so the noise costs O(B*H*W*C) per step, not a (T,B,H,W,C)
  input. :func:`load_exported`'s callable draws one seed per image from
  the image's generator; ``diffusion.counter_noise`` materialises the
  same draws for the in-process sampler
  (:meth:`ExportedSampler.sampler_noise`). ``build_sample_export(
  loop=True)`` forces the scan form at any T. (torch 2.11's scan runs
  its body once more than T a call; the result is the same.)

A process that loads an artifact needs torch and the port's op registry
(``import fastdiffsr_tpu_torch.ops``), and not the model code: without
the registry ``torch.export.load`` cannot resolve ``torch.ops.fdsr.*``.
(JAX's artifact needs only jax.)

CLI::

    python -m fastdiffsr_tpu_torch.serving -c <config.json> -o sampler.pt2 \\
        [--ckpt experiments/.../I4000_E1] [--use_ema] [--batch N] \\
        [--sampler ancestral|ddim|dpm] [--steps N] [--eta F] \\
        [--platforms cuda,cpu] [--dtype f32|bf16] [--selftest]

Loading in a serving process::

    from fastdiffsr_tpu_torch.serving import load_exported
    sr = load_exported(path)(params, cond, generators)
    # or, with torch and the op registry only:
    import fastdiffsr_tpu_torch.ops
    ep = torch.export.load(path)
    sr = ep.module()(params, cond, init_noise[, noise_seq])   # unrolled
    sr = ep.module()(params, cond, seeds)                      # scan
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

import torch

from . import ops  # noqa: F401  (registers the fdsr:: operators)

__all__ = ["build_sample_export", "export_sampler", "load_exported",
           "main", "draw_noise", "draw_seeds", "ExportedSampler",
           "MAX_EXPORT_STEPS"]

META_FILE = "fdsr_sampler.json"
PLATFORMS = ("cuda", "cpu")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# UNet evals an export unrolls; above them it traces the scan form (see
# the module docstring; PERF.md records the export seconds and artifact
# size of both forms on the H100)
MAX_EXPORT_STEPS = 100
SELFTEST_ATOL = 1e-5      # the JAX package's round-trip bound


def _plan(engine, sampler: str, steps: Optional[int], eta: float):
    """(UNet evals, per-step draws after the initial one, whether
    noise_seq is indexed by timestep) of a sampler."""
    T = engine.buffers.num_timesteps
    if sampler == "ancestral":
        return T, T, True
    evals = len(engine._subsequence(steps)[0])
    return evals, (evals if sampler == "ddim" and eta != 0.0 else 0), False


def draw_noise(generators: Sequence[torch.Generator], shape,
               step_draws: int, by_timestep: bool, device):
    """The noise the in-process sampler draws from one generator per
    image: (init_noise (B,*shape), noise_seq (step_draws,B,*shape) or
    None). Image i draws its initial noise and then one map per step from
    its own generator, in loop order; an ancestral ``noise_seq`` is
    indexed by timestep, so the loop's k-th draw lands at T-1-k."""
    device = torch.device(device)
    init, seq = [], []
    for g in generators:
        init.append(torch.randn(tuple(shape), generator=g, device=device))
        seq.append([torch.randn(tuple(shape), generator=g, device=device)
                    for _ in range(step_draws)])
    init = torch.stack(init)
    if not step_draws:
        return init, None
    steps = [torch.stack([s[k] for s in seq]) for k in range(step_draws)]
    if by_timestep:
        steps.reverse()
    return init, torch.stack(steps)


def draw_seeds(generators: Sequence[torch.Generator], device):
    """The scan form's noise input: one int64 seed per image, drawn from
    the image's own generator."""
    return torch.stack([torch.randint(0, 2 ** 62, (), generator=g,
                                      device=g.device)
                        for g in generators]).to(device)


class _Sampler(torch.nn.Module):
    """``make_sample_fn``'s sampler around ``net``'s denoiser, as a module
    whose tensors ``_Program`` swaps for the call's: unrolled (the noise
    as inputs) or, with ``loop``, the engine's scan form (``seeds``)."""

    def __init__(self, engine, net, fused: bool, dtype, sampler: str,
                 steps: Optional[int], eta: float, loop: bool):
        super().__init__()
        self.net = net
        self.engine = engine
        self.fused, self.dtype, self.loop = fused, dtype, loop
        self.sampler, self.steps, self.eta = sampler, steps, eta

    def forward(self, cond, *noise):
        from .cli.infer import make_denoiser
        from .train import make_sample_fn
        # the fused forward's parameter layouts, once per call
        denoise = make_denoiser(self.net, self.fused, self.dtype)
        if self.loop:
            return self.engine.sample_scan(denoise, cond, noise[0],
                                           self.sampler, self.steps,
                                           self.eta)
        sample = make_sample_fn(self.engine, denoise, sampler=self.sampler,
                                ddim_steps=self.steps, ddim_eta=self.eta)
        return sample(cond, init_noise=noise[0],
                      noise_seq=noise[1] if len(noise) > 1 else None)


class _Program(torch.nn.Module):
    """forward(params, cond, *noise): the sampler with ``params`` in place
    of the net's tensors. The sampler is held in a list, so the net's own
    tensors stay out of the artifact."""

    def __init__(self, sampler: _Sampler):
        super().__init__()
        self._sampler = [sampler]

    def forward(self, params, cond, *noise):
        swapped = {f"net.{k}": v for k, v in params.items()}
        return torch.func.functional_call(self._sampler[0], swapped,
                                          (cond, *noise))


def build_sample_export(engine, net, image_size: int, in_channels: int = 3,
                        batch: Optional[int] = None,
                        sampler: str = "ancestral",
                        steps: Optional[int] = None, eta: float = 0.0,
                        fused: bool = False, dtype=torch.float32,
                        loop: Optional[bool] = None):
    """Trace ``sample(params, cond, init_noise[, noise_seq])`` (unrolled)
    or ``sample(params, cond, seeds)`` (the scan form) into an
    ``ExportedProgram`` on ``net``'s device.

    ``cond`` is the bicubic-upsampled LR batch (B, image_size,
    image_size, in_channels) in [-1, 1]; ``params`` a dict of the net's
    state-dict tensors. ``batch=None`` exports a symbolic batch
    dimension. ``fused`` runs the fused forward in ``dtype`` (else the
    net's plain forward). ``loop`` picks the form: None the scan form
    above ``MAX_EXPORT_STEPS`` UNet evals, True the scan form, False the
    unrolled one. Returns (program, metadata dict)."""
    from .train import make_sample_fn
    make_sample_fn(engine, None, sampler=sampler)      # rejects a sampler
    evals, step_draws, by_t = _plan(engine, sampler, steps, eta)
    scan_form = evals > MAX_EXPORT_STEPS if loop is None else bool(loop)
    device = next(net.parameters()).device
    params = {k: v.detach() for k, v in net.state_dict().items()}
    program = _Program(_Sampler(engine, net, fused, dtype, sampler, steps,
                                eta, scan_form)).eval()
    b = 2 if batch is None else int(batch)
    shape = (image_size, image_size, in_channels)
    dyn_b = None if batch is not None else torch.export.Dim("b", min=1)
    if scan_form:
        noise = [torch.zeros((b,), dtype=torch.int64, device=device)]
    else:
        noise = [torch.zeros((b, *shape), device=device)]
        if step_draws:
            noise.append(torch.zeros((step_draws, b, *shape), device=device))
    args = (params, torch.zeros((b, *shape), device=device), *noise)
    # the batch is dimension 0 of cond and of every noise input but
    # noise_seq's (T,B,H,W,C)
    dynamic = ({k: None for k in params}, {0: dyn_b},
               tuple({int(v.dim() == 5): dyn_b} for v in noise))
    if scan_form:
        # the scan's body is traced by dynamo, whose cache would hold an
        # earlier export's entries: one traced at a static batch guards a
        # symbolic batch here (b != 3) and breaks its range
        torch._dynamo.reset()
    with torch.no_grad():
        ep = torch.export.export(
            program, args,
            dynamic_shapes=dynamic if batch is None else None, strict=False)
    # the example inputs would be saved with the program: the weights and
    # the noise traced with (on the H100, 133 of a 64->256 artifact's MB)
    ep.example_inputs = None
    if scan_form:
        # each node of the scan's body carries the whole tracing stack
        # (~40 kB of text): ~80 of a full-width ddpm artifact's ~87 MB
        for gm in ep.graph_module.modules():
            if isinstance(gm, torch.fx.GraphModule):
                for node in gm.graph.nodes:
                    node.meta.pop("stack_trace", None)
    meta = {"sampler": sampler, "steps": steps, "eta": float(eta),
            "evals": evals, "step_draws": step_draws, "by_timestep": by_t,
            "loop": "scan" if scan_form else "unrolled",
            "noise": "counter" if scan_form else "inputs",
            "image_size": int(image_size), "in_channels": int(in_channels),
            "batch": None if batch is None else int(batch),
            "fused": bool(fused), "dtype": str(dtype).replace("torch.", ""),
            "platform": device.type, "params": list(params)}
    return ep, meta


def check_platform(platform: str) -> None:
    if platform not in PLATFORMS:
        raise ValueError(f"platform {platform!r}: the port serves "
                         f"{', '.join(PLATFORMS)}")


def for_platform(ep, meta: dict, platform: str):
    """The program (and metadata) for ``platform``: as traced, or a copy
    moved by ``move_to_device_pass``."""
    check_platform(platform)
    if platform == meta["platform"]:
        return ep, meta
    from torch.export.passes import move_to_device_pass
    return move_to_device_pass(ep, platform), dict(meta, platform=platform)


def artifact_paths(out_path: str, platforms: Sequence[str]) -> list:
    """``out_path`` for the first platform, ``<root>.<platform><ext>``
    beside it for each further one."""
    root, ext = os.path.splitext(out_path)
    return [out_path] + [f"{root}.{p}{ext}" for p in platforms[1:]]


def save_exported(ep, meta: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(ep, path, extra_files={META_FILE: json.dumps(meta)})


def export_sampler(opt, out_path: str, ckpt_prefix: Optional[str] = None,
                   use_ema: bool = False, batch: Optional[int] = None,
                   sampler: Optional[str] = None, steps: Optional[int] = None,
                   eta: Optional[float] = None,
                   platforms: Optional[Sequence[str]] = None,
                   dtype=torch.float32, seed: int = 0,
                   loop: Optional[bool] = None):
    """Build the config's sampler as the val/infer CLIs do (seeded
    parameters, or the checkpoint's under ``ckpt_prefix``), export it on
    the first platform's device and save one artifact per platform
    (:func:`artifact_paths`); ``loop`` as :func:`build_sample_export`
    takes it. Returns (program of the first platform, its
    metadata, the params dict the selftest calls it with, the net, the
    val engine)."""
    from .cli.infer import build_all, load_params, resolve_fused

    platforms = list(platforms or ["cuda"])
    for p in platforms:
        check_platform(p)
    eng_val, net = build_all(opt, device=platforms[0], seed=seed)
    variant = opt["model"]["which_model_G"]
    if ckpt_prefix:
        load_params(net, ckpt_prefix, use_ema, variant=variant)
    diff_opt = (opt.get("model") or {}).get("diffusion") or {}
    sampler = sampler or diff_opt.get("sampler") or "ancestral"
    if steps is None and diff_opt.get("ddim_steps"):
        steps = int(diff_opt["ddim_steps"])
    if eta is None:
        eta = float(diff_opt.get("ddim_eta") or 0.0)
    r = int(opt["datasets"]["val"]["r_resolution"])
    ep, meta = build_sample_export(
        eng_val, net, image_size=r, batch=batch, sampler=sampler,
        steps=steps, eta=eta, fused=resolve_fused(variant, None),
        dtype=dtype, loop=loop)
    for p, path in zip(platforms, artifact_paths(out_path, platforms)):
        save_exported(*for_platform(ep, meta, p), path)
    params = {k: v.detach() for k, v in net.state_dict().items()}
    return ep, meta, params, net, eng_val


class ExportedSampler:
    """A loaded artifact. ``sampler(params, cond, generators)`` draws the
    artifact's noise inputs from one generator per image (:meth:`noise`)
    and runs the program; ``sampler.call(params, cond, *noise)`` takes
    them as given: ``init_noise[, noise_seq]`` (unrolled) or ``seeds``
    (the scan form)."""

    def __init__(self, program, meta: dict):
        self.program = program
        self.meta = meta
        self._module = program.module()

    @property
    def counter(self) -> bool:
        """Whether the program draws its noise from ``seeds``."""
        return self.meta.get("noise") == "counter"

    def noise(self, cond: torch.Tensor, generators):
        """The program's noise inputs: (init_noise, noise_seq or None) as
        the in-process sampler draws them (:func:`draw_noise`), or
        (seeds,) (:func:`draw_seeds`)."""
        if len(generators) != cond.shape[0]:
            raise ValueError(f"need {cond.shape[0]} generators, one per "
                             "image")
        if self.counter:
            return (draw_seeds(generators, cond.device),)
        return draw_noise(generators, cond.shape[1:], self.meta["step_draws"],
                          self.meta["by_timestep"], cond.device)

    def sampler_noise(self, cond: torch.Tensor, generators):
        """(init_noise, noise_seq or None) that make the in-process
        sampler compute what the program computes for these generators
        (the scan form's draws through ``diffusion.counter_noise``)."""
        noise = self.noise(cond, generators)
        if not self.counter:
            return noise
        from .diffusion import counter_noise
        return counter_noise(noise[0], self.meta["step_draws"],
                             tuple(cond.shape[1:]), self.meta["by_timestep"])

    def call(self, params, cond, *noise):
        args = ({k: params[k] for k in self.meta["params"]}, cond,
                *(v for v in noise if v is not None))
        with torch.no_grad():
            return self._module(*args)

    def __call__(self, params, cond, generators):
        return self.call(params, cond, *self.noise(cond, generators))


def load_exported(path: str) -> ExportedSampler:
    """Load an artifact of :func:`export_sampler` (this module has
    imported the op registry it needs)."""
    extra = {META_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    return ExportedSampler(program, json.loads(extra[META_FILE]))


def main(argv=None) -> dict:
    """The CLI; returns {'paths', 'mb', 'export_s', 'peak_gib' (device
    memory of the export on CUDA, else None), 'meta', 'selftest_err'
    (None without --selftest)}."""
    import argparse

    import numpy as np

    from .config import parse

    p = argparse.ArgumentParser(
        description="Export the T-step sampler as a torch.export serving "
                    "artifact")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint (directory or UNet state-dict file) "
                        "whose params the --selftest uses; the artifact "
                        "itself is weights-independent")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--batch", type=int, default=None,
                   help="static batch (default: symbolic, any batch)")
    p.add_argument("--sampler", default=None,
                   choices=["ancestral", "ddim", "dpm"])
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--eta", type=float, default=None)
    p.add_argument("--platforms", default="cuda",
                   help="comma list of cuda, cpu (default cuda); the "
                        "first is traced on its device")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="f32",
                   help="the fused forward's type (f32, or the bf16 "
                        "serving mode)")
    p.add_argument("--selftest", action="store_true",
                   help="reload the artifact and check it against the "
                        "in-process sampler on random inputs")
    args = p.parse_args(argv)

    from .device import use_ieee_float32
    use_ieee_float32()
    opt = parse(args.config, phase="val")
    platforms = args.platforms.split(",")
    on_cuda = platforms[0] == "cuda" and torch.cuda.is_available()
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ep, meta, params, net, eng = export_sampler(
        opt, args.out, ckpt_prefix=args.ckpt, use_ema=args.use_ema,
        batch=args.batch, sampler=args.sampler, steps=args.steps,
        eta=args.eta, platforms=platforms, dtype=DTYPES[args.dtype])
    res = {"paths": artifact_paths(args.out, platforms),
           "export_s": time.time() - t0, "meta": meta, "selftest_err": None,
           "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                        if on_cuda else None)}
    res["mb"] = [os.path.getsize(p) / 1e6 for p in res["paths"]]
    for plat, path, mb in zip(platforms, res["paths"], res["mb"]):
        print(f"exported {meta['sampler']} ({meta['evals']} evals, "
              f"{meta['loop']} loop, noise from {meta['noise']}, "
              f"{'fused ' + meta['dtype'] if meta['fused'] else 'plain'} "
              f"forward) -> {path} ({mb:.2f} MB, platform {plat}, batch "
              f"{meta['batch'] or 'symbolic'}); export and save took "
              f"{res['export_s']:.1f} s")

    if args.selftest:
        from .cli.infer import make_denoiser
        from .train import make_sample_fn, pad_batch_with_keys

        b = args.batch or 2
        r = meta["image_size"]
        device = platforms[0]
        rng = np.random.default_rng(0)
        cond = rng.uniform(-1, 1, (b, r, r, 3)).astype(np.float32)
        cond_t, gens = pad_batch_with_keys(cond, b, 0, 0, device=device)
        loaded = load_exported(args.out)
        out = loaded(params, cond_t, gens)
        # the in-process sampler on what the artifact drew from fresh
        # generators of the same seeds
        init, seq = loaded.sampler_noise(
            cond_t, pad_batch_with_keys(cond, b, 0, 0, device=device)[1])
        want = make_sample_fn(
            eng, make_denoiser(net, meta["fused"], DTYPES[args.dtype]),
            sampler=meta["sampler"], ddim_steps=meta["steps"],
            ddim_eta=meta["eta"])(cond_t, init_noise=init, noise_seq=seq)
        err = (out - want).abs().max().item()
        ok = (tuple(out.shape) == cond.shape
              and bool(torch.isfinite(out).all()) and err <= SELFTEST_ATOL)
        print(f"selftest {'ok' if ok else 'FAILED'}: batch {b} -> "
              f"{tuple(out.shape)}, range [{out.min().item():.3f}, "
              f"{out.max().item():.3f}], max|d| against the in-process "
              f"sampler {err:.3g} (tol {SELFTEST_ATOL})")
        res["selftest_err"] = err
        if not ok:
            raise SystemExit(1)
    return res


if __name__ == "__main__":
    main()
