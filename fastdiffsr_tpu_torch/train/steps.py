"""Train and sample steps: counterpart of ``fastdiffsr_tpu/train/steps.py``.

:func:`make_train_step` runs one optimizer step: the forward with
dropout, the training loss, the backward, the update and the EMA. It
updates the :class:`~.state.TrainState` in place (JAX returns a new
state). :func:`make_cached_train_step` draws its batch from a uint8 set
that lives on the device, as the JAX package's device-resident mode does.
A step's random draws come from one ``torch.Generator`` seeded from (run
seed, step) by :func:`step_generator`, the counterpart of
``fold_in(rng, step)`` there, so a resumed run draws what an unbroken
one would. The cached step takes JAX's ``n_sub``: one call runs that
many steps, sub-step i drawing from ``step_generator(seed, state.step +
i)``. On the CPU they are a loop of unchained steps; on CUDA the n steps
are captured once into a ``torch.cuda.CUDAGraph`` and every later call
is one replay of it (:class:`_CapturedSteps`), which leaves no host gap
between the kernels (the FastDiffSR step at 256x256, batch 4, leaves the
device idle for 0.143 of its time when it is launched from Python).
Under a process group the captured steps run the bare net and average
its gradients themselves (``parallel.average_gradients``), as DDP does.

Under a ``torch.distributed`` group of W ranks a rank's batch is its
``parallel.rank_rows`` block of the global batch. Every rank draws the
global batch's noise and noise level (cached: also its indices and
flips) from the step's generator and keeps its rows, as JAX draws one
global key, so the step equals the single-process step; DDP averages
the gradients over the ranks before the update and the EMA, and the
logged ``l_pix`` is the mean over the ranks. Dropout is the exception:
with W > 1 a rank draws its masks at its own rows from a generator of
(step, rank), so such a step is not the 1-rank step (JAX draws one
global mask). With ``FASTDIFFSR_TPU_QUANT=w8a8`` the dynamic int8
activation scale of each quantized conv is the maximum over the ranks,
with its gradient summed over them (``ops.quant.shared_activation_scale``),
as over JAX's global batch.

:func:`pad_batch_with_keys` is the shared val/infer batching contract: a
tail batch is padded to the full batch size and every image gets its own
``torch.Generator`` seeded from its GLOBAL index, so an image's output
does not depend on how the image set is cut into batches.
:func:`make_sample_fn` wraps one of the three samplers (ancestral, DDIM,
DPM-Solver++) around a denoiser.
"""

from __future__ import annotations

import gc
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..diffusion.engine import DiffusionEngine
from ..ops.quant import shared_activation_scale
from ..parallel import (all_reduce_mean, average_gradients, rank,
                        rank_rows, world_size)
from .state import TrainState


def _step_seed(seed: int, step: int) -> int:
    return int(np.random.SeedSequence([int(seed), 1, int(step)])
               .generate_state(1, np.uint64)[0])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step ``step`` of a run seeded with ``seed``
    (a stream apart from the per-image sampling generators)."""
    return torch.Generator(device=device).manual_seed(_step_seed(seed, step))


def _rank_seed(seed: int, r: int) -> int:
    return int(np.random.SeedSequence([int(seed), 3, int(r)])
               .generate_state(1, np.uint64)[0])


def rank_generator(generator: torch.Generator, r: int) -> torch.Generator:
    """A stream of rank ``r``'s own, derived from ``generator``'s seed."""
    return torch.Generator(device=generator.device).manual_seed(
        _rank_seed(generator.initial_seed(), r))


def replay_seeds(seed: int, step: int, n: int, r: int, world: int) -> list:
    """The seeds of the generators of ``n`` chained steps from ``step``
    (:class:`_CapturedSteps`), per sub-step s: (the seed of
    ``step_generator(seed, s)``, the seed of ``rank_generator`` of it for
    rank ``r``, None in a world of 1, whose step draws its dropout from
    the step's generator)."""
    return [(_step_seed(seed, s),
             _rank_seed(_step_seed(seed, s), r) if world > 1 else None)
            for s in range(step, step + n)]


def _ema_decay(ema_decay: float, ema_start: int, step: int) -> float:
    """The EMA decay of train step ``step``: 0 before ``ema_start``."""
    return ema_decay if step >= ema_start else 0.0


def _step_body(engine: DiffusionEngine, state: TrainState, batch, generator,
               decay: torch.Tensor, noise=None, gamma=None, t=None,
               net_gen=None) -> dict:
    """One optimizer step on ``state`` (without advancing ``state.step``):
    the loss, the backward, the update and the EMA with ``decay``, a 0-d
    float32 tensor on the net's device (so that a captured step reads the
    decay of the step it replays). The dropout masks come from
    ``net_gen``, else (in a world of 1) ``generator``, else
    ``rank_generator(generator, rank)``. The forward runs
    ``state.train_net``: DDP averages the gradients of a wrapped net; a
    bare one's are averaged by :func:`parallel.average_gradients` (a
    no-op without a process group; what a CUDA graph can hold)."""
    net = state.net
    net.train()
    world = world_size()
    if noise is None and gamma is None and t is None:
        x = batch["HR"]
        rows = rank_rows(x.shape[0] * world, rank(), world)
        draws = engine.training_draws(
            generator, (x.shape[0] * world, *x.shape[1:]), x.device)
        noise, gamma, t = (draws[k][rows] if k in draws else None
                           for k in ("noise", "gamma", "t"))
    if net_gen is None:
        net_gen = (generator if world == 1 or generator is None
                   else rank_generator(generator, rank()))
    def denoise(x_in, level):
        return state.train_net(x_in, level, generator=net_gen)

    with shared_activation_scale(dist.group.WORLD if world > 1 else None):
        loss = engine.training_loss(denoise, batch, generator,
                                    noise=noise, gamma=gamma, t=t)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    named = list(net.named_parameters())
    if state.train_net is net:
        average_gradients([p for _, p in named])
    grads = [p.grad for _, p in named if p.grad is not None]
    grad_norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    state.optimizer.step()
    with torch.no_grad():
        ema = [state.ema_params[k] for k, _ in named]
        params = [p.detach() for _, p in named]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - decay))
    return {"l_pix": all_reduce_mean(loss.detach()), "grad_norm": grad_norm}


def make_train_step(engine: DiffusionEngine, ema_decay: float = 0.9999,
                    ema_start: int = 5000):
    """Returns train_step(state, batch, generator, *, noise=, gamma=, t=)
    -> (state, metrics).

    ``batch`` is {'HR', 'SR'} (B,H,W,C) in [-1, 1] on the net's device;
    ``generator`` draws the noise, the noise level and then the dropout
    masks (the keyword arguments inject the first two, as
    ``DiffusionEngine.training_loss`` takes them). ``metrics`` holds the
    loss ``l_pix`` and ``grad_norm``, the global L2 norm of the gradients
    before the update, as 0-d tensors on the device. The EMA is
    ``decay*ema + (1-decay)*p`` of the updated parameters, with decay 0
    before ``ema_start`` (counted before this step) so the EMA copies the
    parameters until then; ``update_ema_every`` is not read, as in JAX.
    """

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator], *, noise=None,
                   gamma=None, t=None):
        decay = torch.full((), _ema_decay(ema_decay, ema_start,
                                          state.step),
                           dtype=torch.float32, device=batch["HR"].device)
        metrics = _step_body(engine, state, batch, generator, decay,
                             noise, gamma, t)
        state.step += 1
        return state, metrics

    return train_step


def _assemble(data: Dict[str, torch.Tensor], batch_size: int,
              gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The cached step's batch: ``batch_size`` indices drawn with
    replacement, ``u8 / 127.5 - 1``, each pair flipped horizontally with
    probability 1/2; this rank's rows."""
    n = data["HR"].shape[0]
    dev = data["HR"].device
    idx = torch.randint(0, n, (batch_size,), generator=gen, device=dev)
    flip = torch.rand((batch_size,), generator=gen, device=dev) < 0.5
    rows = rank_rows(batch_size, rank(), world_size())
    idx, sel = idx[rows], flip[rows, None, None, None]
    out = {}
    for k, v in data.items():
        x = v[idx].float() / 127.5 - 1.0
        out[k] = torch.where(sel, x.flip(2), x)
    return out


def _run_steps(engine, batch_size, state, data, gens, decays,
               net_gens=None) -> dict:
    """One cached step per (generator, decay[, dropout generator]), the
    metrics stacked."""
    out = [_step_body(engine, state, _assemble(data, batch_size, g), g, d,
                      net_gen=ng)
           for g, d, ng in zip(gens, decays, net_gens or [None] * len(gens))]
    return {k: torch.stack([m[k] for m in out]) for k in out[0]}


def _eager_steps(engine, batch_size, state, data, seed, n, ema_decay,
                 ema_start) -> dict:
    """``n`` unchained cached steps, step i drawing from
    ``step_generator(seed, state.step + i)``; advances ``state.step``."""
    dev = data["HR"].device
    steps = range(state.step, state.step + n)
    out = _run_steps(
        engine, batch_size, state, data,
        [step_generator(seed, s, dev) for s in steps],
        [torch.full((), _ema_decay(ema_decay, ema_start, s),
                    dtype=torch.float32, device=dev) for s in steps])
    state.step += n
    return out


class _CapturedSteps:
    """``n`` cached train steps captured once into one CUDA graph.

    The captured region is :meth:`run_eagerly`'s: n steps of the bare
    ``state.net`` whose gradients :func:`parallel.average_gradients`
    averages over the ranks (one all-reduce of a flat buffer on
    ``dist.group.WORLD``, each gradient scaled by 1/W as DDP's reducer
    scales it; nothing without a process group). Under ``-dist`` DDP's
    wrapper is dropped from the state: its reducer keeps host state
    between iterations (bucket rebuilds, ``prepare_for_backward``) that
    a replay would not re-run, and AccumulateGrad nodes made on another
    stream. A sub-step draws from its step's generator and, in
    a world of W > 1, its dropout masks from a generator of its own:
    each seeded as :func:`replay_seeds` says, to what
    ``step_generator(seed, s)`` and ``rank_generator`` of it hold, so
    the region computes what n unchained steps compute.

    The first call runs the n steps eagerly, on a side stream (PyTorch's
    warm-up before a capture: cuDNN's algorithm choice, the optimizer's
    state, the kernel library and the process group's communicator are
    made there, not inside the graph), then empties the allocator's
    cache and captures them with cuDNN's autotuning off: a convolution
    takes the plan its shape was given in the warm-up, and a shape cuDNN
    has no plan for gets its heuristics' pick, never the timing runs of
    every candidate (which the graph would replay each call). The cache
    is emptied because the allocator cannot release cached blocks during
    a capture: a plan's workspace that does not fit in what is left
    raises out of memory inside PyTorch's convolution, which then takes
    (and keeps) another plan without a word, and the graph computes
    other bits than the eager steps. Where that still happens (the
    card's memory is held elsewhere) the allocator's count of such
    errors rises over the capture, and a RuntimeWarning says so. Every
    later call re-seeds the generators registered with the graph
    (``register_generator_state``), writes the n EMA decays into a
    device buffer and replays the graph. The graph holds the addresses
    of the state's tensors and of ``data``: a call with another state or
    data raises. After a replay every parameter's version counter is
    advanced, as an in-place update would, so that a cache keyed on it
    (``ops.quant``'s packed weights) repacks.
    """

    def __init__(self, engine, batch_size, n, ema_decay, ema_start):
        self.engine, self.batch_size, self.n = engine, batch_size, n
        self.ema_decay, self.ema_start = ema_decay, ema_start
        self.graph = None
        self.key = None
        self.out = None
        self.gens = None

    def _key(self, state, data):
        return (id(state.net), id(state.optimizer),
                tuple((k, v.data_ptr()) for k, v in sorted(data.items())))

    def _generators(self, dev):
        """(n step generators, n dropout generators (None in a world of
        1), the n EMA decays' device buffer)."""
        world = world_size()
        return ([torch.Generator(device=dev) for _ in range(self.n)],
                [torch.Generator(device=dev) if world > 1 else None
                 for _ in range(self.n)],
                torch.zeros(self.n, dtype=torch.float32, device=dev))

    def _seed(self, gens, state, seed):
        """Seed ``gens`` (:meth:`_generators`) for the n steps from
        ``state.step``."""
        steps, dropout, decays = gens
        plan = replay_seeds(seed, state.step, self.n, rank(), world_size())
        for g, d, (s_seed, r_seed) in zip(steps, dropout, plan):
            g.manual_seed(s_seed)
            if d is not None:
                d.manual_seed(r_seed)
        decays.copy_(torch.tensor(
            [_ema_decay(self.ema_decay, self.ema_start, state.step + i)
             for i in range(self.n)], dtype=torch.float32))

    def _steps(self, state, data, gens):
        steps, dropout, decays = gens
        return _run_steps(self.engine, self.batch_size, state, data, steps,
                          list(decays.unbind(0)), dropout)

    def run_eagerly(self, state, data, seed):
        """The captured region's n steps from ``state.step``, run eagerly
        on generators seeded as a replay's are (the first call's warm-up;
        on CPU tensors, what a replay computes); advances ``state.step``
        and returns the stacked metrics. A DDP wrapper in
        ``state.train_net`` is dropped first, for good: its reducer keeps
        each parameter's AccumulateGrad node alive, made on the stream of
        the wrap, and a capture on its own stream cannot depend on that
        one; the bare net's steps average their gradients themselves."""
        if state.train_net is not state.net:
            state.train_net = state.net
            gc.collect()
        gens = self._generators(data["HR"].device)
        self._seed(gens, state, seed)
        out = self._steps(state, data, gens)
        state.step += self.n
        return out

    def __call__(self, state, data, seed):
        dev = data["HR"].device
        if dev.type != "cuda":
            raise ValueError("a captured train step needs CUDA tensors, got "
                             f"{dev}")
        if self.graph is None:
            return self._warm_up_and_capture(state, data, seed)
        if self._key(state, data) != self.key:
            raise ValueError("a captured train step replays on the state "
                             "and data it was captured with")
        self._seed(self.gens, state, seed)
        self.graph.replay()
        with torch.no_grad():
            for p in state.net.parameters():
                torch.autograd.graph.increment_version(p)
        state.step += self.n
        return state, {k: v.clone() for k, v in self.out.items()}

    def _warm_up_and_capture(self, state, data, seed):
        dev = data["HR"].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            metrics = self.run_eagerly(state, data, seed)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.gens = self._generators(dev)
        graph = torch.cuda.CUDAGraph()
        for g in self.gens[0] + self.gens[1]:
            if g is not None:
                graph.register_generator_state(g)
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        ooms = torch.cuda.memory_stats(dev).get("num_ooms", 0)
        timed = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False
        # under a process group, NCCL's watchdog thread polls its work's
        # events, which a capture in the global mode forbids every thread
        mode = "thread_local" if dist.is_initialized() else "global"
        try:
            with torch.cuda.graph(graph, capture_error_mode=mode):
                self.out = self._steps(state, data, self.gens)
        finally:
            torch.backends.cudnn.benchmark = timed
        ooms = torch.cuda.memory_stats(dev).get("num_ooms", 0) - ooms
        if ooms:
            warnings.warn(
                f"{ooms} out-of-memory error(s) inside the CUDA-graph capture "
                f"of {self.n} train steps: cuDNN replaced a convolution plan "
                "whose workspace did not fit, so the replays compute other "
                "bits than unchained steps (free device memory, or set "
                "steps_per_call 1)", RuntimeWarning, stacklevel=3)
        self.graph, self.key = graph, self._key(state, data)
        return state, metrics


def make_cached_train_step(engine: DiffusionEngine, batch_size: int,
                           ema_decay: float = 0.9999, ema_start: int = 5000,
                           n_sub: int = 1):
    """Device-resident-dataset train step: returns
    train_step(state, data, seed) -> (state, metrics).

    ``data`` is {'HR': (N,r,r,3), 'SR': (N,r,r,3)} uint8 tensors on the
    net's device, passed unchanged every call. Each step draws
    ``batch_size`` (the global batch) indices WITH replacement, maps them
    to [-1, 1] as ``u8 / 127.5 - 1`` and flips each pair horizontally
    with probability 1/2, from ``step_generator(seed, state.step)``,
    keeps this rank's rows, and then runs :func:`make_train_step`'s body
    with the same generator.

    ``n_sub`` steps run per call (JAX's chained steps), sub-step i from
    ``step_generator(seed, state.step + i)``, and the metrics come back
    stacked with leading dimension ``n_sub`` when it is above 1. With
    ``n_sub > 1`` and ``data`` on CUDA the n steps are one CUDA-graph
    replay per call after the first call (:class:`_CapturedSteps`; under
    a process group too, averaging the gradients itself in place of
    DDP); otherwise they are a loop of unchained steps."""
    if n_sub < 1:
        raise ValueError(f"n_sub={n_sub} (want >= 1)")
    captured = _CapturedSteps(engine, batch_size, n_sub, ema_decay,
                              ema_start)

    def train_step(state: TrainState, data: Dict[str, torch.Tensor],
                   seed: int):
        if n_sub > 1 and data["HR"].device.type == "cuda":
            state, metrics = captured(state, data, seed)
        else:
            metrics = _eager_steps(engine, batch_size, state, data, seed,
                                   n_sub, ema_decay, ema_start)
        if n_sub == 1:
            metrics = {k: v[0] for k, v in metrics.items()}
        return state, metrics

    return train_step


def image_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of image ``index`` of a run seeded with ``seed``.
    The (seed, index) pair is hashed into the generator's seed: the CPU
    generator keeps only the low 32 bits of its seed."""
    state = np.random.SeedSequence([int(seed), 0, int(index)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def pass_seed(seed: int, k: int) -> int:
    """The image-generator seed of sampling pass ``k`` of a run seeded
    with ``seed``: ``seed`` itself for pass 0, a derived one for the
    extra passes of ``n_samples`` averaging (a stream apart from the
    train steps')."""
    if k == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), 2, int(k)])
               .generate_state(1, np.uint32)[0])


def pad_batch_with_keys(cond, full_b: int, seed: int, start_index: int,
                        device="cuda"):
    """Pad ``cond`` (B,H,W,C) to ``full_b`` rows by repeating its first row
    and return (cond on ``device``, one generator per row). Rows past the
    original batch are padding whose outputs the caller drops."""
    from ..device import resolve_device
    dev = resolve_device(device)
    cond = np.asarray(cond, dtype=np.float32)
    if cond.shape[0] < full_b:
        cond = np.concatenate(
            [cond, np.repeat(cond[:1], full_b - cond.shape[0], axis=0)],
            axis=0)
    gens = [image_generator(seed, start_index + i, dev)
            for i in range(cond.shape[0])]
    return torch.from_numpy(cond).to(dev), gens


def make_sample_fn(engine: DiffusionEngine,
                   denoise_fn: Callable[[torch.Tensor, torch.Tensor],
                                        torch.Tensor],
                   sampler: str = "ancestral",
                   ddim_steps: Optional[int] = None,
                   ddim_eta: float = 0.0,
                   return_trajectory: bool = False):
    """Returns sample(cond, generators, *, init_noise=None, noise_seq=None)
    -> SR batch (B,H,W,C), or (SR batch, (T,B,H,W,C) trajectory) with
    ``return_trajectory`` (ancestral only, as in JAX).

    ``cond`` is the bicubic-upsampled LR batch in [-1, 1]; ``generators``
    holds one generator per image. ``sampler='ddim'`` runs DDIM with
    ``ddim_steps`` UNet evals (T when None; deterministic when
    ``ddim_eta == 0``), ``sampler='dpm'`` DPM-Solver++(2M) with the same
    step count, ``'ancestral'`` the T-step reverse process.
    ``init_noise`` and ``noise_seq`` replace the generators' draws, as
    the engine's samplers take them (``serving.py`` passes them).
    """
    if sampler not in ("ancestral", "ddim", "dpm"):
        raise ValueError(
            f"sampler={sampler!r} (want 'ancestral', 'ddim' or 'dpm')")
    if sampler != "ancestral" and return_trajectory:
        raise ValueError("trajectory output is ancestral-only")

    def sample(cond, generators=None, *, init_noise=None, noise_seq=None):
        kw = {k: v for k, v in (("init_noise", init_noise),
                                ("noise_seq", noise_seq)) if v is not None}
        if sampler == "dpm":
            return engine.sample_dpm(denoise_fn, cond, generators,
                                     steps=ddim_steps, **kw)
        if sampler == "ddim":
            return engine.sample_ddim(denoise_fn, cond, generators,
                                      steps=ddim_steps, eta=ddim_eta, **kw)
        if return_trajectory:
            kw["return_trajectory"] = True
        return engine.sample(denoise_fn, cond, generators, **kw)

    return sample
