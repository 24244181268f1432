"""Train and sample steps: counterpart of ``fastdiffsr_tpu/train/steps.py``.

:func:`make_train_step` runs one optimizer step: the forward with
dropout, the training loss, the backward, the update and the EMA. It
updates the :class:`~.state.TrainState` in place (JAX returns a new
state). :func:`make_cached_train_step` draws its batch from a uint8 set
that lives on the device, as the JAX package's device-resident mode does.
A step's random draws come from one ``torch.Generator`` seeded from (run
seed, step) by :func:`step_generator`, the counterpart of
``fold_in(rng, step)`` there, so a resumed run draws what an unbroken
one would. The JAX package's ``n_sub`` (several steps in one dispatch)
has no counterpart: a call per step costs nothing extra here.

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

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..diffusion.engine import DiffusionEngine
from ..ops.quant import shared_activation_scale
from ..parallel import all_reduce_mean, rank, rank_rows, world_size
from .state import TrainState


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step ``step`` of a run seeded with ``seed``
    (a stream apart from the per-image sampling generators)."""
    state = np.random.SeedSequence([int(seed), 1, int(step)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def rank_generator(generator: torch.Generator, r: int) -> torch.Generator:
    """A stream of rank ``r``'s own, derived from ``generator``'s seed."""
    state = np.random.SeedSequence(
        [int(generator.initial_seed()), 3, int(r)]).generate_state(
            1, np.uint64)[0]
    return torch.Generator(device=generator.device).manual_seed(int(state))


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
        net_gen = (generator if world == 1 or generator is None
                   else rank_generator(generator, rank()))
        def denoise(x_in, level):
            return state.train_net(x_in, level, generator=net_gen)

        with shared_activation_scale(dist.group.WORLD if world > 1
                                     else None):
            loss = engine.training_loss(denoise, batch, generator,
                                        noise=noise, gamma=gamma, t=t)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        named = list(net.named_parameters())
        grads = [p.grad for _, p in named if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        state.optimizer.step()
        decay = ema_decay if state.step >= ema_start else 0.0
        with torch.no_grad():
            ema = [state.ema_params[k] for k, _ in named]
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, [p.detach() for _, p in named],
                                alpha=1.0 - decay)
        state.step += 1
        return state, {"l_pix": all_reduce_mean(loss.detach()),
                       "grad_norm": grad_norm}

    return train_step


def make_cached_train_step(engine: DiffusionEngine, batch_size: int,
                           ema_decay: float = 0.9999, ema_start: int = 5000):
    """Device-resident-dataset train step: returns
    train_step(state, data, seed) -> (state, metrics).

    ``data`` is {'HR': (N,r,r,3), 'SR': (N,r,r,3)} uint8 tensors on the
    net's device, passed unchanged every call. Each step draws
    ``batch_size`` (the global batch) indices WITH replacement, maps them
    to [-1, 1] as ``u8 / 127.5 - 1`` and flips each pair horizontally
    with probability 1/2, from ``step_generator(seed, state.step)``,
    keeps this rank's rows, and then runs :func:`make_train_step`'s body
    with the same generator."""
    body = make_train_step(engine, ema_decay, ema_start)

    def assemble(data, gen):
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

    def train_step(state: TrainState, data: Dict[str, torch.Tensor],
                   seed: int):
        gen = step_generator(seed, state.step, data["HR"].device)
        return body(state, assemble(data, gen), gen)

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
