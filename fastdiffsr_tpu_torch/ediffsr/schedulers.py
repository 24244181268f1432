"""EDiffSR learning-rate schedules as pure functions of the step.

Counterpart of ``fastdiffsr_tpu/ediffsr/schedulers.py`` and of the optax
schedules ``fastdiffsr_tpu/ediffsr/train.py::make_lr_schedule`` builds
(reference EDiffSR/codes/config/sisr/models/lr_scheduler.py and
base_model.py):

- :func:`cosine_decay_schedule` (TrueCosineAnnealingLR):
  ``optax.cosine_decay_schedule(lr, total, alpha=eta_min/lr)``;
- :func:`piecewise_constant_schedule` (MultiStepLR):
  ``optax.piecewise_constant_schedule``;
- :func:`multistep_restart_schedule` (MultiStepLR_Restart): step decays at
  milestones by a hard-coded 0.5 (the reference ignores its ``gamma``
  argument; pass ``gamma`` to override), resets to ``lr * weight`` at
  restarts;
- :func:`cosine_annealing_restart_schedule` (CosineAnnealingLR_Restart);
- :func:`with_warmup`: for ``step + 1 < warmup_iter`` the rate is
  ``lr * (step + 1) / warmup_iter`` whatever the schedule says.

``f(step)`` is the rate of update ``step`` (0-based): optax evaluates a
schedule at its count before incrementing it, so the train loop sets
``param_group["lr"] = f(state.step)`` before each optimizer step, and
uses no ``torch.optim.lr_scheduler``, whose step order differs by one.
Values are float32, as optax computes them.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np

Schedule = Callable[[int], float]
_f32 = np.float32


def cosine_decay_schedule(init_lr: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    def schedule(step: int) -> float:
        frac = _f32(min(step, decay_steps)) / _f32(decay_steps)
        cosine = _f32(0.5) * (_f32(1.0) + np.cos(_f32(math.pi) * frac,
                                                 dtype=np.float32))
        decayed = (_f32(1.0) - _f32(alpha)) * cosine + _f32(alpha)
        return float(_f32(init_lr) * decayed)
    return schedule


def piecewise_constant_schedule(init_lr: float,
                                boundaries_and_scales: Dict[int, float]
                                ) -> Schedule:
    items = sorted(boundaries_and_scales.items())

    def schedule(step: int) -> float:
        v = _f32(init_lr)
        for bound, scale in items:
            if step >= bound:
                v = v * _f32(scale)
        return float(v)
    return schedule


def multistep_restart_schedule(init_lr: float, milestones: Sequence[int],
                               restarts: Optional[Sequence[int]] = None,
                               weights: Optional[Sequence[float]] = None,
                               gamma: float = 0.5) -> Schedule:
    """lr(t) = init_lr * weight[last restart <= t] * gamma^(#milestones in
    (last restart, t])."""
    restarts = list(restarts) if restarts else []
    weights = list(weights) if weights else []
    assert len(restarts) == len(weights), \
        "restarts and their weights do not match."
    order = np.argsort(np.asarray([0] + restarts, np.int64))
    r = [([0] + restarts)[i] for i in order]
    w = [([1.0] + weights)[i] for i in order]
    m = sorted(int(x) for x in milestones)

    def schedule(step: int) -> float:
        i = bisect.bisect_right(r, step) - 1
        n = bisect.bisect_right(m, step) - bisect.bisect_right(m, r[i])
        return float(_f32(init_lr * w[i] * _f32(gamma) ** _f32(n)))
    return schedule


def cosine_annealing_restart_schedule(
        init_lr: float, T_period: Sequence[int],
        restarts: Optional[Sequence[int]] = None,
        weights: Optional[Sequence[float]] = None,
        eta_min: float = 0.0) -> Schedule:
    """Cosine within each restart period; period i runs from restart i-1
    (or 0) for T_period[i] steps and peaks at init_lr * weight[i]."""
    restarts = list(restarts) if restarts else []
    weights = list(weights) if weights else []
    assert len(restarts) == len(weights), \
        "restarts and their weights do not match."
    assert len(T_period) == len(restarts) + 1, \
        "T_period needs one entry per restart segment."
    r = [0] + sorted(restarts)
    w = [_f32(x) for x in [1.0] + weights]
    T = [_f32(x) for x in T_period]

    def schedule(step: int) -> float:
        i = bisect.bisect_right(r, step) - 1
        frac = _f32(step - r[i]) / T[i]
        peak = _f32(init_lr) * w[i]
        return float(_f32(eta_min) + (peak - _f32(eta_min))
                     * (_f32(1) + np.cos(_f32(math.pi) * frac,
                                         dtype=np.float32)) / _f32(2))
    return schedule


def with_warmup(schedule, init_lr: float, warmup_iter: int) -> Schedule:
    """Linear warmup of the reference (base_model.py:52-64): its
    ``cur_iter`` is 1-based, so update ``step`` runs at
    ``init_lr * (step + 1) / warmup_iter`` while that is below
    ``warmup_iter``, then the base schedule takes over."""
    base = schedule if callable(schedule) else (lambda t: float(schedule))
    if not warmup_iter or warmup_iter <= 0:
        return base

    def warmed(step: int) -> float:
        cur = _f32(step) + _f32(1.0)
        if cur < warmup_iter:
            return float(_f32(init_lr) * cur / _f32(warmup_iter))
        return base(step)
    return warmed


def make_lr_schedule(train_opt, total_iters: int) -> Schedule:
    """The schedule of a ``train`` option block, warmup included
    (``fastdiffsr_tpu/ediffsr/train.py::make_lr_schedule``)."""
    lr = float(train_opt.get("lr_G", 4e-5))
    scheme = train_opt.get("lr_scheme", "TrueCosineAnnealingLR")
    eta_min = float(train_opt.get("eta_min", 1e-7))
    if scheme == "TrueCosineAnnealingLR":
        sched = cosine_decay_schedule(lr, total_iters, alpha=eta_min / lr)
    elif scheme == "MultiStepLR":
        sched = piecewise_constant_schedule(
            lr, {int(s): float(train_opt.get("lr_gamma", 0.5))
                 for s in (train_opt.get("lr_steps") or [])})
    elif scheme == "MultiStepLR_Restart":
        sched = multistep_restart_schedule(
            lr, train_opt.get("lr_steps") or [],
            restarts=train_opt.get("restarts"),
            weights=train_opt.get("restart_weights"))
    elif scheme == "CosineAnnealingLR_Restart":
        sched = cosine_annealing_restart_schedule(
            lr, train_opt.get("T_period") or [total_iters],
            restarts=train_opt.get("restarts"),
            weights=train_opt.get("restart_weights"), eta_min=eta_min)
    else:
        sched = lr
    return with_warmup(sched, lr, int(train_opt.get("warmup_iter") or -1))
