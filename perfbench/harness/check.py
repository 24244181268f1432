"""The numbers that decide ``correct``, each against its limit.

Sampling: ``sr_gap``, the largest over the checked images of the RMS of
(program SR - reference SR) over the RMS of the reference's residual
(its SR - the bicubic conditioning). Images are drawn from the seed
among those the window finished.

Training, over the first three steps that set-up drives through the
window's own call (the reference follows the same three):

- ``loss_gap``: |loss - reference loss| / |reference loss| of the first
  step, which the forward alone decides;
- ``grad_gap``: the first step's gradient as Adam holds it (its first
  moment / (1 - b1)), leaf by leaf: |norm - reference norm| over the
  larger of the reference leaf's norm and the median leaf's; at the
  median leaf;
- ``change_gap``, ``ema_gap``: the same of each leaf's change over the
  three steps, of the parameters and of their EMA, at the median leaf,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (Adam moves those by rounding alone).

Beside them, not compared: ``loss3_gap`` (the worst of the three
steps' losses) and ``grad_worst``, ``change_worst``, ``ema_worst`` (the
worst leaf). An
L1 loss's gradient changes sign where the prediction meets the noise,
and Adam's first steps move each element by about its learning rate
whatever its gradient's size, so a sign that rounding flips in one small
leaf moves that leaf's later steps: the worst leaf after three steps and
the later losses swing from seed to seed, the first loss and the median
leaf do not (``PERF.md``).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch


def sr_gap(prog: torch.Tensor, ref: torch.Tensor,
           cond: torch.Tensor) -> float:
    """(B,H,W,C) float32 tensors on one device."""
    d = (prog - ref).flatten(1)
    r = (ref - cond).flatten(1)
    per_image = d.pow(2).mean(1).sqrt() / r.pow(2).mean(1).sqrt()
    return float(per_image.max())


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> List[float]:
    names = [n for n in ref if keep is None or n in keep]
    median = statistics.median(ref[n] for n in ref)
    return [abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
            for n in names]


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (per step), ``grad1``,
    ``change`` and ``ema_change`` (leaf name -> norm)."""
    med = statistics.median(ref["grad1"].values())
    moved = {n for n, v in ref["grad1"].items() if v >= 1e-3 * med}
    losses = [abs(a - b) / abs(b)
              for a, b in zip(prog["losses"], ref["losses"])]
    grad = leaf_gaps(prog["grad1"], ref["grad1"])
    change = leaf_gaps(prog["change"], ref["change"], moved)
    ema = leaf_gaps(prog["ema_change"], ref["ema_change"], moved)
    return {"loss_gap": losses[0],
            "grad_gap": statistics.median(grad),
            "change_gap": statistics.median(change),
            "ema_gap": statistics.median(ema),
            "loss3_gap": max(losses), "grad_worst": max(grad),
            "change_worst": max(change),
            "ema_worst": max(ema)}


def verdict(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, [[name, value, limit], ...]) over every limit."""
    rows: List[list] = []
    ok = True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and v == v and v <= limit
        ok &= good
        rows.append([name, v, limit])
    return ok, rows
