"""The result line of a run: the cell's metrics, the device, the
breakdown of a traced run and the compared numbers with their limits."""

from __future__ import annotations

import functools
import subprocess

from . import workcount
from .check import verdict

# K3: the conv kernel (bf16 or f32) and its statistics reduction; K1: the
# channel statistics, then normalise and Swish
K3_KERNELS = ("fused_conv_wgmma_kernel", "fused_conv_f32_kernel",
              "reduce_partials_kernel")
K1_KERNELS = ("channel_stats_kernel", "gn_swish_apply_kernel")


class Context:
    """What a per-layer metric reader gets: the trace summary
    (``busy_s``, ``window_s``, ``kernel_s(*names)``), the work done in the
    traced window (``kind``, ``batch``, ``dtype``, ``evals`` or
    ``steps``), ``pace_s``, the host seconds that as many calls took
    untraced just before it, the end-to-end metrics the cell reports
    (``reports``), the work counts of the cell's shapes and the shares
    computed from them, in percent (None where the trace holds nothing
    for one). The idle share and the step's share of the peak are taken
    at the untraced pace, so that the profiler's own cost on the host
    (CUPTI's record of each launch) does not read as idle time."""

    def __init__(self, summary, work: dict, reported=()):
        self.summary = summary
        self.reported = frozenset(reported)
        self.kind = work["kind"]
        self.batch, self.dtype = work["batch"], work["dtype"]
        self.evals = work.get("evals", 0)
        self.steps = work.get("steps", 0)
        self._model, self._size = work["model"], work["size"]
        self.busy_s, self.window_s = summary.busy_s, summary.window_s
        self.pace_s = work.get("pace_s") or summary.window_s

    def reports(self, metric: str) -> bool:
        return metric in self.reported

    def kernel_s(self, *fragments: str) -> float:
        return self.summary.kernel_s(*fragments)

    def idle_pct(self) -> float:
        """1 - the device's busy union in the traced calls over the
        untraced time of as many calls."""
        return 100.0 * (1.0 - self.busy_s / self.pace_s)

    def step_mfu_pct(self):
        """The model FLOPs of the traced evals or steps over the untraced
        time of as many and the peak of the cell's type."""
        if self.kind == "sample" and self.evals:
            work = self.flops_per_eval * self.evals
        elif self.kind == "train" and self.steps:
            work = self.flops_per_train_step * self.steps
        else:
            return None
        return 100.0 * work / (self.pace_s * self.peak_flops(self.dtype))

    def roofline_pct(self, bound_s: float, kernels) -> "float | None":
        """``bound_s`` of work over the device time of ``kernels``."""
        spent = self.kernel_s(*kernels)
        return 100.0 * bound_s / spent if spent > 0 else None

    def k3_roofline_pct(self):
        if self.kind != "sample":
            return None
        return self.roofline_pct(self.k3_bound_s_per_eval * self.evals,
                                 K3_KERNELS)

    def k1_roofline_pct(self):
        if self.kind != "train":
            return None
        return self.roofline_pct(self.k1_bound_s_per_forward * self.steps,
                                 K1_KERNELS)

    def peak_flops(self, dtype: str) -> float:
        return workcount.PEAK_FLOPS[dtype]

    @functools.cached_property
    def flops_per_eval(self) -> float:
        return workcount.flops_per_eval(self._model, self.batch, self._size)

    @functools.cached_property
    def flops_per_train_step(self) -> float:
        return workcount.flops_per_train_step(self._model, self.batch,
                                              self._size)

    @functools.cached_property
    def k3_bound_s_per_eval(self) -> float:
        return workcount.k3_bound_s_per_eval(self._model, self.batch,
                                             self._size, self.dtype)

    @functools.cached_property
    def k1_bound_s_per_forward(self) -> float:
        return workcount.k1_bound_s_per_forward(self._model, self.batch,
                                                self._size, self.dtype)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def result(cell, outcome, traced: bool, readers: dict, device_name: str):
    """(result dict, stderr lines of the compared numbers)."""
    ok, rows = verdict(outcome.checks, cell.spec["limits"])
    ok &= outcome.failed == 0 and outcome.attempted > 0
    # the process's peak; peak_mem_gib is the window's alone
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": max(outcome.peak_bytes,
                                       outcome.setup_peak_bytes),
              "memory_setup_peak_bytes": outcome.setup_peak_bytes,
              "power_limit_w": power_limit_w()}
    out = {"correct": bool(ok), "attempted": outcome.attempted,
           "failed": outcome.failed}
    if traced:
        ctx = Context(outcome.summary, outcome.work,
                      cell.spec["end_to_end"])
        metrics = {}
        for name, mod in readers.items():
            value = mod.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
        out["metrics"] = metrics
        device["busy_s"] = outcome.summary.busy_s
        device["window_s"] = outcome.summary.window_s
        device["pace_s"] = outcome.work.get("pace_s")
        out["device"] = device
        out["breakdown"] = {"device_ops": outcome.summary.top_kernels(),
                            "idle_gaps": outcome.summary.idle_gaps()}
    else:
        out["metrics"] = {name: {"value": outcome.e2e[name],
                                 "unit": outcome.units[name]}
                          for name in cell.spec["end_to_end"]}
        out["device"] = device
    out["setup_parts"] = outcome.setup_parts
    out["readings"] = outcome.checks    # compared or not, for the record
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    lines = [f"check {name}: {v} (limit {lim})" for name, v, lim in rows]
    lines.append(f"check failed_images: {outcome.failed} (limit 0)")
    return out, lines
