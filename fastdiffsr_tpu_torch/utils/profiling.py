"""Profiling and accounting utilities.

Counterpart of ``fastdiffsr_tpu/utils/profiling.py`` (reference: thop's
FLOPs and parameter counts, model/base_model.py:52-58, and the CUDA-sync
wall timers of sr_mfe.py:279-284):

- :func:`param_count`: exact;
- :func:`flops_estimate`: ``torch.utils.flop_counter.FlopCounterMode``
  over one call. It counts the matrix products and convolutions only
  (XLA's cost analysis in JAX counts every op); the kernel wrappers call
  their registered operators under it (``ops/library.py``), and K3's
  flop formula counts its 3x3 convolution, so the fused forward counts
  what the plain one does;
- :func:`trace`: ``torch.profiler`` over CPU and CUDA activities,
  writing a Chrome / TensorBoard trace;
- :class:`Throughput`: steps/s and images/s.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Callable, Iterable, Mapping, Union

import torch


def param_count(params: Union[torch.nn.Module, Mapping[str, torch.Tensor],
                              Iterable[torch.Tensor]]) -> int:
    """The number of parameters of a module, a state dict or an iterable
    of tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    elif isinstance(params, Mapping):
        params = params.values()
    return sum(int(p.numel()) for p in params)


def flops_estimate(fn: Callable, *args) -> dict:
    """Run ``fn(*args)`` once without gradients and return its
    {'flops', 'bytes_accessed'}: the floating-point operations of its
    matrix products and convolutions (a multiply-add counts 2), and
    ``nan`` for the bytes, which the flop counter does not estimate (JAX
    gives nan where its cost analysis lacks a field)."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": math.nan}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a
    device is present) and write its Chrome trace, which TensorBoard's
    profiler plugin also reads, to ``log_dir/trace_<pid>_<time>.json``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


class Throughput:
    """steps/sec & images/sec counter."""

    def __init__(self):
        self.t0 = time.time()
        self.steps = 0
        self.images = 0

    def update(self, batch_size: int):
        self.steps += 1
        self.images += batch_size

    def rates(self) -> dict:
        dt = max(time.time() - self.t0, 1e-9)
        return {"steps_per_sec": self.steps / dt,
                "images_per_sec": self.images / dt}
