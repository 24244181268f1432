"""The traced part of a ``--trace 1`` run and what is read from it.

``torch.profiler`` records the device's activity alone (CUPTI: kernels,
copies, sets) over a fixed number of the window's calls (the mix's
``trace_batches`` or ``trace_steps``); host operators are not recorded,
so the trace adds next to nothing to the host's time per call. The
window and the benchmark's own spans around its calls (``Spans``) are
taken on the host's clock. The window opens, after a synchronisation,
with a marker kernel (``torch.cuda._sleep``) whose start on the device's
timeline, less its host time, maps one clock onto the other; it closes
after the last synchronisation. From the events:

- busy: the union of the device's activity intervals in the window (not
  the marker, nor a span mirrored onto the device's timeline), so
  overlapping kernels count once;
- device time by kernel name (summed, not unioned);
- the idle gaps of the device inside the window, each named by the
  innermost host span around its middle.

The events are kept in memory and nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch

MARKER = "spin_kernel"      # torch.cuda._sleep's kernel


class Spans:
    """Host-clock spans around the benchmark's own calls; a no-op until
    ``on`` is set."""

    def __init__(self):
        self.on = False
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))


def union_intervals(intervals) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Window:
    """The traced window: ``with traced_window(spans, sync) as w:`` runs
    the calls under the profiler; ``w.summary()`` reads the result."""

    def __init__(self, prof, spans: Spans):
        self.prof, self.spans = prof, spans
        self.t0 = self.t1 = 0.0

    def summary(self) -> "Summary":
        return Summary(self.prof.events(), self.t0, self.t1,
                       self.spans.items)


@contextlib.contextmanager
def traced_window(spans: Spans, sync):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w = Window(prof, spans)
        sync()
        spans.on = True
        w.t0 = time.perf_counter()
        torch.cuda._sleep(1000)
        yield w
        with spans("sync"):
            sync()
        w.t1 = time.perf_counter()
        spans.on = False


class Summary:
    """What the per-layer readers see of a trace (times in seconds, on the
    host's clock)."""

    def __init__(self, events, t0: float, t1: float, spans):
        from torch.autograd import DeviceType
        device, marks = [], []
        for e in events:
            if (e.device_type != DeviceType.CUDA
                    or getattr(e, "is_user_annotation", False)):
                continue
            s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
            (marks if MARKER in e.name else device).append((e.name, s, t))
        if not marks:
            raise RuntimeError("the trace holds no window marker: was the "
                               "device traced?")
        # the device clock's reading at host time t0 (the marker starts a
        # launch latency, some microseconds, after it)
        shift = min(s for _, s, _ in marks) - t0
        self.t0, self.t1 = t0, t1
        self.window_s = t1 - t0
        inside = [(n, max(s - shift, t0), min(t - shift, t1))
                  for n, s, t in device if t - shift > t0 and s - shift < t1]
        self.busy_intervals = union_intervals((s, t) for _, s, t in inside)
        self.busy_s = sum(t - s for s, t in self.busy_intervals)
        self.by_kernel: Dict[str, float] = {}
        for n, s, t in inside:
            self.by_kernel[n] = self.by_kernel.get(n, 0.0) + (t - s)
        self.spans = list(spans)

    def kernel_s(self, *fragments: str) -> float:
        """Device seconds of the kernels whose name holds a fragment."""
        return sum(v for n, v in self.by_kernel.items()
                   if any(f in n for f in fragments))

    def top_kernels(self, k: int = 10):
        top = sorted(self.by_kernel.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], v] for n, v in top]

    def idle_gaps(self, k: int = 10):
        edges = [self.t0]
        for s, t in self.busy_intervals:
            edges += [s, t]
        edges.append(self.t1)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        out = []
        for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = (s + t) / 2
            around = [(b - a, n) for n, a, b in self.spans if a <= mid <= b]
            out.append([min(around)[1] if around else "between spans", t - s])
        return out
