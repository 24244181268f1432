"""What a runner hands back to ``run.py``."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Outcome:
    e2e: dict               # end-to-end metric name -> value
    units: dict             # end-to-end metric name -> unit
    attempted: int          # images served or trained in the window
    failed: int             # of those, images with a non-finite result
    checks: dict            # compared number -> value
    peak_bytes: int         # torch.cuda.max_memory_allocated, the window
    setup_peak_bytes: int   # the same over set-up
    setup_parts: dict       # parts of setup_s, in seconds
    summary: Optional[object]   # trace.Summary of a --trace 1 run
    work: dict              # what the per-layer readers count with
