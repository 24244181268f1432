"""The import boundary, compared by top-level module name whole: running
a cell's set-up, window and check loads neither JAX nor the JAX package,
and the reference loads nothing of the program either."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "fastdiffsr_tpu"}

RUN_CELLS = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from perfbench.tests.tiny import tiny_cell
from perfbench.harness import cells, report
for name in ("fastdiffsr_x4.infer_b1_f32", "sr3_x4.train_b4"):
    c = tiny_cell(name)
    cells.load_runner(c.runner).run(c, 1234, 0.2, False, torch.device("cpu"),
                                    time.perf_counter())
cells.metric_readers()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.reference.unets, perfbench.reference.diffusion
import perfbench.reference.precision
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         check=True, cwd=str(ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = top_level_modules(RUN_CELLS)
    assert "fastdiffsr_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = top_level_modules(REFERENCE)
    assert not mods & (FORBIDDEN | {"fastdiffsr_tpu_torch"})
