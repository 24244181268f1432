#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``fastdiffsr_tpu_torch``. It
needs as many CUDA devices as the cell asks for and exits non-zero,
printing no result, without them. The weights and inputs come from
``--seed``; set-up (loading the kernel library, which the program builds
once per checkout under ``build/kernels/``, building the nets, warming
up the cell's shapes) is timed as ``setup_s``; then the runner that the
cell's traffic mix names (``runners/<name>.py``) measures for
``--seconds`` (``--trace 0``: the end-to-end metrics), or profiles a
fixed part of the window (``--trace 1``: the per-layer metrics), and the
output check runs against the reference. The last line
of standard output is one JSON object; the compared numbers, each beside
its limit, are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fastdiffsr_tpu")


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))
    from perfbench.harness import cells
    cell = cells.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    import fastdiffsr_tpu_torch  # noqa: F401  (the program under test)

    from perfbench.harness import report
    runner = cells.load_runner(cell.runner)
    device = torch.device("cuda", 0)
    outcome = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_START)
    found = loaded_forbidden()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    out, lines = report.result(cell, outcome, bool(args.trace),
                               cells.metric_readers(),
                               torch.cuda.get_device_name(0))
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
