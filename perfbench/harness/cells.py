"""Find a cell, its configuration, its traffic mix and the per-layer
metric readers by name, from the files under ``perfbench/``.

- ``workloads/<cell>.json``: ``config``, ``traffic``, ``chips``, ``why``,
  the ``end_to_end`` metrics it reports and the ``limits`` of its output
  check;
- ``configs/<config>.json``: the model configuration as it is run
  (``model``, ``train``), with ``source``, ``reduced`` and ``assumed``;
- ``traffic/<mix>.json``: the parameters of a mix, among them
  ``runner``, the name of the module under ``runners/`` that drives it
  (``sample_closed_loop``, ``train_steps``) and reports the end-to-end
  metrics with their units;
- ``metrics/<metric>.py``: ``LAYER``, ``UNIT``, ``MOVES`` and
  ``read(ctx)``, which returns the metric or None where the trace holds
  nothing for it.

A later cell, mix, runner or metric is one more file here and one more
entry in ``BENCHMARK.json``; no file that exists has to change.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
from types import ModuleType
from typing import Dict

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    spec: dict          # workloads/<cell>.json
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<mix>.json

    @property
    def runner(self) -> str:
        return self.traffic["runner"]

    @property
    def chips(self) -> int:
        return int(self.spec.get("chips", 1))


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    path = root / "workloads" / f"{name}.json"
    if not path.is_file():
        known = sorted(p.stem for p in (root / "workloads").glob("*.json"))
        raise SystemExit(f"no workload {name!r} (known: {', '.join(known)})")
    spec = _json(path)
    return Cell(name=name, spec=spec,
                config=_json(root / "configs" / f"{spec['config']}.json"),
                traffic=_json(root / "traffic" / f"{spec['traffic']}.json"))


def _load(path: pathlib.Path, prefix: str) -> ModuleType:
    name = prefix + path.name[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_runner(name: str, root: pathlib.Path = ROOT) -> ModuleType:
    """``runners/<name>.py``, whose ``run`` drives a mix's cells."""
    path = root / "runners" / f"{name}.py"
    if not NAME.fullmatch(name) or not path.is_file():
        raise SystemExit(f"no runner {name!r} under {root / 'runners'}")
    return _load(path, "perfbench_runner_")


def metric_readers(root: pathlib.Path = ROOT) -> Dict[str, ModuleType]:
    """Every per-layer metric reader under ``metrics/``, by metric name
    (the file's name without ``.py``)."""
    return {path.name[:-3]: _load(path, "perfbench_metric_")
            for path in sorted((root / "metrics").glob("*.py"))}
