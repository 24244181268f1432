"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` from
the repository's root (on the card, ``-m gpu`` runs the ones that need
it)."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one")
