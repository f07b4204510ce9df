"""The benchmark's own tests: ``python -m pytest uhdrbench/tests -q`` from
the root of the repository (the ``card`` ones skip without a CUDA card)."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")
