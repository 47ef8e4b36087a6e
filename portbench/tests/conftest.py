"""The benchmark's own tests (run from the repository root:
``python -m pytest portbench/tests -q``).  They run on the CPU at small
sizes; a test marked ``card`` needs an NVIDIA GPU and skips without one,
decided inside the test."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")
