"""The benchmark's own CPU tests: ``python -m pytest benchmark/tests``
from the repository's root. Tests that need the CUDA card carry the
``chip`` marker and decide inside the test whether there is one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs the CUDA card; skips without one")
