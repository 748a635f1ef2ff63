"""Hooks for every test in the repository: each test's time limit, and a
child process for the tests whose work can block inside a C call.

They live in this file, which pytest loads before tests/conftest.py and
applies to every test below it, because the files that were there before
the PyTorch port, tests/conftest.py and the JAX package's tests among
them, stay as they are.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

from _bounded_child import run_test_bounded  # noqa: E402
from _time_limit import pytest_runtest_protocol  # noqa: E402,F401

# Tests of the JAX package that can block forever inside an XLA
# computation, where no signal reaches them (ROADMAP, faults of the
# reference, b), each with its limit in seconds. Each runs unchanged, its
# fixtures included, in a pytest session of a child process that is
# killed at that limit.
#
# test_corrupt_ba_requests_map_reset: with the compilation cache empty, a
# child reaches the case's first track_frame 136-140 s after it starts
# (about 80 s with it full), on an 8-core host with nothing else running.
IN_A_CHILD = {
    "tests/test_slam.py::test_corrupt_ba_requests_map_reset": 300,
}


@pytest.hookimpl(tryfirst=True)
def pytest_pyfunc_call(pyfuncitem):
    limit = IN_A_CHILD.get(pyfuncitem.nodeid.split("[")[0])
    if limit is None:
        return None
    return run_test_bounded(
        pyfuncitem, limit,
        f"{pyfuncitem.nodeid}, run in a child process (ROADMAP, faults of "
        f"the reference, b)") or None
