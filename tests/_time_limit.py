"""Every test's time limit: a pytest plugin that the repository's root
conftest.py installs.

A SIGALRM timer is armed around each test's setup, call and teardown, for
DEFAULT_TIME_LIMIT_S. On expiry the handler writes every thread's stack
and fails the test inside its worker. The handler runs only once the main
thread is back in Python, so a test whose work can block in a C call runs
in a child process that is killed at its own limit (tests/_bounded_child.py).
Neither kills a worker: under ``--dist loadfile`` xdist hands a dead
worker's file, with the test it died on still pending, to the replacement
worker, which runs that test again.

The module imports no JAX, so that a pytest subprocess can load it
quickly with ``-p _time_limit`` (tests/test_conftest_time_limit.py).
"""

import faulthandler
import signal
import sys
import threading

import pytest

# About twice the slowest test measured, fixtures included, on an 8-core
# host under the suite's 6-worker run
# (test_replicated_tracking.py::test_replicated_matches_serial, 232 s).
DEFAULT_TIME_LIMIT_S = 480


def _traceback_file():
    """The test's captured stderr where it has a file descriptor."""
    try:
        sys.stderr.fileno()
        return sys.stderr
    except (AttributeError, OSError, ValueError):
        return sys.__stderr__


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if threading.current_thread() is not threading.main_thread():
        return (yield)
    limit = DEFAULT_TIME_LIMIT_S

    def expire(signum, frame):
        faulthandler.dump_traceback(file=_traceback_file(), all_threads=True)
        pytest.fail(f"{item.nodeid} ran over its {limit} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
