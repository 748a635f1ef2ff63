"""The suite's bounds on a test's time: the per-test limit that the
repository's root conftest.py arms around every test
(tests/_time_limit.py), and the child process of tests/_bounded_child.py
for work that blocks in a C call.

The limit's cases run a small test file in a pytest subprocess that loads
the limit's plugin with its default lowered to 2 s, so that the failures
they provoke are that run's and not this one's.
"""

import ast
import multiprocessing
import os
import time

import pytest

from _bounded_child import Child

pytest_plugins = "pytester"

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))

# A plugin for the subprocess: a 2 s limit, and the timer's state once
# every test is done.
RECORD_TIMER = """
import signal

import _time_limit

_time_limit.DEFAULT_TIME_LIMIT_S = 2


def pytest_sessionfinish(session):
    with open("timer_after.txt", "w") as f:
        f.write(repr(signal.getitimer(signal.ITIMER_REAL)))
"""


@pytest.fixture
def run_limited(pytester, monkeypatch):
    """Runs a test file's source under the suite's time limit."""
    monkeypatch.setenv("PYTHONPATH", TESTS_DIR)
    monkeypatch.setenv("PYTEST_DISABLE_PLUGIN_AUTOLOAD", "1")

    def run(source, *args):
        pytester.makepyfile(record_timer=RECORD_TIMER)
        pytester.makepyfile(test_limited=source)
        return pytester.runpytest_subprocess(
            "-p", "_time_limit", "-p", "record_timer",
            "-p", "no:cacheprovider", *args, "test_limited.py")

    return run


def _timer_after(pytester):
    return ast.literal_eval((pytester.path / "timer_after.txt").read_text())


def test_over_its_limit_fails_and_names_the_limit(run_limited, pytester):
    result = run_limited("""
import time


def test_sleeps():
    time.sleep(30)
""")
    result.assert_outcomes(failed=1)
    result.stdout.fnmatch_lines([
        "*test_limited.py::test_sleeps ran over its 2 s limit*",
        "*most recent call first*",
    ])
    assert result.duration < 10
    assert _timer_after(pytester) == (0.0, 0.0)


def test_in_time_passes_and_disarms(run_limited, pytester):
    result = run_limited("""
import signal
import time


def test_quick():
    time.sleep(0.2)
    assert 0.0 < signal.getitimer(signal.ITIMER_REAL)[0] <= 1.8
""")
    result.assert_outcomes(passed=1)
    assert _timer_after(pytester) == (0.0, 0.0)


def test_slow_fixture_fails_its_own_test_only(run_limited, pytester):
    result = run_limited("""
import time

import pytest


@pytest.fixture
def slow_setup():
    time.sleep(30)


def test_slow_fixture(slow_setup):
    pass


def test_next():
    time.sleep(0.5)
""")
    result.assert_outcomes(passed=1, errors=1)
    result.stdout.fnmatch_lines([
        "*ERROR at setup of test_slow_fixture*",
        "*test_limited.py::test_slow_fixture ran over its 2 s limit*",
    ])
    assert result.duration < 10
    assert _timer_after(pytester) == (0.0, 0.0)


def test_armed_in_an_xdist_worker(run_limited):
    result = run_limited("""
import signal
import threading


def test_armed():
    assert threading.current_thread() is threading.main_thread()
    assert 0.0 < signal.getitimer(signal.ITIMER_REAL)[0] <= 2.0
""", "-p", "xdist", "-n", "1")
    result.assert_outcomes(passed=1)
    assert result.duration < 10


def _read_forever():
    """Blocks in os.read on a pipe that nobody writes to."""
    read_end, _write_end = os.pipe()
    os.read(read_end, 1)


def test_child_blocked_in_c_is_killed_at_its_limit():
    before = set(multiprocessing.active_children())
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match="a blocked read: the child did not finish "
                             "within its 2 s limit and was killed"):
        Child(_read_forever, ()).result(2, "a blocked read")
    assert time.monotonic() - start < 10
    assert set(multiprocessing.active_children()) - before == set()


def test_child_returns_its_value():
    before = set(multiprocessing.active_children())
    assert Child(pow, (2, 10)).result(30, "pow") == 1024
    assert set(multiprocessing.active_children()) - before == set()


def test_child_that_raises_fails_the_test():
    with pytest.raises(pytest.fail.Exception,
                       match="(?s)int: the child raised within its 30 s "
                             "limit:.*ValueError"):
        Child(int, ("x",)).result(30, "int")


# A conftest for the subprocess: every test runs in a child killed at 3 s,
# and the children still alive at the end are counted.
RUN_IN_A_CHILD = """
import multiprocessing

import pytest

from _bounded_child import run_test_bounded


@pytest.hookimpl(tryfirst=True)
def pytest_pyfunc_call(pyfuncitem):
    return run_test_bounded(pyfuncitem, 3, pyfuncitem.name) or None


def pytest_sessionfinish(session):
    with open("children_after.txt", "w") as f:
        f.write(repr(len(multiprocessing.active_children())))
"""


def test_whole_test_in_a_child(pytester, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", TESTS_DIR)
    monkeypatch.setenv("PYTEST_DISABLE_PLUGIN_AUTOLOAD", "1")
    pytester.makeconftest(RUN_IN_A_CHILD)
    pytester.makepyfile(test_in_child="""
import os
import time

import pytest


@pytest.mark.parametrize("case", [0, 1])
def test_blocks(case):
    with open(f"started_{case}.txt", "w") as f:
        f.write(repr(time.monotonic()))
    read_end, _write_end = os.pipe()
    os.read(read_end, 1)


def test_fails():
    assert 1 + 1 == 3, "wrong in the child"


def test_passes():
    assert True
""")
    result = pytester.runpytest_subprocess("-p", "no:cacheprovider")
    result.assert_outcomes(passed=1, failed=3)
    result.stdout.fnmatch_lines_random([
        "*test_blocks?0?: the child did not finish within its 3 s limit "
        "and was killed*",
        "*test_blocks?1?: the child did not finish within its 3 s limit "
        "and was killed*",
        "*wrong in the child*",
    ])
    # The two blocked cases ran side by side, not one after the other.
    started = [float((pytester.path / f"started_{case}.txt").read_text())
               for case in (0, 1)]
    assert abs(started[0] - started[1]) < 2
    assert (pytester.path / "children_after.txt").read_text() == "0"
