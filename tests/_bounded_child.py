"""Run a function, or a whole pytest test, in a child process that is
killed at a time limit.

A test whose work can block inside a C call, such as an XLA computation
that never finishes, cannot be ended by a signal in its own process:
Python runs a signal handler only once the call returns. Such work runs
here instead, and the test's process waits on a pipe that it can stop
waiting on.

The child is started by the ``spawn`` method, so the target must be a
module-level function of an importable module, and its arguments and
its result must pickle. Children are daemonic: one that nobody waited
for is ended when its parent exits.
"""

import multiprocessing
import time
import traceback

import pytest


def _child_main(conn, target, args):
    try:
        conn.send(("returned", target(*args)))
    except BaseException:
        conn.send(("raised", traceback.format_exc()))
        raise
    finally:
        conn.close()


class Child:
    """``target(*args)``, started in a spawned child."""

    def __init__(self, target, args):
        ctx = multiprocessing.get_context("spawn")
        self._receiver, sender = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=_child_main,
                                 args=(sender, target, args), daemon=True)
        self._proc.start()
        self._started = time.monotonic()
        sender.close()

    def result(self, limit, what):
        """The child's return value, within ``limit`` seconds of its
        start. Fails the calling test, with ``limit`` and ``what`` in the
        message, when the child has sent nothing by then, when it raised,
        or when it died without a word. The child is killed and reaped on
        every way out, so none is left running."""
        answered = False
        try:
            # The wait is on the pipe rather than on the process: a child
            # that has sent its result may still hang on its way out, in a
            # thread blocked in the same computation.
            left = self._started + limit - time.monotonic()
            if not self._receiver.poll(max(left, 0)):
                pytest.fail(f"{what}: the child did not finish within its "
                            f"{limit} s limit and was killed", pytrace=False)
            try:
                kind, value = self._receiver.recv()
            except EOFError:
                self._proc.join()
                pytest.fail(f"{what}: the child died with exit code "
                            f"{self._proc.exitcode} within its {limit} s "
                            f"limit", pytrace=False)
            answered = True
            if kind == "raised":
                pytest.fail(f"{what}: the child raised within its {limit} s "
                            f"limit:\n{value}", pytrace=False)
            return value
        finally:
            self._receiver.close()
            self._proc.join(5 if answered else 0)
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join()


_IN_A_CHILD = pytest.StashKey[bool]()
_STARTED = pytest.StashKey[dict]()


class _Outcome:
    """The child's pytest plugin: marks its session as a child's, and
    keeps what the test reported."""

    def __init__(self):
        self.failures = []
        self.passed = False

    def pytest_configure(self, config):
        config.stash[_IN_A_CHILD] = True

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failures.append(f"{report.when}: {report.longreprtext}")
        elif report.when == "call":
            self.passed = report.passed


def _run_test(test, rootdir):
    """One pytest test, named by ``path::name``, run in this process."""
    outcome = _Outcome()
    code = pytest.main([test, "-q", "--rootdir", rootdir, "-o", "addopts=",
                        "-p", "no:xdist", "-p", "no:cacheprovider",
                        "-p", "no:randomly"], plugins=[outcome])
    return int(code), outcome.failures, outcome.passed


def _function_id(item):
    return item.nodeid.split("[")[0]


def run_test_bounded(item, limit, what):
    """Runs the pytest function ``item`` in a spawned child's own pytest
    session, fixtures included, and passes only if it passed there. The
    child is killed ``limit`` seconds after it started.

    The children of every parametrized case of the same function start
    together, at the first case, so that their limits run side by side
    rather than one after the other. In a child itself this returns
    False, and the test is left to run in process."""
    if item.config.stash.get(_IN_A_CHILD, False):
        return False
    started = item.session.stash.setdefault(_STARTED, {})
    for case in item.session.items:
        if (_function_id(case) == _function_id(item)
                and case.nodeid not in started):
            started[case.nodeid] = Child(
                _run_test, (f"{case.path}::{case.name}",
                            str(case.config.rootpath)))
    code, failures, passed = started[item.nodeid].result(limit, what)
    if failures:
        pytest.fail(f"{what}: in the child process:\n" + "\n".join(failures),
                    pytrace=False)
    if not passed:
        pytest.fail(f"{what}: the test did not pass in the child process "
                    f"(pytest exit code {code})", pytrace=False)
    return True
