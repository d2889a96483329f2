"""A time limit for a block of test code, without a plugin package.

``limit(seconds)`` arms ``SIGALRM``; when it fires, the handler dumps
every thread's stack to stderr and raises :class:`TestTimeLimit` in the
main thread, which unwinds a test stuck in Python code, ``sleep``, a
socket or a join.  :class:`PhaseLimit` is the pytest plugin that runs
each test's setup, call and teardown under it; the repo's root
``conftest.py`` registers one.
"""
from __future__ import annotations

import contextlib
import faulthandler
import os
import signal
import sys

import pytest


class TestTimeLimit(Exception):
    """A block ran past its :func:`limit`."""
    __test__ = False


@contextlib.contextmanager
def limit(seconds: float):
    def expired(signum, frame):
        faulthandler.dump_traceback(file=sys.__stderr__, all_threads=True)
        raise TestTimeLimit(f"over its limit of {seconds} s")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


class PhaseLimit:
    """Each phase of a test under ``limit(seconds)``, so the exception
    lands in a phase pytest reports as that test's failure.  A hang in C
    code never returns to the interpreter to raise; for it a backstop
    writes every thread's stack to the run's stderr a minute later.  The
    backstop must not exit the process: xdist would re-queue the test on
    each fresh worker until it ran out of restarts."""

    def __init__(self, seconds: float):
        self.seconds = seconds

    def pytest_configure(self, config):
        # fd 2 outside pytest's capture, which redirects it during a test
        self.stderr_fd = os.dup(sys.__stderr__.fileno())

    @pytest.hookimpl(hookwrapper=True)
    def _phase(self, item):
        faulthandler.dump_traceback_later(self.seconds + 60,
                                          file=self.stderr_fd)
        try:
            with limit(self.seconds):
                yield
        finally:
            faulthandler.cancel_dump_traceback_later()

    pytest_runtest_setup = pytest_runtest_call = _phase
    pytest_runtest_teardown = _phase
