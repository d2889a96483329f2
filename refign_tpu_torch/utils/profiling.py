"""Profiling hooks on ``torch.profiler`` (counterpart of
``refign_tpu/utils/profiling.py``, whose API it keeps).

``trace(logdir)`` profiles a block, ``StepTracer`` a window of training
steps [start, stop), each into a trace file under ``logdir`` (Chrome trace
JSON, ``<host>_<pid>.<time>.pt.trace.json``, which TensorBoard's profiler
plugin and Perfetto read); host operations always, the card's kernels
where there is one.  ``StepTimer`` is a rolling step-rate timer.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

__all__ = ["trace", "StepTracer", "StepTimer"]


def _profiler(logdir: str) -> profile:
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir))


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """Profile the block into a trace file under ``logdir``."""
    prof = _profiler(logdir)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


class StepTracer:
    """Trace a window of training steps:
        tracer = StepTracer(logdir, start=10, stop=13)
        for step in ...: tracer.step(step)
    traces steps start .. stop - 1 (the trace opens when ``step(start)`` is
    called, before that step, and closes at ``step(stop)``).  ``logdir``
    None traces nothing."""

    def __init__(self, logdir: Optional[str], start: int, stop: int):
        self.logdir = logdir
        self.start = start
        self.stop = stop
        self._prof: Optional[profile] = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def step(self, step: int) -> None:
        if self.logdir is None:
            return
        if step == self.start and self._prof is None:
            self._prof = _profiler(self.logdir)
            self._prof.start()
        elif step >= self.stop and self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
            self._prof = None


class StepTimer:
    """Cheap rolling step timer for throughput logging."""

    def __init__(self, window: int = 50):
        self.window = window
        self.t0 = time.perf_counter()
        self.count = 0

    def tick(self) -> Optional[float]:
        """Steps per second over the last ``window`` steps, at every
        ``window``-th call; None otherwise."""
        self.count += 1
        if self.count % self.window == 0:
            dt = time.perf_counter() - self.t0
            self.t0 = time.perf_counter()
            return self.window / dt
        return None
