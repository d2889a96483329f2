"""Profiling hooks on ``torch.profiler`` (counterpart of
``refign_tpu/utils/profiling.py``, whose ``trace`` and ``StepTracer`` it
keeps), and the port's phase spans and host-sync counter.

``trace(logdir)`` profiles a block, ``StepTracer`` a window of training
steps [start, stop), each into a trace file under ``logdir`` (Chrome trace
JSON, ``<host>_<pid>.<time>.pt.trace.json``, which TensorBoard's profiler
plugin and Perfetto read); host operations always, the card's kernels
where there is one.

``span(name)`` marks a phase of the port's hot paths (the train steps'
phases, the slide forward's); a :class:`Recorder`, while it is on, keeps
each span and each point where the host blocked on the card, in memory,
as plain data.  Off (no recorder started), ``span`` costs one check of a
module global and returns a shared no-op context.

The clock is ``torch.profiler``'s: epoch nanoseconds, the clock of
``prof.profiler.kineto_results.trace_start_ns()`` and of each kineto
event's ``start_ns()``/``end_ns()``, device events included (kineto maps
CUPTI's timestamps onto it).  A span's ends are ``time.time_ns()``, so a
span and the device events of a profiler window opened around it compare
directly: a reader can put every idle instant of the card down to the
innermost span open on the host at that instant.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

__all__ = ["trace", "StepTracer", "span", "Recorder", "Span", "Sync"]


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


# ---------------------------------------------------------------------------
# phase spans and the host-sync counter
# ---------------------------------------------------------------------------

# what torch warns at a synchronizing CUDA call under sync-debug mode "warn"
# (c10/cuda/CUDAFunctions.cpp, ``warn_or_error_on_sync``)
SYNC_MESSAGE = "called a synchronizing CUDA operation"
# what torch warns once a process on entering that mode
_PROTOTYPE_MESSAGE = "Synchronization debug mode is a prototype feature"


@dataclasses.dataclass
class Span:
    """One recorded span: ``parent`` is the index of the enclosing span in
    the recorder's list (None for a root), ``step`` the ordinal of the
    root span it lies in (one a step or frame), ``end_ns`` None while it
    is open."""
    name: str
    parent: Optional[int]
    step: int
    start_ns: int
    end_ns: Optional[int] = None


@dataclasses.dataclass
class Sync:
    """One point where the host blocked on the card: when the blocking
    call returned and the index of the innermost span open then (None
    outside every span)."""
    t_ns: int
    span: Optional[int]


_active: Optional["Recorder"] = None     # the recorder that is on, if any
_OFF = contextlib.nullcontext()


class _Open:
    __slots__ = ("rec", "name", "index")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        parent = rec._open[-1] if rec._open else None
        if parent is None:
            step = rec._roots
            rec._roots += 1
        else:
            step = rec.spans[parent].step
        self.index = len(rec.spans)
        rec.spans.append(Span(self.name, parent, step, time.time_ns()))
        rec._open.append(self.index)
        return self

    def __exit__(self, *exc):
        self.rec.spans[self.index].end_ns = time.time_ns()
        self.rec._open.pop()
        return False


def span(name: str):
    """A context marking a phase: recorded by the active :class:`Recorder`,
    nothing (a shared no-op context) without one."""
    rec = _active
    if rec is None:
        return _OFF
    return _Open(rec, name)


class Recorder:
    """Records the port's spans and its host syncs between ``start()`` and
    ``stop()`` (or as a context), at most one recorder on in a process.

    ``spans`` (:class:`Span`, in the order they opened: a parent before
    its children) and ``syncs`` (:class:`Sync`, in time order) are plain
    data, kept in memory.  While it is on, torch's sync-debug mode is
    "warn" where CUDA is present (restored at ``stop()``), and every
    warning of a synchronizing CUDA call (``.item()``, ``float()`` of a
    device tensor, a pageable host-to-device copy, a ``.cpu()``,
    ``nonzero``, boolean indexing, a stream's synchronize) is counted,
    each call once, none printed.  ``torch.cuda.synchronize()`` itself is
    not counted, and torch calls the mode a prototype that does not yet
    catch every synchronizing call.  The CPU build of torch has no
    sync-debug mode, so there nothing warns and no sync is counted."""

    def __init__(self):
        self.spans: List[Span] = []
        self.syncs: List[Sync] = []
        self._open: List[int] = []
        self._roots = 0
        self._warnings = None
        self._mode = None

    def start(self) -> "Recorder":
        global _active
        if _active is not None:
            raise RuntimeError("a Recorder is on already")
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        # every sync warns: not once a source line, as by default
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        warnings.filterwarnings("ignore", message=_PROTOTYPE_MESSAGE)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_MESSAGE):
                self._sync()
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        if torch.cuda.is_available():
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        _active = self
        return self

    def stop(self) -> None:
        global _active
        if _active is not self:
            raise RuntimeError("this Recorder is not on")
        _active = None
        if self._mode is not None:
            torch.cuda.set_sync_debug_mode(self._mode)
            self._mode = None
        self._warnings.__exit__(None, None, None)
        self._warnings = None

    def _sync(self) -> None:
        self.syncs.append(Sync(time.time_ns(),
                               self._open[-1] if self._open else None))

    def __enter__(self) -> "Recorder":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
