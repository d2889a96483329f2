"""The port's profiling hooks (``refign_tpu_torch/utils/profiling.py``)
on the CPU, against the JAX module's API
(``refign_tpu/utils/profiling.py``): ``trace`` writes a trace file that
holds the block's operations, ``StepTracer`` opens at its start step and
closes at its stop step (a trace of exactly that window), and does nothing
without a directory.  The port's own spans and host-sync counter (no JAX
counterpart): off, ``span`` records nothing and hands out one shared
context; on, the spans nest with their parents and steps in opening order,
every sync warning is counted under the innermost open span, and
``stop()`` puts back what ``start()`` changed.
"""
import glob
import inspect
import json
import os
import warnings

import pytest
import torch

from refign_tpu.utils import profiling as jax_profiling
from refign_tpu_torch.utils import profiling


def _traces(logdir):
    return sorted(glob.glob(os.path.join(logdir, "*.pt.trace.json")))


def _op_names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name") for e in events}


def test_api_matches_the_jax_module():
    for name in ("trace", "StepTracer"):
        port, ref = getattr(profiling, name), getattr(jax_profiling, name)
        want = inspect.signature(ref.__init__ if inspect.isclass(ref)
                                 else ref).parameters
        got = inspect.signature(port.__init__ if inspect.isclass(port)
                                else port).parameters
        assert list(got) == list(want), name
    assert list(inspect.signature(profiling.StepTracer.step).parameters) == \
        list(inspect.signature(jax_profiling.StepTracer.step).parameters)


def test_trace_writes_a_trace_of_the_block(tmp_path):
    logdir = str(tmp_path / "t")
    with profiling.trace(logdir):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    files = _traces(logdir)
    assert len(files) == 1
    assert "aten::mm" in _op_names(files[0])


def test_step_tracer_traces_its_window(tmp_path):
    logdir = str(tmp_path / "s")
    tracer = profiling.StepTracer(logdir, start=2, stop=4)
    active = []
    for step in range(6):
        tracer.step(step)
        active.append(tracer.active)
        # an op whose name tells the step
        torch.full((2,), float(step)).add_(1) if step in (2, 3) \
            else torch.zeros(2).mul_(2)
    assert active == [False, False, True, True, False, False]
    files = _traces(logdir)
    assert len(files) == 1
    names = _op_names(files[0])
    assert "aten::add_" in names and "aten::mul_" not in names


def test_step_tracer_without_a_directory_does_nothing(tmp_path):
    tracer = profiling.StepTracer(None, start=0, stop=1)
    for step in range(3):
        tracer.step(step)
        assert not tracer.active


def test_span_without_a_recorder_records_nothing():
    first, second = profiling.span("a"), profiling.span("b")
    assert first is second
    with first:
        with profiling.span("c"):
            pass
    rec = profiling.Recorder()
    assert rec.spans == [] and rec.syncs == []


def test_recorder_keeps_nesting_parents_steps_and_order():
    with profiling.Recorder() as rec:
        for _ in range(2):
            with profiling.span("step"):
                with profiling.span("a"):
                    with profiling.span("a.inner"):
                        pass
                with profiling.span("b"):
                    pass
    got = [(s.name, s.parent, s.step) for s in rec.spans]
    assert got == [("step", None, 0), ("a", 0, 0), ("a.inner", 1, 0),
                   ("b", 0, 0),
                   ("step", None, 1), ("a", 4, 1), ("a.inner", 5, 1),
                   ("b", 4, 1)]
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    starts = [s.start_ns for s in rec.spans]
    assert starts == sorted(starts)
    # off again: nothing more is kept
    with profiling.span("late"):
        pass
    assert len(rec.spans) == 8


def test_sync_marks_go_to_the_innermost_open_span():
    def sync():
        warnings.warn(profiling.SYNC_MESSAGE + " (Triggered internally)",
                      UserWarning)

    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        with profiling.Recorder() as rec:
            sync()
            with profiling.span("outer"):
                for _ in range(3):   # one source line, each counted
                    sync()
                with profiling.span("inner"):
                    sync()
                sync()
                warnings.warn("something else")
    assert [m.span for m in rec.syncs] == [None, 0, 0, 0, 1, 0]
    times = [m.t_ns for m in rec.syncs]
    assert times == sorted(times)
    inner = rec.spans[1]
    assert inner.start_ns <= rec.syncs[4].t_ns <= inner.end_ns
    # the syncs are counted, not shown; other warnings pass through
    assert [str(m.message) for m in shown] == ["something else"]


def test_stop_restores_and_a_second_start_raises(monkeypatch):
    modes = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    filters, shown = list(warnings.filters), warnings.showwarning
    rec = profiling.Recorder().start()
    try:
        assert modes == ["warn"]
        with pytest.raises(RuntimeError, match="on already"):
            profiling.Recorder().start()
        with pytest.raises(RuntimeError, match="on already"):
            rec.start()
    finally:
        rec.stop()
    assert modes == ["warn", 0]
    assert warnings.filters == filters and warnings.showwarning is shown
    assert profiling.span("x") is profiling.span("y")
    with pytest.raises(RuntimeError, match="not on"):
        rec.stop()


def test_without_cuda_the_sync_mode_is_left_alone(monkeypatch):
    def refuse(*a):
        raise AssertionError("sync-debug mode touched without CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", refuse)
    with profiling.Recorder() as rec:
        with profiling.span("a"):
            torch.ones(4).sum().item()
    assert [s.name for s in rec.spans] == ["a"] and rec.syncs == []
