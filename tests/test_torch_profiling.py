"""The port's profiling hooks (``refign_tpu_torch/utils/profiling.py``)
on the CPU, against the JAX module's API
(``refign_tpu/utils/profiling.py``): ``trace`` writes a trace file that
holds the block's operations, ``StepTracer`` opens at its start step and
closes at its stop step (a trace of exactly that window), and does nothing
without a directory; ``StepTimer`` reports a rate every ``window`` ticks.
"""
import glob
import inspect
import json
import os

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
    for name in ("trace", "StepTracer", "StepTimer"):
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


def test_step_timer_reports_every_window():
    timer = profiling.StepTimer(window=3)
    rates = [timer.tick() for _ in range(7)]
    assert [r is None for r in rates] == [True, True, False, True, True,
                                          False, True]
    assert rates[2] > 0 and rates[5] > 0
