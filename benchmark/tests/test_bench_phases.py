"""``benchmark/phases.py``'s arithmetic on hand-placed spans, syncs and
device events (nanoseconds on one clock): device idle split between
nested spans and ``outside_the_program``, gaps at the window's edges, the
per-call readings, and nothing per call where a window has no span."""
import dataclasses
from typing import Optional

import pytest

from benchmark import phases


@dataclasses.dataclass
class Span:
    name: str
    parent: Optional[int]
    step: int
    start_ns: int
    end_ns: Optional[int]


@dataclasses.dataclass
class Sync:
    t_ns: int
    span: Optional[int]


# window [0, 100]; step [10, 90] with phases a [10, 40] (a.inner [20, 30])
# and b [50, 80]; the device runs [0, 5], [25, 45], [60, 70], [95, 98]
SPANS = [Span("x.step", None, 0, 10, 90), Span("a", 0, 0, 10, 40),
         Span("a.inner", 1, 0, 20, 30), Span("b", 0, 0, 50, 80)]
EVENTS = [(60, 70), (0, 5), (25, 45), (95, 98), (30, 35)]


def test_idle_is_the_window_less_the_union_of_events():
    assert phases.idle(EVENTS, 0, 100) == [(5, 25), (45, 60), (70, 95),
                                           (98, 100)]
    assert phases.idle([], 0, 10) == [(0, 10)]
    # events past the window's ends are clipped
    assert phases.idle([(-5, 3), (8, 20)], 0, 10) == [(3, 8)]


def test_idle_by_span_splits_nested_spans_and_the_outside():
    got = phases.idle_by_span(SPANS, EVENTS, 0, 100)
    want = {"outside_the_program": 5 + 5 + 2, "a": 10, "a.inner": 5,
            "x.step": 5 + 10, "b": 10 + 10}
    assert got == pytest.approx({k: v / 1e9 for k, v in want.items()})
    assert sum(got.values()) == pytest.approx(
        sum(b - a for a, b in phases.idle(EVENTS, 0, 100)) / 1e9)


def test_gaps_at_the_window_edges_belong_to_the_outside():
    spans = [Span("s", None, 0, 0, 100)]
    assert phases.idle_by_span(spans, [(10, 90)], 0, 100) == pytest.approx(
        {"s": 20e-9})
    # a span left open runs to the window's end
    open_span = [Span("s", None, 0, 50, None)]
    assert phases.idle_by_span(open_span, [], 0, 100) == pytest.approx(
        {"outside_the_program": 50e-9, "s": 50e-9})


def test_syncs_and_per_call_readings():
    syncs = [Sync(5, None), Sync(22, 2), Sync(35, 1), Sync(60, 3)]
    assert phases.syncs_by_span(SPANS, syncs) == {
        "outside_the_program": 1, "a.inner": 1, "a": 1, "b": 1}
    got = phases.per_call(SPANS, syncs, EVENTS, 0, 100)
    # idle inside [10, 90]: 15 + 15 + 20 ns
    assert got == pytest.approx(dict(calls=1, idle_ms=50e-6, syncs=3,
                                     root_self_share_max=20 / 80))


def test_nothing_per_call_without_spans():
    assert phases.per_call([], [], EVENTS, 0, 100) is None
    assert phases.idle_by_span([], EVENTS, 0, 100) == pytest.approx(
        {"outside_the_program": 62e-9})
    r = phases.readings([], [], EVENTS, 0, 100)
    assert r["per_call"] is None and r["syncs_by_span"] == {}
