"""What the host was doing while the card waited: one cell's traced window
with the port's span recorder on.

    python3 benchmark/phases.py --workload <cell> --seed <n>

from the root of a checkout, on a machine with the card.  It runs the cell
as ``run.py --trace 1`` does (the same cell code, traced window and check),
with ``refign_tpu_torch.utils.profiling.Recorder`` on over the profiler
window, and prints one JSON object: the traced line's ``correct``,
``metrics`` and ``device``, and, on the profiler's clock (epoch ns, which
the recorder shares):

- ``idle_by_span``: device-idle seconds in the window by the innermost
  port span open on the host at each instant; ``outside_the_program``
  where none is (the benchmark's own batches, draws and bookkeeping);
- ``syncs_by_span``: the host's blocking calls by that span;
- ``per_call``: device idle inside the root spans (``uda.step``,
  ``align.step``, ``slide.frame``) in ms and syncs inside them, each per
  root span, and the largest share of a root span that no child covers.

It is not the benchmark's command: ``run.py``'s traced line carries none
of this until the harness starts the recorder itself (``PERF.md`` §7).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTSIDE = "outside_the_program"

Interval = Tuple[int, int]


def merged(intervals: Sequence[Interval], t0: int, t1: int
           ) -> List[Interval]:
    """The union of ``intervals`` clipped to [t0, t1], sorted, disjoint."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle(events: Sequence[Interval], t0: int, t1: int) -> List[Interval]:
    """The parts of [t0, t1] in which no device event ran."""
    out, at = [], t0
    for a, b in merged(events, t0, t1):
        if a > at:
            out.append((at, a))
        at = b
    if t1 > at:
        out.append((at, t1))
    return out


def overlap(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """The length of the intersection of two sorted disjoint lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def innermost(spans, t0: int, t1: int
              ) -> List[Tuple[int, int, Optional[int]]]:
    """[t0, t1] cut into pieces, each with the index of the innermost span
    open over it (None where none is).  Spans nest (one host thread); an
    unclosed span runs to t1."""
    marks = []
    for k, s in enumerate(spans):
        end = t1 if s.end_ns is None else s.end_ns
        marks.append((s.start_ns, 1, k))
        marks.append((end, 0, k))
    # at one instant: closes before opens, inner closes first
    marks.sort(key=lambda m: (m[0], m[1], -m[2] if m[1] == 0 else m[2]))
    out, stack, at = [], [], t0
    for t, opening, k in marks:
        t = min(max(t, t0), t1)
        if t > at:
            out.append((at, t, stack[-1] if stack else None))
            at = t
        if opening:
            stack.append(k)
        elif k in stack:
            stack.remove(k)
    if t1 > at:
        out.append((at, t1, stack[-1] if stack else None))
    return out


def _name(spans, k: Optional[int]) -> str:
    return OUTSIDE if k is None else spans[k].name


def idle_by_span(spans, events: Sequence[Interval], t0: int, t1: int
                 ) -> Dict[str, float]:
    """Device-idle seconds of [t0, t1] by the innermost span open on the
    host, by name; ``outside_the_program`` where none is."""
    gaps = idle(events, t0, t1)
    out: Dict[str, float] = {}
    for a, b, k in innermost(spans, t0, t1):
        ns = overlap([(a, b)], gaps)
        if ns:
            name = _name(spans, k)
            out[name] = out.get(name, 0.0) + ns / 1e9
    return out


def syncs_by_span(spans, syncs) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for m in syncs:
        name = _name(spans, m.span)
        out[name] = out.get(name, 0) + 1
    return out


def per_call(spans, syncs, events: Sequence[Interval], t0: int, t1: int
             ) -> Optional[dict]:
    """Per root span: the device idle inside it (ms), the syncs inside it,
    and the largest share of one root span no child span covers.  None
    where the window holds no root span."""
    roots = [k for k, s in enumerate(spans) if s.parent is None]
    if not roots:
        return None
    gaps = idle(events, t0, t1)
    inside = merged([(spans[k].start_ns, spans[k].end_ns or t1)
                     for k in roots], t0, t1)
    self_share = 0.0
    for k in roots:
        a, b = spans[k].start_ns, spans[k].end_ns or t1
        kids = merged([(s.start_ns, s.end_ns or t1) for s in spans
                       if s.parent == k], a, b)
        if b > a:
            self_share = max(self_share,
                             1.0 - sum(y - x for x, y in kids) / (b - a))
    return dict(calls=len(roots),
                idle_ms=overlap(inside, gaps) / 1e6 / len(roots),
                syncs=sum(m.span is not None for m in syncs) / len(roots),
                root_self_share_max=self_share)


def readings(spans, syncs, events: Sequence[Interval], t0: int, t1: int
             ) -> dict:
    return dict(window_s=(t1 - t0) / 1e9,
                idle_by_span=idle_by_span(spans, events, t0, t1),
                syncs_by_span=syncs_by_span(spans, syncs),
                per_call=per_call(spans, syncs, events, t0, t1))


def _recording_window(harness):
    """``harness.Profiled`` with the port's recorder on inside it and the
    window's ends and device events kept on the profiler's clock."""

    class Recorded(harness.Profiled):
        last = None

        def __enter__(self):
            from refign_tpu_torch.utils.profiling import Recorder
            super().__enter__()
            self.t0_ns = time.time_ns()
            self.rec = Recorder().start()
            Recorded.last = self
            return self

        def __exit__(self, *exc):
            import torch
            torch.cuda.synchronize()
            self.t1_ns = time.time_ns()
            self.rec.stop()
            return super().__exit__(*exc)

        def device_events_ns(self) -> List[Interval]:
            import torch
            cuda = torch.autograd.DeviceType.CUDA
            return [(e.start_ns(), e.end_ns())
                    for e in self.prof.profiler.kineto_results.events()
                    if e.device_type() == cuda]

    return Recorded


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness
    from benchmark import run as bench_run
    import torch
    man = harness.manifest()
    harness.require_cards(int(harness.workload(args.workload)["chips"]))
    ctx = bench_run.Context(args.workload, args.seed, 0.0, True,
                            torch.device("cuda", 0))
    plain, harness.Profiled = harness.Profiled, _recording_window(harness)
    try:
        line = bench_run.run(ctx, man)
        win = harness.Profiled.last
    finally:
        harness.Profiled = plain
    out = dict(workload=args.workload, seed=args.seed,
               correct=line["correct"], metrics=line["metrics"],
               device=line["device"])
    events = win.device_events_ns()
    out["device_events"] = len(events)
    out.update(readings(win.rec.spans, win.rec.syncs, events, win.t0_ns,
                        win.t1_ns))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
