"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell's file
``benchmark/workloads/<cell>.json`` names its configuration and driver; the manifest ``BENCHMARK.json`` names
the metrics it reports.  With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profiler window of device activity held in memory.  The last line of
standard output is one JSON object; the numbers compared to decide
``correct`` are printed last on standard error and under ``checks``.

``--check control`` (never passed by a benchmark run) prints instead the
compared numbers of the control (the reference in float8 in the port's
place) and of the planted faults, for setting the limits.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of a run inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(ROOT, "build", "bench_cache", _sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class Context:
    """What a driver reads of a run."""

    def __init__(self, cell_name: str, seed: int, seconds: float,
                 trace: bool, device, overrides=None, faults=None):
        from benchmark import harness
        self.name = cell_name
        self.cell = harness.workload(cell_name)
        self.config = harness.config(self.cell["config"])
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.chips = int(self.cell["chips"])
        self.device = device
        self.overrides = dict(overrides or {})
        self.faults = dict(faults or {})
        self.t_start = T_START


def metrics_of(man: dict, ctx, res: dict) -> dict:
    """Each metric of the cell, read by its own reader; a reader that finds
    nothing returns None and the metric is left out."""
    from benchmark import harness
    kind = "per_layer" if ctx.trace else "end_to_end"
    out = {}
    for m in harness.cell_metrics(man, ctx.name, kind):
        value = harness.metric_reader(m["name"])(res)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(ctx, man: dict) -> dict:
    """One run: the cell driver's window and check, then the line's pieces."""
    from benchmark import harness
    res = harness.driver(ctx.cell["driver"]).run(ctx)
    metrics = metrics_of(man, ctx, res)
    breakdown = None
    if ctx.trace and res["trace"] is not None:
        breakdown = {"device_ops": res["trace"].top_ops(),
                     "idle_gaps": res["trace"].idle_gaps()}
        res["device"]["busy_s"] = res["trace"].busy_s()
        res["device"]["window_s"] = res["trace"].window_s
    checks = res["checks"]
    correct = all(v == v and v <= lim for _, v, lim in checks)
    return dict(correct=correct, attempted=res["window"].calls,
                notes=res.get("notes", []),
                failed=res.get("failed", 0), metrics=metrics,
                device=res["device"], checks=checks, breakdown=breakdown)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--check", choices=("control",), default=None)
    args = ap.parse_args(argv)

    from benchmark import harness
    man = harness.manifest()
    cell = harness.workload(args.workload)
    harness.require_cards(int(cell["chips"]))
    import torch
    ctx = Context(args.workload, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0))
    if args.check == "control":
        drv = harness.driver(cell["driver"])
        out = drv.control(ctx)
        print(json.dumps({"control": out, "seed": args.seed}))
        return 0
    line = run(ctx, man)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: modules that may not load in a run were loaded: "
              f"{found}; no result", file=sys.stderr)
        return 4
    for text in line.pop("notes"):
        print(text, file=sys.stderr)
    for text in harness.check_lines(line["checks"]):
        print(text, file=sys.stderr)
    print(harness.result_line(**line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
