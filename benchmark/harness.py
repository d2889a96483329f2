"""What every cell of the benchmark shares: the manifest and the files it
names, seeds, weights made on the device, the profiler window and its
reading, the check of the port's outputs, and the result line.

Everything a cell owns sits in files of its own, found by name:
``configs/<config>.json`` (the model's settings), ``workloads/<cell>.json``
(its configuration, driver, traffic parameters, kernel shapes and limits),
``drivers/<kind>.py`` (the code that drives one kind of entry point) and
``metrics/<metric>.py`` (one reader per metric).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

# modules that may not be loaded in a run, compared by top-level name whole
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "refign_tpu")


# ---------------------------------------------------------------------------
# the manifest and the files it names
# ---------------------------------------------------------------------------

def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json"))


def config(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metric_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py`` (names hold dots, so the file is
    loaded by path)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_families() -> dict:
    """``kernels/<family>.json``: the names the port's hand-written kernels
    have in a device trace (``patterns``) and the port's count of the calls
    that launch them (``counter``: module:function, whose ``launches``
    counts them), by kernel family."""
    d = os.path.join(BENCH_DIR, "kernels")
    return {"families": {f[:-5]: load_json(os.path.join(d, f))
                         for f in sorted(os.listdir(d))
                         if f.endswith(".json")}}


def kernel_launches(kernels: dict) -> Dict[str, int]:
    """The port's launch counters of each kernel family (0 where its
    module is not loaded)."""
    out = {}
    for fam, spec in kernels["families"].items():
        mod, fn = spec["counter"].split(":")
        m = sys.modules.get(mod)
        out[fam] = int(getattr(getattr(m, fn), "launches", 0)) if m else 0
    return out


def cell_metrics(man: dict, cell: str, kind: str) -> List[dict]:
    """The manifest's ``end_to_end`` or ``per_layer`` metrics this cell
    reports: those that list it, and those that list no cells."""
    return [m for m in man[kind]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# seeds
# ---------------------------------------------------------------------------

def subseed(seed: int, *stream: int) -> int:
    """A 63-bit seed of its own for each stream of a run's seed."""
    words = np.random.SeedSequence([int(seed) % (1 << 64), *stream]) \
        .generate_state(2, dtype=np.uint32)
    return int(words[0]) << 31 | int(words[1]) >> 1


# ---------------------------------------------------------------------------
# weights made on the device from the seed
# ---------------------------------------------------------------------------

def make_weights(spec: Sequence[Tuple[str, Tuple[int, ...]]], seed: int,
                 device) -> Dict[str, "torch.Tensor"]:
    """fp32 tensors for ``spec`` (name, shape), from one normal draw on the
    device: weights of two or more axes N(0, 2 / fan_in), 1-d ``weight``
    (norm scales) 1 + N(0, 0.05^2), biases N(0, 0.02^2), BatchNorm running
    means 0 and variances 1."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(int(np.prod(s)) for _, s in spec)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in spec:
        n = int(np.prod(shape))
        x = flat[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_mean":
            x = torch.zeros_like(x)
        elif leaf == "running_var":
            x = torch.ones_like(x)
        elif len(shape) >= 2:
            x = x * float(np.sqrt(2.0 / np.prod(shape[1:])))
        elif leaf == "weight":
            x = 1.0 + 0.05 * x
        else:
            x = 0.02 * x
        out[name] = x
    return out


def weight_spec(module) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every floating parameter and buffer of a module,
    in its state-dict order."""
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()
            if v.is_floating_point()]


def load_weights(module, weights: Dict[str, "torch.Tensor"],
                 prefix: str = "") -> None:
    """Copy ``weights`` (names under ``prefix``) into every floating
    tensor of ``module``'s state, in its own dtype; every one must be
    there."""
    sd = module.state_dict()
    missing = [k for k, v in sd.items()
               if v.is_floating_point() and prefix + k not in weights]
    if missing:
        raise KeyError(f"no weights made for {missing[:5]} ...")
    import torch
    with torch.no_grad():
        for k, v in sd.items():
            if v.is_floating_point():
                v.copy_(weights[prefix + k])


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

def require_cards(n: int) -> None:
    """Exit 3, printing no result, unless CUDA has ``n`` cards."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: this cell needs {n} CUDA device(s), found "
              f"{found}; no result", file=sys.stderr)
        sys.exit(3)


def device_info(count: int) -> dict:
    import torch
    if torch.cuda.is_available():
        return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                    count=count,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
    return dict(platform="cpu", kind="cpu", count=count, memory_peak_bytes=0)


def settle() -> None:
    """Before a window: collect, then keep what set-up made out of later
    collections, so the window's collections walk only its own objects."""
    gc.collect()
    gc.freeze()


def free(device) -> None:
    """Return what freed tensors held to the device."""
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the timed window and its trace
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Window:
    """What a cell's timed window did: its work and the host-clock time."""
    seconds: float = 0.0
    units: int = 0                     # rows trained or frames served
    calls: int = 0                     # steps or frames
    kinds: Dict[str, int] = dataclasses.field(default_factory=dict)
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    peak_bytes: int = 0


@dataclasses.dataclass
class Trace:
    """The device's activity in a traced window: each event (name, start,
    end in seconds from the window's start), the window's length, and what
    the window did."""
    events: List[Tuple[str, float, float]]
    window_s: float
    window: Window
    cell: dict
    flops: Dict[str, float]
    kernels: dict
    launches: Dict[str, int]      # the port's calls of each kernel family

    def busy_s(self) -> float:
        """The union of the device intervals (``busy_share``'s
        arithmetic)."""
        busy, end = 0.0, None
        for _, a, b in sorted(self.events, key=lambda e: e[1]):
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy

    def is_kernel(self, name: str) -> bool:
        """Whether an event is one of the port's hand-written kernels."""
        return any(p in name for fam in self.kernels["families"].values()
                   for p in fam["patterns"])

    def family_s(self, family: str) -> float:
        pats = self.kernels["families"][family]["patterns"]
        return sum(b - a for n, a, b in self.events
                   if any(p in n for p in pats))

    def family_events(self, family: str) -> int:
        pats = self.kernels["families"][family]["patterns"]
        return sum(1 for n, _, _ in self.events if any(p in n for p in pats))

    def expected_calls(self) -> Dict[str, int]:
        """Each family's calls by the cell's ``kernel_calls`` table: the
        calls of each kind of step times the steps of that kind."""
        out = {f: 0 for f in self.kernels["families"]}
        for kind, n in self.window.kinds.items():
            for c in self.cell["kernel_calls"].get(kind, []):
                out[c["kernel"]] += n * c["calls"]
        return out

    def kernel_count_faults(self) -> List[str]:
        """Where the table the kernel bounds are summed over does not
        describe the window: a family whose calls by the port's counter
        differ from the table's, or whose trace holds fewer kernel events
        than calls (each call launches one or more)."""
        faults = []
        for fam, want in self.expected_calls().items():
            got = self.launches.get(fam, 0)
            seen = self.family_events(fam)
            if got != want or seen < got:
                faults.append(f"{fam}: table {want} calls, port counted "
                              f"{got}, trace {seen} kernel events")
        return faults

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, float] = {}
        for name, a, b in self.events:
            total[name] = total.get(name, 0.0) + (b - a)
        return [[k[:200], v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest idle gaps, each named by the device operation the
        card waited for (what the host was still launching)."""
        gaps, end = [], 0.0
        for name, a, b in sorted(self.events, key=lambda e: e[1]):
            if a > end:
                gaps.append([f"before {name[:180]}", a - end])
            end = max(end, b)
        if self.window_s > end:
            gaps.append(["after the last operation", self.window_s - end])
        return sorted(gaps, key=lambda g: -g[1])[:n]


def kernel_notes(trace: Trace) -> List[str]:
    """A line for the record: each family's calls by the table, by the
    port's counter and kernel events in the trace, and any mismatch."""
    want = trace.expected_calls()
    line = "; ".join(f"{f} {want[f]}/{trace.launches.get(f, 0)}/"
                     f"{trace.family_events(f)}" for f in sorted(want))
    faults = trace.kernel_count_faults()
    return [f"kernel calls (table/counter/events): {line}"] + [
        f"kernel table does not describe the window, roofline left out: {f}"
        for f in faults]


class Profiled:
    """A profiler window of device activity only: host-side tracing of the
    ~100k operations of a training step would lengthen the window it
    measures.  Events are read in memory; no trace file is written.  The
    port's kernel launch counters are read at both ends (``launches``)."""

    def __init__(self, kernels: dict):
        self.kernels = kernels

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.counted = kernel_launches(self.kernels)
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        now = kernel_launches(self.kernels)
        self.launches = {f: now[f] - self.counted[f] for f in now}

    def events(self) -> List[Tuple[str, float, float]]:
        import torch
        evs = [(e.name, e.time_range.start, e.time_range.end)
               for e in self.prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if not evs:
            return []
        t0 = min(a for _, a, _ in evs)
        return [(n, (a - t0) / 1e6, (b - t0) / 1e6) for n, a, b in evs]


# ---------------------------------------------------------------------------
# the comparison that decides ``correct``
# ---------------------------------------------------------------------------

def check_lines(checks: Sequence[Tuple[str, float, float]]) -> List[str]:
    return [f"check {name}: {value!r} (limit {limit!r})"
            for name, value, limit in checks]


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                checks: Sequence[Tuple[str, float, float]],
                breakdown: Optional[dict] = None) -> str:
    out = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed), metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in checks}
    return json.dumps(out)
