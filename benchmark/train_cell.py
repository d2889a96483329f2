"""A training cell: set-up builds the port's trainer once, loads the
weights made from the seed and drives its first three steps through the
window's own call (they warm up every shape and give the readings that
decide ``correct``); the same object then runs the timed window; once the
window has closed and the port's state is freed, the plain reference
follows the same three steps from the same weights, batches and draws.

Compared, each against its limit in the workload file:
``loss``: the widest relative gap of a step's total loss over the three
steps; ``grad``: the first gradient as the optimizer holds it after one
step (Adam's first moment / (1 - beta1)), by the worst leaf;
``change``: each leaf's change over the three steps, by the worst leaf,
leaving out leaves whose reference gradient is under a thousandth of the
median leaf's (they move by round-off alone); and, where the step keeps
one, ``ema``: the EMA teacher's change, by the worst leaf.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional

from . import harness

STEPS_COMPARED = 3


class Side:
    """One trainer, the port's or the reference's, driven step by step.

    ``step(i)`` takes step i (its batch and draws made from the seed) and
    returns its logs as 0-d tensors; ``leaves()`` the trained tensors by
    name (parameters and BatchNorm statistics); ``ema()`` the teacher's,
    or None; ``optimizer`` and ``named_params`` give the first moment."""

    def __init__(self, step: Callable[[int], dict], leaves: Callable,
                 optimizer, named_params: Callable, ema: Callable = None):
        self.step, self.leaves, self.ema = step, leaves, ema
        self.optimizer, self.named_params = optimizer, named_params


def to_port(obj, classes: dict):
    """A dataclass of the benchmark's draw code rebuilt as the port's class
    of the same name (the port's step takes its own classes)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = classes[type(obj).__name__]
        return cls(**{f.name: to_port(getattr(obj, f.name), classes)
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, list):
        return [to_port(x, classes) for x in obj]
    if isinstance(obj, tuple):
        return tuple(to_port(x, classes) for x in obj)
    return obj


def leaves(module, trainable: bool = True) -> dict:
    """Parameters (the trainable ones only, where ``trainable``) and
    floating buffers, by name."""
    out = {n: p for n, p in module.named_parameters()
           if p.requires_grad or not trainable}
    out.update({n: b for n, b in module.named_buffers()
                if b.is_floating_point()})
    return out


def first_moment_norms(side: Side) -> Dict[str, float]:
    """The gradient each leaf gave the optimizer's first update, from its
    state: exp_avg / (1 - beta1); 0 for a leaf it has no state of."""
    import torch
    out = {}
    for name, p in side.named_params():
        st = side.optimizer.state.get(p, {})
        group = next(g for g in side.optimizer.param_groups
                     if any(q is p for q in g["params"]))
        beta1 = group["betas"][0]
        m = st.get("exp_avg")
        out[name] = (0.0 if m is None
                     else float(torch.linalg.vector_norm(m.float()))
                     / (1.0 - beta1))
    return out


def readings(side: Side, device) -> dict:
    """Drive steps 0-2 and read what is compared."""
    import torch
    with torch.no_grad():
        p0 = {k: v.detach().float().clone() for k, v in side.leaves().items()}
        e0 = (None if side.ema is None else
              {k: v.detach().float().clone() for k, v in side.ema().items()})
    losses, grads = [], None
    for i in range(STEPS_COMPARED):
        logs = side.step(i)
        losses.append({k: float(v) for k, v in logs.items()})
        if i == 0:
            grads = first_moment_norms(side)
    harness.sync(device)

    def change(now, before):
        with torch.no_grad():
            return {k: float(torch.linalg.vector_norm(
                v.detach().float() - before[k])) for k, v in now.items()}

    out = dict(losses=losses, grads=grads, change=change(side.leaves(), p0))
    if e0 is not None:
        out["ema"] = change(side.ema(), e0)
    del p0, e0
    return out


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap between the two norms, against the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    names = list(ref) if keep is None else list(keep)
    med = statistics.median(ref[k] for k in names)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}


def compare(got: dict, ref: dict, limits: dict, loss_key: str,
            notes: Optional[list] = None) -> list:
    """The compared numbers, each with its limit.  A leaf number is the
    worst leaf's gap, or, where the workload's limit is named
    ``<number>_median``, the median leaf's (see PERF.md for why).
    ``notes`` gets the worst and median leaf of each, for the record."""
    loss = max(abs(g[loss_key] - r[loss_key]) / max(abs(r[loss_key]), 1e-30)
               for g, r in zip(got["losses"], ref["losses"]))
    # a number the workload gives no limit is read, not compared
    checks = [("loss", loss, limits["loss"])] if "loss" in limits else []
    if notes is not None:
        notes += [f"step {i} logs: port {g}; reference {r}"
                  for i, (g, r) in enumerate(zip(got["losses"],
                                                 ref["losses"]))]
        notes.append(f"loss: {loss!r}")
    grads = ref["grads"]
    med = statistics.median(v for v in grads.values() if v > 0)
    # leaves whose reference gradient is under a thousandth of the median
    # leaf's move by round-off alone; buffers (no gradient) stay
    moved = [k for k in ref["change"]
             if k not in grads or grads[k] >= 1e-3 * med]
    for name, keep in (("grad", [k for k in grads if grads[k] > 0]),
                       ("change", moved), ("ema", moved)):
        src = "grads" if name == "grad" else name
        if src not in ref:
            continue
        gaps = leaf_gaps(got[src], ref[src], keep)
        worst = max(gaps, key=gaps.get)
        median = statistics.median(gaps.values())
        if notes is not None:
            notes.append(f"{name}: worst leaf {worst} {gaps[worst]!r} "
                         f"(port {got[src][worst]!r}, reference "
                         f"{ref[src][worst]!r}); median leaf {median!r}; "
                         f"{len(gaps)} leaves")
        if f"{name}_median" in limits:
            checks.append((f"{name}_median", median,
                           limits[f"{name}_median"]))
        else:
            checks.append((name, gaps[worst], limits[name]))
    return checks


def run(ctx, cell) -> dict:
    """One run of a training cell.  ``cell`` (a driver) gives
    ``program(ctx)`` and ``reference(ctx, half)``, both :class:`Side`;
    ``kind(ctx, i)`` names step i's kind; ``LOSS_KEY`` the compared loss;
    and ``flops(ctx)`` the model operations of a step of each kind."""
    import torch
    dev = ctx.device
    prog = cell.program(ctx)
    got = readings(prog, dev)
    harness.settle()
    harness.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    win = harness.Window()
    trace = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    i = STEPS_COMPARED

    def one():
        nonlocal i
        kind = cell.kind(ctx, i)
        t0 = time.perf_counter()
        prog.step(i)
        win.latencies_ms.append(1e3 * (time.perf_counter() - t0))
        win.kinds[kind] = win.kinds.get(kind, 0) + 1
        win.calls += 1
        win.units += ctx.cell["traffic"]["batch"]
        i += 1

    if ctx.trace:
        with harness.Profiled(harness.kernel_families()) as prof:
            for _ in range(ctx.cell["trace_steps"]):
                one()
        win.seconds = prof.window_s
        events = prof.events()
    else:
        harness.sync(dev)
        t0 = time.perf_counter()
        while True:
            one()
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        harness.sync(dev)
        win.seconds = time.perf_counter() - t0
    win.peak_bytes = (int(torch.cuda.max_memory_allocated())
                      if dev.type == "cuda" else 0)
    device = harness.device_info(ctx.chips)
    device["memory_peak_bytes"] = win.peak_bytes
    del prog
    harness.free(dev)

    ref = reference_readings(ctx, cell, "float32")
    lat = sorted(win.latencies_ms)
    notes = [f"step host ms: min {lat[0]:.1f} median "
             f"{statistics.median(lat):.1f} max {lat[-1]:.1f} "
             f"({len(lat)} steps)"]
    checks = compare(got, ref, ctx.cell["limits"], cell.LOSS_KEY, notes)
    if ctx.trace:
        trace = harness.Trace(events, win.seconds, win, ctx.cell,
                              cell.flops(ctx), harness.kernel_families(),
                              prof.launches)
        notes += harness.kernel_notes(trace)
    return dict(setup_s=setup_s, window=win, device=device, checks=checks,
                trace=trace, notes=notes)


def reference_readings(ctx, cell, precision: str, half: bool = False
                       ) -> dict:
    """The reference's readings of steps 0-2 in ``precision`` ('float32',
    or 'float8': the control), with TF32 off; ``half``: every step on the
    first half of its batch (a fault)."""
    import torch
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        side = cell.reference(ctx, half=half)
        if precision == "float8":
            from .reference.lowp import Float8Products
            with Float8Products():
                out = readings(side, ctx.device)
        else:
            out = readings(side, ctx.device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    del side
    harness.free(ctx.device)
    return out


def control(ctx, cell, modes: List[str]) -> Dict[str, list]:
    """The compared numbers of the reference put in the port's place, in
    each of ``modes`` ('float8': the control; 'half': half of each batch
    left out), against the fp32 reference."""
    ref = reference_readings(ctx, cell, "float32")
    out = {}
    for mode in modes:
        got = (reference_readings(ctx, cell, "float8") if mode == "float8"
               else reference_readings(ctx, cell, "float32", half=True))
        notes = []
        out[mode] = compare(got, ref, ctx.cell["limits"], cell.LOSS_KEY,
                            notes)
        out[mode + "_notes"] = notes
    return out
