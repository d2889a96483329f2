"""Driver of HRDA★ slide inference: ``entry.hrda_slide_forward`` of the
port on ``entry.build_hrda_star``, one frame at a time in a closed loop.

Traffic (the workload's ``traffic``): frames of ``height`` x ``width``,
each distinct, made on the device from the seed (normal draws, the
normalised scale).  A frame is timed from its call to its argmax label map
on the host, as ``SegTask.predict`` needs it.  ``check_frames`` frames,
drawn from the seed among the first ``check_within`` of the window, keep
their logits; once the window has closed, the plain reference computes
the same frames in fp32 and each frame's logits are compared:
``rel_rms`` = ||port - reference|| / ||reference||, ``max_rel`` = the
widest gap / the reference's largest magnitude (the worst frame of each).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness
from ..reference import build as ref_build
from ..reference.segformer import slide_inference

WARM_FRAMES = 2
WARM_BASE = 1 << 30      # frame indices of the warm-up, outside the window's


def _shape(ctx):
    t = ctx.cell["traffic"]
    return (ctx.overrides.get("height", t["height"]),
            ctx.overrides.get("width", t["width"]))


def _slide(ctx):
    inf = ctx.config["inference"]
    crop = ctx.overrides.get("crop", inf["crop"])
    stride = ctx.overrides.get("stride", inf["stride"])
    return tuple(crop), tuple(stride)


def frame(ctx, i: int) -> torch.Tensor:
    H, W = _shape(ctx)
    g = torch.Generator(device=ctx.device).manual_seed(
        harness.subseed(ctx.seed, 6, i))
    return torch.randn(1, H, W, 3, generator=g, device=ctx.device)


def checked_frames(ctx) -> list:
    t = ctx.cell["traffic"]
    rng = np.random.default_rng(harness.subseed(ctx.seed, 7))
    return sorted(int(i) for i in rng.choice(t["check_within"],
                                             t["check_frames"],
                                             replace=False))


def _student(ctx) -> dict:
    return ref_build.student_overrides(ctx.overrides)


def _weights(ctx) -> dict:
    m = ref_build.segmentor(ctx.config, False, "meta", _student(ctx))
    return harness.make_weights(harness.weight_spec(m),
                                harness.subseed(ctx.seed, 1), ctx.device)


def program(ctx):
    """The port's model with the weights made from the seed, and its call:
    a frame's logits."""
    from refign_tpu_torch import entry
    s = ctx.config["student"]
    dtype = getattr(torch, ctx.overrides.get("dtype",
                                             ctx.config["inference"]["dtype"]))
    model = entry.build_hrda_star(
        ctx.overrides.get("backbone", s["backbone"]),
        num_classes=s["num_classes"], dtype=dtype, device=ctx.device,
        channels=ctx.overrides.get("channels", s["channels"]))
    harness.load_weights(model, _weights(ctx))
    crop, stride = _slide(ctx)
    fwd = ctx.faults.get("forward", entry.hrda_slide_forward)
    return lambda x: fwd(model, x.to(dtype), crop, stride)


def reference_logits(ctx, frames, precision: str = "float32") -> dict:
    """The fp32 plain reference's logits of each frame index (TF32 off);
    ``precision`` 'float8': the control."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        m = ref_build.segmentor(ctx.config, False, ctx.device,
                                _student(ctx))
        harness.load_weights(m, _weights(ctx))
        m.eval().requires_grad_(False)
        crop, stride = _slide(ctx)
        out = {}
        for i in frames:
            x = frame(ctx, i).permute(0, 3, 1, 2)
            with torch.no_grad():
                if precision == "float8":
                    from ..reference.lowp import Float8Products
                    with Float8Products():
                        y = slide_inference(m.whole, x, crop, stride)
                else:
                    y = slide_inference(m.whole, x, crop, stride)
            out[i] = y.permute(0, 2, 3, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    return out


def compare(got: dict, ref: dict, limits: dict) -> list:
    rms, mx = 0.0, 0.0
    for i, r in ref.items():
        g = got[i].float()
        r = r.float()
        d = g - r
        rms = max(rms, float(d.norm() / r.norm()))
        mx = max(mx, float(d.abs().max() / r.abs().max()))
    return [("rel_rms", rms, limits["rel_rms"]),
            ("max_rel", mx, limits["max_rel"])]


def run(ctx) -> dict:
    dev = ctx.device
    call = program(ctx)
    keep = checked_frames(ctx)
    for i in range(WARM_FRAMES):   # the warm-up frames are not the window's
        call(frame(ctx, WARM_BASE + i)).argmax(-1).to(torch.uint8).cpu()
    harness.settle()
    harness.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    win = harness.Window()
    kept = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def one(i):
        t0 = time.perf_counter()
        logits = call(frame(ctx, i))
        labels = logits.argmax(-1).to(torch.uint8).cpu()
        win.latencies_ms.append(1e3 * (time.perf_counter() - t0))
        if i in keep:
            kept[i] = logits
        del labels
        win.calls += 1
        win.units += 1
        win.kinds["frame"] = win.kinds.get("frame", 0) + 1

    events = None
    if ctx.trace:
        with harness.Profiled(harness.kernel_families()) as prof:
            for i in range(ctx.cell["trace_steps"]):
                one(i)
        win.seconds = prof.window_s
        events = prof.events()
    else:
        harness.sync(dev)
        t0 = time.perf_counter()
        i = 0
        while True:
            one(i)
            i += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        win.seconds = time.perf_counter() - t0
    win.peak_bytes = (int(torch.cuda.max_memory_allocated())
                      if dev.type == "cuda" else 0)
    device = harness.device_info(ctx.chips)
    device["memory_peak_bytes"] = win.peak_bytes
    # frames due in the window that it did not reach are run now
    for i in keep:
        if i not in kept:
            kept[i] = call(frame(ctx, i)).clone()
    del call
    harness.free(dev)

    ref = reference_logits(ctx, keep)
    checks = compare(kept, ref, ctx.cell["limits"])
    trace, notes = None, []
    if ctx.trace:
        trace = harness.Trace(events, win.seconds, win, ctx.cell, flops(ctx),
                              harness.kernel_families(), prof.launches)
        notes = harness.kernel_notes(trace)
    return dict(setup_s=setup_s, window=win, device=device, checks=checks,
                trace=trace, notes=notes)


def control(ctx) -> dict:
    """The control (the reference in float8) against the fp32 reference."""
    keep = checked_frames(ctx)
    ref = reference_logits(ctx, keep)
    low = reference_logits(ctx, keep, "float8")
    return {"float8": compare(low, ref, ctx.cell["limits"])}


def flops(ctx) -> dict:
    """Model operations of one frame's forward."""
    from .. import flops as fl
    m = ref_build.segmentor(ctx.config, False, "meta", _student(ctx)).eval()
    H, W = _shape(ctx)
    crop, stride = _slide(ctx)

    def fwd():
        with torch.no_grad():
            slide_inference(m.whole, torch.empty(1, 3, H, W, device="meta"),
                            crop, stride)
    return {"frame": fl.count(fwd)}
