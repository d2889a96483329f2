"""Driver of the UAWarpC train step: ``alignment.trainer.train_step`` of the
port on ``entry.build_align_trainer(stage)``.

Traffic (the workload's ``traffic``): ``batch`` uint8 image pairs of
``size``^2, new for every step, made on the device from the seed: smooth
random scenes (bicubic upsampling of ``scene_grid``^2 noise plus
``pixel_noise``), the reference the target rolled by ``ref_shift`` pixels
plus ``ref_noise``, mapped to bytes by ``scale`` and ``offset``.  The
step's draws (the prime coins, its photometric draws, the synthetic
flows) are the benchmark's own (``benchmark/draws.py``), from a host
generator of the seed.
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from .. import draws as bench_draws
from .. import harness, train_cell
from ..reference import build as ref_build

LOSS_KEY = "train_matching_loss"


def kind(ctx, i: int) -> str:
    return "step"


def _size(ctx):
    t = ctx.cell["traffic"]
    return t["batch"], ctx.overrides.get("size", t["size"])


def batch(ctx, i: int, rows=None) -> dict:
    t = ctx.cell["traffic"]
    B, S = _size(ctx)
    dev = ctx.device
    g = torch.Generator(device=dev).manual_seed(
        harness.subseed(ctx.seed, 3, i))
    n = t["scene_grid"]
    low = torch.randn(B, 3, n, n, generator=g, device=dev)
    trg = F.interpolate(low, (S, S), mode="bicubic", align_corners=False)
    trg = trg + t["pixel_noise"] * torch.randn(B, 3, S, S, generator=g,
                                               device=dev)
    ref = trg.roll(tuple(t["ref_shift"]), dims=(2, 3)) + t["ref_noise"] * \
        torch.randn(B, 3, S, S, generator=g, device=dev)

    def u8(x):
        return ((x.permute(0, 2, 3, 1) * t["scale"] + t["offset"])
                .clamp(0, 255).to(torch.uint8))
    out = dict(image_ref=u8(ref), image_trg=u8(trg))
    if rows is not None:
        out = {k: v[:rows] for k, v in out.items()}
    return out


def _config(ctx) -> dict:
    """The configuration with a test's smaller crop."""
    c = dict(ctx.config, align=dict(ctx.config["align"]))
    if "crop" in ctx.overrides:
        c["align"]["crop_after_flow"] = [ctx.overrides["crop"]] * 2
    return c


def draws(ctx, i: int, rows=None) -> bench_draws.AlignDraws:
    """Step i's draws (``benchmark/draws.py``)."""
    B, _ = _size(ctx)
    gen = torch.Generator().manual_seed(harness.subseed(ctx.seed, 4, i))
    d = bench_draws.draw_align(ctx.config["align"], B, gen)
    return d if rows is None else d.first(rows)


def _weights(ctx):
    """The frozen VGG's and the head's weights, made from the seed."""
    meta = ref_build.align_trainer(ctx.config, "meta", ctx.overrides.get("vgg"))
    return (harness.make_weights(harness.weight_spec(meta.backbone),
                                 harness.subseed(ctx.seed, 1), ctx.device),
            harness.make_weights(harness.weight_spec(meta.head),
                                 harness.subseed(ctx.seed, 5), ctx.device))


def _side(step_fn, head, optimizer) -> train_cell.Side:
    return train_cell.Side(
        step=step_fn, leaves=lambda: train_cell.leaves(head),
        optimizer=optimizer, named_params=lambda: list(head.named_parameters()))


def program(ctx) -> train_cell.Side:
    """The port's trainer, weights from the seed, driven by the port's own
    ``train_step``."""
    import dataclasses
    from refign_tpu_torch import entry
    from refign_tpu_torch.alignment import synthetic_flows as port_flows
    from refign_tpu_torch.alignment import trainer as port_trainer
    from refign_tpu_torch.uda import dacs as port_dacs
    stage = ctx.cell["traffic"].get("stage", 1)
    cfg = entry.ALIGN_STAGES[stage][0]
    over = {}
    if "crop" in ctx.overrides:
        over["crop_after_flow"] = (ctx.overrides["crop"],) * 2
    if "compute_dtype" in ctx.overrides:
        over["compute_dtype"] = ctx.overrides["compute_dtype"]
    cfg = dataclasses.replace(cfg, **over)
    tr = entry.build_align_trainer(
        stage, ctx.overrides.get("vgg", ctx.config["backbone"]["name"]),
        cfg=cfg, device=ctx.device)
    w_b, w_h = _weights(ctx)
    harness.load_weights(tr.state.backbone, w_b)
    harness.load_weights(tr.state.head, w_h)
    classes = {"AlignDraws": port_trainer.AlignDraws,
               "PrimeDraws": port_trainer.PrimeDraws,
               "FlowDraws": port_flows.FlowDraws,
               "JitterFactors": port_dacs.JitterFactors}
    step = ctx.faults.get("step", port_trainer.train_step)

    def step_fn(i):
        return step(tr, batch(ctx, i),
                    train_cell.to_port(draws(ctx, i), classes))
    return _side(step_fn, tr.state.head, tr.state.optimizer)


def reference(ctx, half: bool = False) -> train_cell.Side:
    """The plain reference's trainer in fp32 from the same weights, batches
    and draws; ``half``: each step on the first half of its batch."""
    tr = ref_build.align_trainer(_config(ctx), ctx.device,
                                 ctx.overrides.get("vgg"))
    w_b, w_h = _weights(ctx)
    harness.load_weights(tr.backbone, w_b)
    harness.load_weights(tr.head, w_h)
    rows = ctx.cell["traffic"]["batch"] // 2 if half else None

    def step_fn(i):
        return tr.step(batch(ctx, i, rows), draws(ctx, i, rows))
    return _side(step_fn, tr.head, tr.opt)


def flops(ctx) -> dict:
    """Model operations of a step: the frozen VGG's forward on the three
    image sets at the crop and at 256^2, and three head passes forward
    and backward."""
    from .. import flops as fl
    from ..reference.uawarpc import pyramids
    B, _ = _size(ctx)
    H, W = _config(ctx)["align"]["crop_after_flow"]
    tr = ref_build.align_trainer(_config(ctx), "meta",
                                 ctx.overrides.get("vgg"))
    x = torch.empty(B, 3, H, W, device="meta")

    def step():
        with torch.no_grad():
            p, q = pyramids(tr.backbone, [x, x, x])
        for _ in range(3):
            fl.backward_of(tr.head(list(p[0]), list(p[1]), list(q[0]),
                                   list(q[1]), (H, W)))
    return {"step": fl.count(step)}


def run(ctx) -> dict:
    return train_cell.run(ctx, sys.modules[__name__])


def control(ctx) -> dict:
    return train_cell.control(ctx, sys.modules[__name__], ["float8", "half"])
