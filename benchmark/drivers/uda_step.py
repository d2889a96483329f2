"""Driver of the Refign UDA train step: ``uda.trainer.train_step`` of the
port on ``entry.build_uda_trainer``, as ``SegTask.fit`` drives it.

Traffic (the workload's ``traffic``): ``batch`` rows of ``size``^2 source,
target and reference images (normal draws; the reference is
``ref_mix`` x the target shifted by ``ref_shift`` pixels plus
``ref_noise`` x noise, so the warp has structure to find) and source labels
of ``label_block``-pixel blocks with the top ``ignore_rows`` rows ignored,
all made on the device from the seed, new for every step.  The step's
draws are the benchmark's own (``benchmark/draws.py``), from a host
generator of the seed; the adapt-to-reference coin is replaced by
``kinds``: each block of ``len(kinds)`` steps runs each kind once, in an
order drawn from the seed, so every seed runs the same mix of align and
ref-as-target steps.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from .. import draws as bench_draws
from .. import harness, train_cell
from ..reference import build as ref_build

LOSS_KEY = "train_loss_total"


def kind(ctx, i: int) -> str:
    """Step i's kind.  The blocks are aligned on the window's first step
    (the steps before it are the three compared), so every window, traced
    or not, runs whole blocks from its start."""
    kinds = list(ctx.cell["traffic"]["kinds"])
    n = len(kinds)
    at = i + (-train_cell.STEPS_COMPARED) % n
    order = np.random.default_rng(
        harness.subseed(ctx.seed, 2, at // n)).permutation(n)
    return kinds[int(order[at % n])]


def _size(ctx):
    t = ctx.cell["traffic"]
    return t["batch"], ctx.overrides.get("size", t["size"])


def batch(ctx, i: int, rows=None) -> dict:
    t = ctx.cell["traffic"]
    B, S = _size(ctx)
    dev = ctx.device
    g = torch.Generator(device=dev).manual_seed(
        harness.subseed(ctx.seed, 3, i))
    trg = torch.randn(B, S, S, 3, generator=g, device=dev)
    ref = (t["ref_mix"] * trg.roll(t["ref_shift"], dims=2)
           + t["ref_noise"] * torch.randn(B, S, S, 3, generator=g, device=dev))
    src = torch.randn(B, S, S, 3, generator=g, device=dev)
    blk = min(t["label_block"], S)
    blocks = torch.randint(0, ctx.config["uda"]["num_classes"],
                           (B, S // blk, S // blk), generator=g, device=dev)
    sem = blocks.repeat_interleave(blk, 1).repeat_interleave(blk, 2)
    sem[:, :t["ignore_rows"]] = 255
    out = dict(image_src=src, image_trg=trg, image_ref=ref, semantic_src=sem)
    if rows is not None:
        out = {k: v[:rows] for k, v in out.items()}
    return out


def draws(ctx, i: int) -> bench_draws.StepDraws:
    """Step i's draws (``benchmark/draws.py``), with its kind."""
    B, S = _size(ctx)
    gen = torch.Generator().manual_seed(harness.subseed(ctx.seed, 4, i))
    d = bench_draws.draw_step(ctx.config["uda"], B, S, S, gen)
    d.use_ref_as_target = kind(ctx, i) == "ref_as_target"
    return d


def _weights(ctx):
    """The student's and the align net's weights, made from the seed."""
    s = ref_build.segmentor(ctx.config, True, "meta",
                            ref_build.student_overrides(ctx.overrides))
    a = ref_build.alignment_net(ctx.config, "meta")
    return (harness.make_weights(harness.weight_spec(s),
                                 harness.subseed(ctx.seed, 1), ctx.device),
            harness.make_weights(harness.weight_spec(a),
                                 harness.subseed(ctx.seed, 5), ctx.device))


def _side(step_fn, student, teacher, optimizer) -> train_cell.Side:
    return train_cell.Side(
        step=step_fn, leaves=lambda: train_cell.leaves(student),
        optimizer=optimizer,
        named_params=lambda: [(n, p) for n, p in student.named_parameters()
                              if p.requires_grad],
        ema=lambda: train_cell.leaves(teacher, trainable=False))


def program(ctx) -> train_cell.Side:
    """The port's trainer, weights from the seed, driven by the port's own
    ``train_step``."""
    from refign_tpu_torch import entry
    from refign_tpu_torch.uda import dacs as port_dacs
    from refign_tpu_torch.uda import trainer as port_trainer
    c = ctx.config
    cfg = entry.REFIGN_HRDA_STAR
    if "compute_dtype" in ctx.overrides:
        cfg = dataclasses.replace(cfg,
                                  compute_dtype=ctx.overrides["compute_dtype"])
    tr = entry.build_uda_trainer(
        ctx.overrides.get("backbone", c["student"]["backbone"]), cfg=cfg,
        device=ctx.device,
        channels=ctx.overrides.get("channels", c["student"]["channels"]),
        max_steps=c["optimizer"]["max_steps"],
        warmup_iters=c["optimizer"]["warmup_iters"])
    w, a = _weights(ctx)
    st = tr.state
    for m in (st.student, st.teacher):
        harness.load_weights(m, w)
    harness.load_weights(st.imnet, w, prefix="backbone.")
    harness.load_weights(tr.align_net, a)
    classes = {"StepDraws": port_trainer.StepDraws,
               "DACSDraws": port_dacs.DACSDraws,
               "JitterFactors": port_dacs.JitterFactors}
    step = ctx.faults.get("step", port_trainer.train_step)

    def step_fn(i):
        return step(tr, batch(ctx, i),
                    train_cell.to_port(draws(ctx, i), classes))
    return _side(step_fn, st.student, st.teacher, st.optimizer)


def reference(ctx, half: bool = False) -> train_cell.Side:
    """The plain reference's trainer in fp32 from the same weights, batches
    and draws; ``half``: each step on the first half of its batch."""
    tr = ref_build.uda_trainer(ctx.config, ctx.device,
                               ref_build.student_overrides(ctx.overrides))
    w, a = _weights(ctx)
    for m in (tr.student, tr.teacher):
        harness.load_weights(m, w)
    harness.load_weights(tr.imnet, w, prefix="backbone.")
    harness.load_weights(tr.align, a)
    rows = ctx.cell["traffic"]["batch"] // 2 if half else None

    def step_fn(i):
        d = draws(ctx, i)
        if half:
            d.dacs = d.dacs.rows(slice(0, rows))
        return tr.step(batch(ctx, i, rows), d)
    return _side(step_fn, tr.student, tr.teacher, tr.opt)


def flops(ctx) -> dict:
    """Model operations of a step of each kind: the teacher's forward (the
    target and the reference on align steps, the reference alone
    otherwise), the ImageNet copy's forward at half size, two student
    passes forward and backward, and the align net's forward on align
    steps."""
    from .. import flops as fl
    from ..reference.uawarpc import flow_and_logvar
    B, S = _size(ctx)
    m = ref_build.segmentor(ctx.config, True, "meta",
                            ref_build.student_overrides(ctx.overrides))
    net = ref_build.alignment_net(ctx.config, "meta")
    x = torch.empty(B, 3, S, S, device="meta")

    def teacher(n):
        with torch.no_grad():
            m.whole(torch.empty(n, 3, S, S, device="meta"))

    def rest():
        with torch.no_grad():
            m.backbone(torch.empty(B, 3, S // 2, S // 2, device="meta"))
        for _ in range(2):
            fl.backward_of(m.hrda_train(x, (0, 0))[:2])

    def align():
        with torch.no_grad():
            flow_and_logvar(net, x, x)

    common = fl.count(rest)
    return {"align": fl.count(lambda: teacher(2 * B)) + common
            + fl.count(align),
            "ref_as_target": fl.count(lambda: teacher(B)) + common}


def run(ctx) -> dict:
    return train_cell.run(ctx, sys.modules[__name__])


def control(ctx) -> dict:
    return train_cell.control(ctx, sys.modules[__name__], ["float8", "half"])
