"""Rank processes of the data-parallel CPU tests
(``tests/test_torch_dist_*.py``).

:func:`spawn` starts ``world`` processes (the ``spawn`` start method), each
joins a gloo group on the CPU with one torch thread, runs ``case(rank,
world, *args)`` and saves what it returns; the test process loads every
rank's result.  Each test module spawns its ranks once, in a module-scoped
fixture that runs all of its cases in one group.  The cases build their
inputs and weights from seeds with the builders below, so the test process
builds the same ones for the single-process reference.  This module imports
no JAX: the ranks run the port alone.
"""
from __future__ import annotations

import os
import socket

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, case, args, out_dir, join):
    from refign_tpu_torch.parallel import mesh
    torch.set_num_threads(1)
    env = {"RANK": str(rank), "WORLD_SIZE": str(world),
           "LOCAL_RANK": str(rank), "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port)}
    if join:
        mesh.init_distributed("cpu", env=env)
    else:
        os.environ.update(env)
    try:
        out = case(rank, world, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.destroy_distributed()


def spawn(case, world, out_dir, *args, join=True):
    """Run ``case(rank, world, *args)`` on ``world`` gloo ranks; the list
    of their results.  ``join`` False: the ranks get the launcher's
    environment and join no group themselves (the CLI does).  A rank still
    running when spawn leaves, as when the test's time limit unwinds it, is
    killed: no rank outlives the call."""
    import torch.multiprocessing as mp
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(
        _rank_main, args=(world, free_port(), case, args, out_dir, join),
        nprocs=world, start_method="spawn", join=False)
    try:
        while not ctx.join():
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def rows(n, rank, world):
    b = n // world
    return slice(rank * b, (rank + 1) * b)


# ---------------------------------------------------------------------------
# layers, reductions, draws (test_torch_dist_layers.py)
# ---------------------------------------------------------------------------

BN_SHAPE = (8, 5, 6, 7)


def bn_inputs():
    rng = np.random.RandomState(0)
    x = (rng.randn(*BN_SHAPE) * 2 + 0.5).astype(np.float32)
    w = rng.randn(BN_SHAPE[-1]).astype(np.float32)
    b = rng.randn(BN_SHAPE[-1]).astype(np.float32)
    lw = rng.randn(*BN_SHAPE).astype(np.float32)
    return x, w, b, lw


class ConvBN(torch.nn.Module):
    def __init__(self):
        from refign_tpu_torch.nn.layers import TorchBatchNorm, conv2d
        super().__init__()
        self.conv = conv2d(BN_SHAPE[-1], BN_SHAPE[-1], 3, padding=1)
        self.bn = TorchBatchNorm(BN_SHAPE[-1])

    def forward(self, x):
        return self.bn(self.conv(x))


def conv_bn():
    from refign_tpu_torch.nn.layers import init_convs_torch_default_
    m = ConvBN()
    init_convs_torch_default_(m, torch.Generator().manual_seed(3))
    return m.train()


def bn_run(x, sl, remat=False):
    """Train-mode BN (behind a conv, optionally under remat_call) on rows
    ``sl`` of the global input, loss the mean of y * lw over them:
    output, running statistics and gradients (parameters' averaged over
    the ranks)."""
    from refign_tpu_torch.nn.layers import TorchBatchNorm, remat_call
    from refign_tpu_torch.parallel import mesh
    xn, w, b, lw = bn_inputs()
    sl = sl or slice(None)
    xt = torch.from_numpy(xn[sl]).requires_grad_(True)
    if remat:
        mod = conv_bn()
    else:
        mod = TorchBatchNorm(BN_SHAPE[-1]).train()
    bn = mod.bn if remat else mod
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    with mesh.sharded_pass(sl if sl.start is not None else None):
        y = remat_call(mod, xt) if remat else mod(xt)
    (y * torch.from_numpy(lw[sl])).mean().backward()
    mesh.reduce_gradients(mod.parameters())
    return {"y": y.detach(), "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone(), "dx": xt.grad,
            **{f"d{n}": p.grad.clone() for n, p in mod.named_parameters()}}


def iou_inputs():
    rng = np.random.RandomState(0)
    logits = rng.randn(8, 16, 16, 19).astype(np.float32)
    labels = rng.randint(0, 19, size=(8, 16, 16))
    labels[:, 0] = 255
    return logits, labels


def epe_inputs(n=8):
    rng = np.random.RandomState(1)
    flow = (rng.randn(n, 20, 24, 2) * 3).astype(np.float32)
    unc = rng.rand(n, 20, 24, 1).astype(np.float32)
    pts_s = [rng.uniform(-3, 26, (30, 2)) for _ in range(n)]
    pts_t = [rng.uniform(-3, 23, (30, 2)) for _ in range(n)]
    return flow, unc, pts_s, pts_t


def epe_run(sl):
    from refign_tpu_torch.utils.sparse_epe import SparseEPE
    flow, unc, pts_s, pts_t = epe_inputs()
    m = SparseEPE(uncertainty_estimation=True)
    m.update(flow[sl], pts_s[sl], pts_t[sl], (20, 24), unc[sl])
    return m


def dacs_inputs():
    rng = np.random.RandomState(2)
    B, H, W = 4, 20, 24
    img_t = rng.randn(B, H, W, 3).astype(np.float32)
    img_s = rng.randn(B, H, W, 3).astype(np.float32)
    logits = (rng.randn(B, H, W, 19) * 4).astype(np.float32)
    gt = rng.randint(0, 19, size=(B, H, W))
    gt[gt == 5] = 255
    gt[:2][gt[:2] == 7] = 3     # class 7 only in the second half
    return img_t, img_s, logits, gt


def dacs_run(draws, sl):
    from refign_tpu_torch.uda.dacs import dacs_mix, get_class_masks
    img_t, img_s, logits, gt = (torch.from_numpy(a) for a in dacs_inputs())
    probs = torch.softmax(logits, -1)
    sl = sl or slice(None)
    d = draws.rows(sl)
    masks = get_class_masks(d.class_scores, gt[sl])
    mixed = dacs_mix(d, img_t[sl], probs[sl], img_s[sl], gt[sl],
                     pseudo_label_threshold=0.6, color_jitter_p=0.0)
    return {"masks": masks, "img": mixed[0], "lbl": mixed[1],
            "weight": mixed[2]}


def fdist_inputs():
    rng = np.random.RandomState(3)
    f1 = rng.randn(4, 6, 5, 8).astype(np.float32)
    f2 = rng.randn(4, 6, 5, 8).astype(np.float32)
    mask = rng.rand(4, 6, 5) < 0.3
    flow = (rng.randn(4, 6, 5, 2)).astype(np.float32)
    return f1, f2, mask, flow


def masked_means_run(sl):
    """The feature distance's and the flow loss's masked means on rows
    ``sl``; the mean over the ranks of each is the global value."""
    from refign_tpu_torch.alignment.losses import _masked_mean
    from refign_tpu_torch.uda.refine import masked_feat_dist
    f1, f2, mask, flow = (torch.from_numpy(a) for a in fdist_inputs())
    sl = sl or slice(None)
    return {"fdist": masked_feat_dist(f1[sl], f2[sl], mask[sl]),
            "flow": _masked_mean(flow[sl].abs().sum(-1), mask[sl]),
            "empty": _masked_mean(flow[sl].abs().sum(-1),
                                  torch.zeros_like(mask[sl]))}


def drop_run(sl, blocks):
    """DropPath and Dropout2d in train mode on a pass of ``blocks``
    blocks of the batch (HRDA's LR rows and crops), seeded generator."""
    from refign_tpu_torch.nn.layers import Dropout2d, DropPath
    from refign_tpu_torch.parallel import mesh
    x = torch.from_numpy(np.random.RandomState(4).rand(
        blocks, 8, 3, 3, 16).astype(np.float32) + 1.0)
    sl = sl or slice(None)
    x = x[:, sl].reshape(-1, 3, 3, 16)
    gen = torch.Generator().manual_seed(11)
    with mesh.sharded_pass(None if sl.start is None else sl):
        a = DropPath(0.5).train()(x, gen)
        b = Dropout2d(0.5).train()(x, gen)
    return {"drop_path": a, "dropout2d": b}


def count_all_reduce():
    """Count calls to ``torch.distributed.all_reduce`` from here on."""
    import torch.distributed as dist
    counter = {"n": 0}
    real = dist.all_reduce

    def counting(*a, **k):
        counter["n"] += 1
        return real(*a, **k)
    dist.all_reduce = counting
    return counter, lambda: setattr(dist, "all_reduce", real)


def layers_case(rank, world, draws):
    from refign_tpu_torch.metrics import iou_init, iou_update
    from refign_tpu_torch.parallel import mesh
    out = {}
    sl = rows(BN_SHAPE[0], rank, world)
    out["bn"] = bn_run(None, sl)
    counter, undo = count_all_reduce()
    try:
        out["bn_remat"] = bn_run(None, sl, remat=True)
        out["bn_remat_collectives"] = counter["n"]
    finally:
        undo()
    # gather_rows: float and int64, exact
    g = torch.arange(24, dtype=torch.float32).reshape(8, 3) * 1.1
    out["gather_f"] = mesh.gather_rows(g[sl], 8, sl.start)
    out["gather_i"] = mesh.gather_rows(torch.arange(8)[sl] * 7, 8, sl.start)
    # shard_rows with uneven (and, at 4 ranks, empty) shares
    z = torch.arange(15, dtype=torch.float32).reshape(5, 3)
    with mesh.compute_mesh():
        out["spread5"] = mesh.shard_rows(lambda t: t * 2 + 1, z)
        out["spread3"] = mesh.shard_rows(lambda t: t * 2 + 1, z[:3])
    # an evaluation's confusion matrix: the predictions of rows spread
    # over the ranks, reassembled, counted on every rank
    logits, labels = iou_inputs()
    with mesh.compute_mesh():
        preds = mesh.shard_rows(lambda t: t.argmax(-1),
                                torch.from_numpy(logits))
    out["confmat"] = iou_update(iou_init(19), preds,
                                torch.from_numpy(labels))
    m = epe_run(rows(8, rank, world))
    out["epe_local"] = m._packed()
    m.reduce()
    out["epe"] = m._packed()
    out["dacs"] = dacs_run(draws, rows(4, rank, world))
    out["masked"] = {k: v for k, v in
                     masked_means_run(rows(4, rank, world)).items()}
    out["drop1"] = drop_run(rows(8, rank, world), 1)
    out["drop2"] = drop_run(rows(8, rank, world), 2)
    return out


# ---------------------------------------------------------------------------
# the UDA step (test_torch_dist_uda.py)
# ---------------------------------------------------------------------------

UDA_HW = 64


def uda_student(hrda=True, drop=0.1):
    from refign_tpu_torch.models.heads.daformer import DAFormerHead
    from refign_tpu_torch.models.heads.segformer import SegFormerHead
    from refign_tpu_torch.models.mix_transformer import MixVisionTransformer
    from refign_tpu_torch.models.segmentor import Segmentor
    backbone = MixVisionTransformer("mit_b0", drop_path_rate=drop,
                                    remat=True)
    dims = backbone.embed_dims
    student = Segmentor(
        backbone, DAFormerHead(19, in_channels=dims, channels=32,
                               embed_dims=32, dropout_ratio=drop),
        SegFormerHead(19, in_channels=dims, channels=32, dropout_ratio=drop)
        if hrda else None)
    gen = torch.Generator().manual_seed(0)
    for m in (backbone, student.head, student.scale_attention):
        if m is not None:
            m.init_weights(gen)
    return student


def uda_align_net(model_type="vgg11"):
    """The frozen aligner, seeded, its head's BN statistics moved off
    0/1."""
    from refign_tpu_torch.alignment.trainer import AlignmentNet
    from refign_tpu_torch.models.heads.uawarpc import UAWarpCHead
    from refign_tpu_torch.models.vgg import VGG
    net = AlignmentNet(VGG(model_type, out_indices=(2, 3, 4)),
                       UAWarpCHead(in_index=(0, 1),
                                   estimate_uncertainty=True))
    gen = torch.Generator().manual_seed(1)
    net.backbone.init_weights(gen)
    net.head.init_weights(gen)
    with torch.no_grad():
        for name, buf in net.head.named_buffers():
            noise = 0.1 * torch.randn(buf.shape, generator=gen)
            buf.copy_((buf + noise).abs() + 0.5 if name.endswith("var")
                      else buf + noise)
    return net.eval().requires_grad_(False)


def uda_batch(n_src=4, n_trg=4, seed=13):
    """Random images and labels, the first image all of a
    feature-distance class, so the feature distance has pixels."""
    rng = np.random.RandomState(seed)
    H = W = UDA_HW
    blocks = rng.randint(0, 19, size=(n_src, H // 32, W // 32))
    blocks[0] = 11     # at 64^2 HRDA's LR features are 1x1: one class
    semantic = np.kron(blocks, np.ones((32, 32), np.int64))
    trg = rng.randn(n_trg, H, W, 3).astype(np.float32) * 0.5
    ref = (np.roll(trg, 3, axis=2) * 0.9
           + rng.randn(n_trg, H, W, 3).astype(np.float32) * 0.1)
    return {"image_src": torch.from_numpy(
                rng.randn(n_src, H, W, 3).astype(np.float32) * 0.5),
            "semantic_src": torch.from_numpy(semantic),
            "image_trg": torch.from_numpy(trg),
            "image_ref": torch.from_numpy(ref.astype(np.float32))}


UDA_LR, UDA_MAX_STEPS = 6e-4, 20


def uda_trainer(cfg, hrda=True, drop=0.1, imnet_shift=0.02):
    from refign_tpu_torch.train.optim import make_uda_optimizer
    from refign_tpu_torch.uda.trainer import UDATrainer, init_uda_state
    student = uda_student(hrda, drop)
    opt, sched = make_uda_optimizer(student, UDA_LR, 0.01, UDA_MAX_STEPS,
                                    backbone_lr_factor=0.1, warmup_iters=0,
                                    power=1.0)
    state = init_uda_state(student, opt, sched, cfg.enable_fdist)
    if state.imnet is not None:
        # an ImageNet copy away from the student, so the feature distance
        # is not a difference of rounding errors
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for p in state.imnet.parameters():
                p.add_(imnet_shift * torch.randn(p.shape, generator=g))
    return UDATrainer(cfg, state, uda_align_net(), torch.Generator())


UDA_CFG = dict(use_hrda=True, use_refign=True, use_align=True,
               adapt_to_ref=True, enable_fdist=True,
               compute_dtype="float32")


def uda_steps(case, floor=False):
    """The UDA steps of a case (``steps``, default 1) on the global batch
    (each rank keeps its rows under a group): the logs and gradients of
    every step, the final parameters and BN statistics.  ``floor``: the
    batch's images moved by one ulp in random directions (one process's
    own noise)."""
    from refign_tpu_torch.parallel import mesh
    from refign_tpu_torch.uda.trainer import UDAConfig, draw_step, train_step
    cfg = UDAConfig(**UDA_CFG)
    trainer = uda_trainer(cfg)
    batch = uda_batch(**case.get("batch", {}))
    if floor:
        g = torch.Generator().manual_seed(11)
        for k, v in batch.items():
            if v.is_floating_point():
                up = torch.rand(v.shape, generator=g) < 0.5
                batch[k] = torch.where(up, torch.nextafter(v, v + 1),
                                       torch.nextafter(v, v - 1))
    gen = torch.Generator().manual_seed(5)
    logs, grads = [], []
    for i in range(case.get("steps", 1)):
        draws = draw_step(cfg, batch, gen)
        # the refine branch, then the reference as target
        draws.use_ref_as_target = bool(i % 2)
        out = train_step(trainer, batch, draws)
        logs.append({k: float(v) for k, v in out.items()})
        grads.append({n: p.grad.clone() for n, p in
                      trainer.state.student.named_parameters()
                      if p.grad is not None})
    st = trainer.state
    return {"logs": logs, "grads": grads,
            "state": {k: v.clone() for k, v in st.student.state_dict().items()},
            "teacher": {k: v.clone() for k, v in
                        st.teacher.state_dict().items()},
            "divergence": mesh.max_param_divergence(
                [st.student, st.teacher])}


UDA_CASES = {
    # the refine branch, then the reference as target
    "base": {"steps": 2},
    # ignore_every_second_semantic_training_batch's halved source: 4
    # target rows of 2 loaders' images, 2 source rows (1 + 1)
    "halved_source": {"batch": {"n_src": 2, "n_trg": 2}},
    # the semi-supervised source before halving: 4 source rows for 2
    # targets (DACS pairs target b with source b of the global batch)
    "semi_supervised": {"batch": {"n_src": 4, "n_trg": 2}},
    # 3 source rows: the world size does not divide them, every rank holds
    # them whole
    "held_whole": {"batch": {"n_src": 3, "n_trg": 2}},
}


def uda_case(rank, world):
    return {name: uda_steps(case) for name, case in UDA_CASES.items()}


def uda_pinned_case(rank, world, state_dict, imnet_sd, draws):
    """One pinned DAFormer step (no HRDA, no Refign, dropout 0) from
    given weights, for the comparison with JAX's step on a 2-device
    mesh."""
    from refign_tpu_torch.parallel import mesh
    from refign_tpu_torch.train.optim import make_uda_optimizer
    from refign_tpu_torch.uda.trainer import (UDAConfig, UDATrainer,
                                              init_uda_state, train_step)
    cfg = UDAConfig(**dict(UDA_CFG, use_hrda=False, use_refign=False,
                           adapt_to_ref=False, color_jitter_p=1.0,
                           blur=False))
    student = uda_student(hrda=False, drop=0.0)
    student.load_state_dict(state_dict)
    opt, sched = make_uda_optimizer(student, UDA_LR, 0.01, UDA_MAX_STEPS,
                                    backbone_lr_factor=0.1, warmup_iters=0,
                                    power=1.0)
    state = init_uda_state(student, opt, sched, cfg.enable_fdist)
    state.imnet.load_state_dict(imnet_sd)
    trainer = UDATrainer(cfg, state, None, torch.Generator())
    batch = pinned_batch()
    logs = train_step(trainer, batch, draws)
    return {"logs": {k: float(v) for k, v in logs.items()},
            "state": {k: v.clone() for k, v in student.state_dict().items()},
            "divergence": mesh.max_param_divergence(student)}


def pinned_batch():
    return uda_batch(n_src=4, n_trg=4, seed=21)


# ---------------------------------------------------------------------------
# the UAWarpC step (test_torch_dist_align.py)
# ---------------------------------------------------------------------------

def align_trainer(seed=0, move_backbone=None, **opts):
    """The tiny stage-1 trainer; ``opts``: other AlignConfig settings."""
    import dataclasses as dc
    from refign_tpu_torch.entry import ALIGN_STAGES, build_align_trainer
    cfg = dc.replace(ALIGN_STAGES[1][0], compute_dtype="float32",
                     crop_after_flow=(64, 64), **opts)
    tr = build_align_trainer(1, "vgg11", cfg=cfg, device="cpu", seed=seed)
    if move_backbone is not None:
        # the frozen weights moved by one ulp in random directions
        g = torch.Generator().manual_seed(move_backbone)
        with torch.no_grad():
            for p in tr.state.backbone.parameters():
                up = torch.rand(p.shape, generator=g) < 0.5
                p.copy_(torch.where(up, torch.nextafter(p, p + 1),
                                    torch.nextafter(p, p - 1)))
    return tr


def align_batch(B=4, S=80):
    """Smooth random fields (bicubic 4x4 noise) plus a little pixel noise,
    uint8."""
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(7)
    out = {}
    for k in ("image_ref", "image_trg"):
        low = torch.rand(B, 3, 4, 4, generator=g)
        x = F.interpolate(low, (S, S), mode="bicubic", align_corners=False)
        x = x + 0.05 * torch.rand(B, 3, S, S, generator=g)
        out[k] = (x.clamp(0, 1) * 255).round().to(torch.uint8).permute(
            0, 2, 3, 1).contiguous()
    return out


def align_steps(steps=1, move_backbone=None, remat=True, **opts):
    """UAWarpC steps on the global batch (each rank keeps its rows under a
    group): the logs, the first step's gradients, the
    head's final state, and the all_reduce calls made in the first
    step.  ``opts``: other AlignConfig settings."""
    from refign_tpu_torch.alignment import trainer as atr
    from refign_tpu_torch.parallel import mesh
    tr = align_trainer(move_backbone=move_backbone, **opts)
    tr.state.head.remat_modules = remat
    batch = align_batch()
    gen = torch.Generator().manual_seed(9)
    logs, grads, collectives = [], None, None
    for i in range(steps):
        B, H, W = batch["image_trg"].shape[:3]
        draws = atr.draw_align(tr.cfg, B, H, W, gen)
        counter, undo = count_all_reduce()
        try:
            out = atr.train_step(tr, batch, draws)
        finally:
            undo()
        logs.append({k: float(v) for k, v in out.items()})
        if i == 0:
            collectives = counter["n"]
            grads = {n: p.grad.clone()
                     for n, p in tr.state.head.named_parameters()
                     if p.grad is not None}
    head = tr.state.head
    return {"logs": logs, "grads": grads, "collectives": collectives,
            "state": {k: v.clone() for k, v in head.state_dict().items()},
            "divergence": mesh.max_param_divergence(head)}


def align_case(rank, world):
    return {"remat": align_steps(steps=2),
            "no_remat": align_steps(remat=False)}


# ---------------------------------------------------------------------------
# grouped BatchNorm and the folded UAWarpC step
# (test_torch_dist_grouped_bn.py)
# ---------------------------------------------------------------------------

GBN_GROUPS = 3


def gbn_inputs():
    """A global batch of GBN_GROUPS groups of BN_SHAPE each, group-major;
    each group its own mean and scale."""
    rng = np.random.RandomState(4)
    x = np.stack([(rng.randn(*BN_SHAPE) * (1 + g) + g).astype(np.float32)
                  for g in range(GBN_GROUPS)])
    w = rng.randn(BN_SHAPE[-1]).astype(np.float32)
    b = rng.randn(BN_SHAPE[-1]).astype(np.float32)
    lw = rng.randn(*x.shape).astype(np.float32)
    return x, w, b, lw


def gbn_run(sl, remat=False):
    """Grouped train-mode BN (behind a conv under remat_call where
    ``remat``) on rows ``sl`` of every group of the global input, stacked
    group by group (the folded step's layout on a rank); loss the mean of
    y * lw over them: output, running statistics and gradients."""
    from refign_tpu_torch.nn.layers import (TorchBatchNorm, grouped_bn,
                                            remat_call)
    from refign_tpu_torch.parallel import mesh
    xn, w, b, lw = gbn_inputs()
    rows_ = sl or slice(None)
    xt = torch.from_numpy(xn[:, rows_]).flatten(0, 1).requires_grad_(True)
    mod = conv_bn() if remat else TorchBatchNorm(BN_SHAPE[-1]).train()
    bn = mod.bn if remat else mod
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    with mesh.sharded_pass(sl), grouped_bn(mod, GBN_GROUPS):
        y = remat_call(mod, xt) if remat else mod(xt)
    (y * torch.from_numpy(lw[:, rows_]).flatten(0, 1)).mean().backward()
    mesh.reduce_gradients(mod.parameters())
    return {"y": y.detach(), "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone(), "dx": xt.grad,
            **{f"d{n}": p.grad.clone() for n, p in mod.named_parameters()}}


FOLD_OPTS = dict(fold_passes=True)
REMAT_HEAD_OPTS = dict(remat_head=True, remat_head_policy="dots")


def grouped_case(rank, world):
    sl = rows(BN_SHAPE[0], rank, world)
    out = {"gbn": gbn_run(sl)}
    counter, undo = count_all_reduce()
    try:
        out["gbn_remat"] = gbn_run(sl, remat=True)
        out["gbn_remat_collectives"] = counter["n"]
    finally:
        undo()
    out["fold"] = align_steps(**FOLD_OPTS)
    out["serial"] = align_steps()
    out["remat_head"] = align_steps(**REMAT_HEAD_OPTS)
    return out


# ---------------------------------------------------------------------------
# the CLI (test_torch_dist_cli.py)
# ---------------------------------------------------------------------------

def cli_case(rank, world, calls):
    """``cli.main(argv)`` for each ``(argv, port)`` in turn, under the
    launcher's environment with ``MASTER_PORT`` port.  Per call: None or
    the message of a ValueError it raised, the confusion matrices of each
    evaluation, and the student's state after its last train step."""
    from refign_tpu_torch import cli
    from refign_tpu_torch.tasks import seg_task
    out = []
    real_eval, real_step = seg_task.SegTask.evaluate, seg_task.train_step

    def evaluate(self, *a, **k):
        res = real_eval(self, *a, **k)
        rec["confmats"].append({n: {ig: c.clone() for ig, c in m.items()}
                                for n, m in self.last_confmats.items()})
        return res

    def step(trainer, *a, **k):
        res = real_step(trainer, *a, **k)
        rec["student"] = {n: v.clone() for n, v in
                          trainer.state.student.state_dict().items()}
        return res

    seg_task.SegTask.evaluate, seg_task.train_step = evaluate, step
    try:
        for argv, port in calls:
            os.environ["MASTER_PORT"] = str(port)
            rec = {"error": None, "confmats": [], "student": None}
            try:
                cli.main(argv)
            except ValueError as e:
                rec["error"] = str(e)
            out.append(rec)
    finally:
        seg_task.SegTask.evaluate, seg_task.train_step = real_eval, real_step
    return out
