"""Refign / DAFormer / HRDA UDA training: one train step (counterpart of
``refign_tpu/uda/trainer.py``).

The step has the JAX package's structure and order:

* prefix, without grad: the EMA teacher update (first), the teacher's
  pseudo-probabilities (BatchNorm on batch statistics, its updates kept
  out of the running stats), Refign's align and refine of them where
  ``use_refign``, and DACS ClassMix;
* core: the student's source pass (HRDA train where ``use_hrda``), the
  ImageNet feature distance against the frozen backbone copy, the mixed
  pass (whose BatchNorm running stats continue from the source pass's),
  ONE backward of the summed loss, and the AdamW update.

One backward of the sum, as the JAX step takes one ``jax.grad`` of it
(``:376-377``): the gradient is the reference's sum of three backward
passes up to the order of the sums, and the graph is walked once.  Its
cost is memory: both student passes' activations are alive together.

bf16 compute on fp32 masters: the student, teacher and ImageNet copy keep
fp32 parameters and run on bf16 copies made at the apply boundary
(``parallel/mesh.py:apply_cast``); the losses, softmaxes, warp and refine
stay fp32.  Every random draw of a step is made on the host first
(:func:`draw_step`: the adapt-to-reference coin, the DACS draws, the HRDA
crop offsets and a seed for the device generator of dropout and drop path),
so a test can pin any of them.

Data parallel (one process per card, ``parallel/mesh.py``): every rank
draws the global batch's draws from the same generator state and hands
the step the global batch, of which the step keeps this rank's rows.
Each pass over sharded rows runs in a ``sharded_pass`` (sync-
BN, the global batch's dropout masks); the statistics the losses take
over the whole batch (the confident share, the classes present, the
feature distance's mask count) and the logs are reduced over the ranks,
and the gradients are averaged, so the step is the single process's step
on the global batch.  An array the world size does not divide is held
whole by every rank.

Order matters in the align step and is easy to get wrong with a
plausible-looking result: the reference image goes first into the backbone
batch, the adverse target is the head's target, and the reference logits
are warped by the flow target -> reference.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..alignment.trainer import AlignmentNet, flow_and_logvar
from ..models.segmentor import Segmentor
from ..nn.layers import Dropout2d, DropPath, TorchBatchNorm
from ..ops.resize import interpolate
from ..ops.warp import confidence_from_logvar, warp
from ..parallel import mesh
from ..parallel.mesh import apply_cast, cast_params
from ..train.optim import WarmupPolyLR
from ..utils.profiling import span
from .dacs import DACSDraws, dacs_mix, draw_dacs
from .losses import pixel_weighted_cross_entropy
from .refine import fdist_loss, refine

__all__ = ["UDAConfig", "UDATrainState", "UDATrainer", "StepDraws",
           "init_uda_state", "ema_update", "hrda_crop_offset", "draw_step",
           "forward_backward", "train_step", "align_fn", "device_normalize"]


@dataclasses.dataclass(frozen=True)
class UDAConfig:
    """Static hyperparameters (the JAX ``UDAConfig``)."""
    num_classes: int = 19
    use_hrda: bool = False
    hrda_output_stride: int = 4
    hr_loss_weight: float = 0.1
    use_refign: bool = False
    use_align: bool = True
    adapt_to_ref: bool = False
    gamma: float = 0.25
    disable_M: bool = False
    disable_P: bool = False
    ema_momentum: float = 0.999
    pseudo_label_threshold: float = 0.968
    psweight_ignore_top: int = 0
    psweight_ignore_bottom: int = 0
    enable_fdist: bool = True
    fdist_lambda: float = 0.005
    fdist_classes: Tuple[int, ...] = (6, 7, 11, 12, 13, 14, 15, 16, 17, 18)
    fdist_scale_min_ratio: float = 0.75
    color_jitter_s: float = 0.2
    color_jitter_p: float = 0.2
    blur: bool = True
    compute_dtype: str = "bfloat16"
    device_normalize: bool = False
    norm_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    norm_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass
class UDATrainState:
    """The student (fp32 masters, train mode), the EMA teacher (fp32,
    BatchNorm on batch statistics without updates), the frozen ImageNet
    backbone copy (eval) or None, the optimizer and its schedule, and the
    update count."""
    student: Segmentor
    teacher: Segmentor
    imnet: Optional[nn.Module]
    optimizer: torch.optim.Optimizer
    scheduler: WarmupPolyLR
    step: int = 0


@dataclasses.dataclass
class UDATrainer:
    """A train state with its configuration, the frozen alignment network
    (or None) and the device generator of dropout and drop path."""
    cfg: UDAConfig
    state: UDATrainState
    align_net: Optional[AlignmentNet]
    dropout_gen: torch.Generator


@dataclasses.dataclass
class StepDraws:
    """Every random number of one step, drawn on the host."""
    use_ref_as_target: bool
    dacs: DACSDraws
    crop_src: Tuple[int, int]
    crop_mix: Tuple[int, int]
    dropout_seed: int


def init_uda_state(student: Segmentor, optimizer: torch.optim.Optimizer,
                   scheduler: WarmupPolyLR,
                   enable_fdist: bool = True) -> UDATrainState:
    """The teacher and the ImageNet copy start as copies of the student
    (its backbone for the latter); both are frozen.  The teacher runs its
    BatchNorm on batch statistics without updates and no dropout or drop
    path (the JAX ``teacher_forward``)."""
    student.train()
    teacher = copy.deepcopy(student).requires_grad_(False).train()
    for m in teacher.modules():
        if isinstance(m, TorchBatchNorm):
            m.update_stats = False
        elif isinstance(m, (DropPath, Dropout2d)):
            m.eval()
    imnet = None
    if enable_fdist:
        imnet = copy.deepcopy(student.backbone).requires_grad_(False).eval()
    return UDATrainState(student, teacher, imnet, optimizer, scheduler)


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module, step: int,
               momentum: float) -> None:
    """teacher <- teacher*m + student*(1-m), m = min(1 - 1/(step+1),
    momentum), in fp32 as the JAX ``ema_update``; in place."""
    f = np.float32
    m = min(f(1.0) - f(1.0) / (f(step) + f(1.0)), f(momentum))
    tp = list(teacher.parameters())
    sp = [p.to(t.dtype) for t, p in zip(tp, student.parameters())]
    torch._foreach_mul_(tp, float(m))
    torch._foreach_add_(tp, torch._foreach_mul(sp, float(f(1.0) - m)))


def hrda_crop_offset(generator: torch.Generator, H: int, W: int,
                     divisible: int) -> Tuple[int, int]:
    """Random HR crop origin (reference hrda.py:9-34): offsets divisible by
    ``divisible`` in [0, size/2]."""
    ny = (H // 2 + 1) // divisible
    nx = (W // 2 + 1) // divisible
    oy = int(torch.randint(0, ny, (), generator=generator)) * divisible
    ox = int(torch.randint(0, nx, (), generator=generator)) * divisible
    return oy, ox


def draw_step(cfg: UDAConfig, batch: Dict[str, torch.Tensor],
              generator: torch.Generator) -> StepDraws:
    """All host draws of one step, from a CPU generator.  ``batch`` is the
    global batch: under a process group every rank draws for all of its
    rows, and the step keeps its own."""
    B = batch["image_trg"].shape[0]
    H, W = batch["image_src"].shape[1:3]
    coin = bool(cfg.adapt_to_ref
                and float(torch.rand((), generator=generator)) < 0.5)
    dacs = draw_dacs(generator, B, cfg.num_classes, cfg.color_jitter_s,
                     cfg.blur)
    div = 2 * cfg.hrda_output_stride
    crop_src = hrda_crop_offset(generator, H, W, div)
    crop_mix = hrda_crop_offset(generator, H, W, div)
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return StepDraws(coin, dacs, crop_src, crop_mix, seed)


def device_normalize(cfg: UDAConfig, batch: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """ConvertImageDtype + Normalize of uint8 images on the device where
    ``cfg.device_normalize``; float batches pass through."""
    if not cfg.device_normalize:
        return batch
    out = dict(batch)
    for k in ("image_src", "image_trg", "image_ref"):
        if k in out and out[k].dtype == torch.uint8:
            x = out[k]
            mean = torch.tensor(cfg.norm_mean, device=x.device)
            std = torch.tensor(cfg.norm_std, device=x.device)
            out[k] = (x.float() / 255.0 - mean) / std
    return out


def align_fn(net: AlignmentNet, logits_ref: torch.Tensor,
             images_ref: torch.Tensor, images_trg: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warp the reference logits onto the target view.  Returns the warped
    logits (logits_ref's dtype), the strictly-in-bounds warp mask (B, H, W)
    and the confidence P_R (B, H, W, 1) fp32."""
    flow, logvar = flow_and_logvar(net, images_trg, images_ref)
    cert = confidence_from_logvar(logvar, R=1.0)
    warped, mask = warp(logits_ref, flow, return_mask=True)
    return warped, mask, cert


def _pseudo_probs(trainer: UDATrainer, batch: Dict[str, torch.Tensor],
                  use_ref_as_target: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher pseudo-probabilities and the chosen target images."""
    cfg, teacher = trainer.cfg, trainer.state.teacher
    cdt = cfg.dtype

    def teacher_logits(images):
        return apply_cast(teacher, cdt, images.to(cdt), method="whole")

    def plain(images):
        return torch.softmax(teacher_logits(images).float(), dim=-1)

    if cfg.adapt_to_ref and use_ref_as_target:
        # the coin made the normal-condition reference the target; align
        # and refine are skipped
        return plain(batch["image_ref"]), batch["image_ref"]
    images_trg = batch["image_trg"]
    if not cfg.use_refign:
        return plain(images_trg), images_trg
    images_ref = batch["image_ref"]
    b = images_trg.shape[0]
    logits = teacher_logits(torch.cat([images_trg, images_ref]))
    m_trg, m_ref = logits[:b], logits[b:]
    if cfg.use_align:
        with span("uda.align"):
            warped, mask, cert = align_fn(trainer.align_net, m_ref,
                                          images_ref, images_trg)
        with span("uda.refine"):
            probs = refine(m_trg, warped, mask, cert, cfg.gamma,
                           cfg.disable_M, cfg.disable_P)
    else:
        with span("uda.refine"):
            probs = refine(m_trg, m_ref, None, None, cfg.gamma,
                           cfg.disable_M, cfg.disable_P)
    return probs, images_trg


def _student_forward(trainer: UDATrainer, params, images: torch.Tensor,
                     crop: Tuple[int, int]):
    """Student logits at the input resolution, the HR logits (HRDA) or
    None, and the (LR) backbone features."""
    cfg, student = trainer.cfg, trainer.state.student
    x = images.to(cfg.dtype)
    H, W = x.shape[1:3]
    gen = trainer.dropout_gen
    if cfg.use_hrda:
        fused, hr_logits, feats = apply_cast(
            student, cfg.dtype, x, crop, gen, params=params,
            method="hrda_train")
    else:
        fused, feats = apply_cast(student, cfg.dtype, x, gen, params=params,
                                  method="logits_and_features")
        hr_logits = None
    logits = interpolate(fused, (H, W), mode="bilinear", align_corners=False)
    return logits, hr_logits, feats


def _seg_loss(cfg: UDAConfig, logits, hr_logits, labels, weight,
              crop: Tuple[int, int]) -> torch.Tensor:
    if not cfg.use_hrda:
        return pixel_weighted_cross_entropy(logits, labels, weight)
    oy, ox = crop
    H, W = labels.shape[1:3]
    sl = (slice(None), slice(oy, oy + H // 2), slice(ox, ox + W // 2))
    w_crop = None if weight is None else weight[sl]
    return ((1 - cfg.hr_loss_weight)
            * pixel_weighted_cross_entropy(logits, labels, weight)
            + cfg.hr_loss_weight
            * pixel_weighted_cross_entropy(hr_logits, labels[sl], w_crop))


def _mix_sources(batch: Dict[str, torch.Tensor], rows: Dict[str, int],
                 trg_rows: Optional[slice]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The source images and labels DACS pairs with this rank's targets:
    its rows of the global batch's ``[:B]`` source rows, B the global
    target count (``rows``: the global batch's row counts)."""
    src, gt = batch["image_src"], batch["semantic_src"]
    n_src, n_trg = rows["image_src"], rows["image_trg"]
    src_rows = mesh.shard_of(n_src)
    if src_rows == trg_rows:
        return src, gt
    if src_rows is not None:
        # the rows this rank needs lie on other ranks: reassemble
        src = mesh.gather_rows(src, n_src, src_rows.start)
        gt = mesh.gather_rows(gt, n_src, src_rows.start)
    keep = slice(0, n_trg) if trg_rows is None else trg_rows
    return src[:n_trg][keep], gt[:n_trg][keep]


def forward_backward(trainer: UDATrainer, batch: Dict[str, torch.Tensor],
                     draws: StepDraws) -> Dict[str, torch.Tensor]:
    """A step without its update: the EMA, the pseudo-labels, DACS, both
    student passes and the backward, which leaves the gradient of the
    summed loss in the student's ``.grad`` (averaged over the ranks under
    a process group).  Returns the logs as 0-d fp32 tensors on the device
    (no host synchronisation).

    ``batch`` and ``draws`` are the global batch's; under a process group
    the step keeps this rank's rows of both (``parallel/mesh.py:
    shard_batch``)."""
    cfg, state = trainer.cfg, trainer.state
    rows = mesh.batch_rows(batch)
    batch = device_normalize(cfg, mesh.shard_batch(batch))
    trg_rows = mesh.shard_of(rows["image_trg"])
    src_rows = mesh.shard_of(rows["image_src"])
    dacs = draws.dacs.rows(trg_rows)

    # prefix: EMA, pseudo-labels, DACS
    with torch.no_grad():
        with span("uda.ema"):
            ema_update(state.teacher, state.student, state.step,
                       cfg.ema_momentum)
        with span("uda.pseudo_labels"), mesh.sharded_pass(trg_rows):
            probs_trg, images_trg = _pseudo_probs(trainer, batch,
                                                  draws.use_ref_as_target)
        with span("uda.dacs"):
            mix_src, mix_gt = _mix_sources(batch, rows, trg_rows)
            mixed_img, mixed_lbl, mixed_weight = dacs_mix(
                dacs, images_trg, probs_trg, mix_src, mix_gt,
                pseudo_label_threshold=cfg.pseudo_label_threshold,
                color_jitter_p=cfg.color_jitter_p, blur=cfg.blur,
                psweight_ignore_top=cfg.psweight_ignore_top,
                psweight_ignore_bottom=cfg.psweight_ignore_bottom,
                num_classes=cfg.num_classes)
        del probs_trg, mix_src, mix_gt

    # core: both student passes, fdist, one backward of the sum
    trainer.dropout_gen.manual_seed(draws.dropout_seed)
    with span("uda.cast_params"):
        params = (None if cfg.dtype == torch.float32
                  else cast_params(state.student, cfg.dtype))
    gt_src = batch["semantic_src"]
    logs = {}
    with span("uda.student_src"):
        with mesh.sharded_pass(src_rows):
            logits_src, hr_src, feats_src = _student_forward(
                trainer, params, batch["image_src"], draws.crop_src)
        loss_src = _seg_loss(cfg, logits_src, hr_src, gt_src, None,
                             draws.crop_src)
    logs["train_loss_src"] = loss_src
    total = loss_src
    del logits_src, hr_src

    if cfg.enable_fdist:
        with span("uda.fdist"):
            img = batch["image_src"]
            if cfg.use_hrda:
                img = interpolate(img, (img.shape[1] // 2,
                                        img.shape[2] // 2),
                                  mode="bilinear", align_corners=False)
            with torch.no_grad():
                imnet_feats = apply_cast(state.imnet, cfg.dtype,
                                         img.to(cfg.dtype))
            lfd = fdist_loss(feats_src[-1], imnet_feats[-1], gt_src,
                             cfg.fdist_classes, cfg.fdist_scale_min_ratio,
                             cfg.num_classes, cfg.fdist_lambda)
        logs["train_loss_featdist_src"] = lfd
        total = total + lfd
        del imnet_feats
    del feats_src

    with span("uda.student_mix"):
        with mesh.sharded_pass(trg_rows):
            logits_mix, hr_mix, _ = _student_forward(
                trainer, params, mixed_img, draws.crop_mix)
        loss_mix = _seg_loss(cfg, logits_mix, hr_mix, mixed_lbl,
                             mixed_weight, draws.crop_mix)
    logs["train_loss_uda_trg"] = loss_mix
    logs["train_pseudo_weight"] = mixed_weight.float().mean()
    total = total + loss_mix
    del logits_mix, hr_mix, params

    with span("uda.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        mesh.reduce_gradients(state.student.parameters())
    logs["train_loss_total"] = total
    return _global_logs(logs)


def _global_logs(logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The logs as 0-d fp32 tensors, each the mean of the ranks' values
    (one collective; the values themselves without a group)."""
    keys = list(logs)
    packed = mesh.mean_over_ranks(
        torch.stack([logs[k].detach().float() for k in keys]))
    return dict(zip(keys, packed.unbind()))


def train_step(trainer: UDATrainer, batch: Dict[str, torch.Tensor],
               draws: StepDraws) -> Dict[str, torch.Tensor]:
    """One UDA step in place on ``trainer.state``: :func:`forward_backward`,
    then AdamW at the schedule's rate for the update count (the same
    update on every rank: the gradients are averaged first).  Its phases
    are spans (``utils/profiling.py``): ``uda.step`` over ``uda.ema``,
    ``uda.pseudo_labels`` (``uda.align``, ``uda.refine``), ``uda.dacs``,
    ``uda.cast_params``, ``uda.student_src``, ``uda.fdist``,
    ``uda.student_mix``, ``uda.backward`` and ``uda.optimizer``."""
    with span("uda.step"):
        logs = forward_backward(trainer, batch, draws)
        state = trainer.state
        with span("uda.optimizer"):
            state.scheduler.set_step(state.step)
            state.optimizer.step()
        state.step += 1
    return logs
