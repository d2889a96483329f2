"""Domain-adaptive segmentation task: fit / validate / test / predict
(counterpart of ``refign_tpu/tasks/seg_task.py``).

The reference's DomainAdaptationSegmentationModel + Lightning runtime
(models/segmentation_model.py): builds the student (backbone, head and
HRDA scale attention from the config), its EMA teacher and ImageNet copy
(``uda/trainer.py``), the frozen alignment network, loads pretrained
weights natively (``utils/checkpoint.py``), and runs the UDA train step,
whole or slide inference, per-dataset IoU and prediction PNGs on one card.

Evaluation runs the student's fp32 masters in eval mode, as the JAX task
evaluates ``state.params``; confusion matrices accumulate on the card in
int64, one per distinct ``ignore_index``.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..alignment.trainer import AlignmentNet
from ..config import (OptimizerSpec, SchedulerSpec, backbone_widths,
                      build_backbone, build_head, init_args, parse_metrics,
                      precision_dtype)
from ..data.loader import DevicePrefetcher, InfiniteLoader, cuda_put
from ..entry import _resolve_device
from ..metrics import iou_compute, iou_init, iou_update
from ..models.segmentor import Segmentor, slide_inference
from ..ops.resize import interpolate
from ..parallel.mesh import cast_floating
from ..train.loop import FitBookkeeper
from ..train.optim import make_uda_optimizer, warmup_poly_lr
from ..uda.trainer import (UDAConfig, UDATrainer, draw_step, init_uda_state,
                           train_step)
from ..utils import checkpoint as ckpt
from ..utils.palette import colorize_mask
from ..utils.pretrained import backbone_family, resolve_pretrained


def _resolve(spec: str, module=None) -> str:
    """Keyword/path/URL -> a local checkpoint file; raises if the source
    cannot be found (reference mix_transformer.py:445-462,
    segmentation_model.py:421-436)."""
    return resolve_pretrained(
        spec, family=None if module is None else backbone_family(module),
        model_type=getattr(module, "model_type", None))


def load_pretrained_backbone(module, spec: str) -> None:
    """A reference backbone file into ``module`` (subset semantics)."""
    path = _resolve(spec, module)
    ckpt.load_state(module, ckpt.backbone_state(ckpt.read_reference(path)),
                    subset=True, what=path)


class SegTask:

    def __init__(self, margs: Dict[str, Any], opt: OptimizerSpec,
                 sched: SchedulerSpec, trainer_cfg: Dict[str, Any],
                 datamodule, device="cuda"):
        self.device = _resolve_device(device)
        self.margs = margs
        self.opt = opt
        self.sched = sched
        self.trainer_cfg = trainer_cfg or {}
        self.datamodule = datamodule
        self.use_hrda = margs.get("use_hrda", False)
        self.hrda_output_stride = margs.get("hrda_output_stride", 4)
        self.has_align = bool(margs.get("alignment_backbone")
                              and margs.get("alignment_head"))
        norm = getattr(datamodule, "normalize_settings", None)
        self.uda_cfg = UDAConfig(
            num_classes=init_args(margs["head"]).get("num_classes", 19),
            use_hrda=self.use_hrda,
            hrda_output_stride=self.hrda_output_stride,
            hr_loss_weight=margs.get("hr_loss_weight", 0.1),
            use_refign=margs.get("use_refign", False),
            use_align=margs.get("use_align", True),
            adapt_to_ref=margs.get("adapt_to_ref", False),
            gamma=margs.get("gamma", 0.25),
            disable_M=margs.get("disable_M", False),
            disable_P=margs.get("disable_P", False),
            ema_momentum=margs.get("ema_momentum", 0.999),
            pseudo_label_threshold=margs.get("pseudo_label_threshold",
                                             0.968),
            psweight_ignore_top=margs.get("psweight_ignore_top", 0),
            psweight_ignore_bottom=margs.get("psweight_ignore_bottom", 0),
            enable_fdist=margs.get("enable_fdist", True),
            fdist_lambda=margs.get("fdist_lambda", 0.005),
            fdist_classes=tuple(margs.get(
                "fdist_classes", (6, 7, 11, 12, 13, 14, 15, 16, 17, 18))),
            fdist_scale_min_ratio=margs.get("fdist_scale_min_ratio", 0.75),
            color_jitter_s=margs.get("color_jitter_s", 0.2),
            color_jitter_p=margs.get("color_jitter_p", 0.2),
            blur=margs.get("blur", True),
            compute_dtype=precision_dtype(
                self.trainer_cfg.get("precision", 16)),
            device_normalize=bool(getattr(datamodule, "device_normalize",
                                          False)),
            **({"norm_mean": tuple(norm["mean"]),
                "norm_std": tuple(norm["std"])} if norm else {}),
        )
        self.num_classes = self.uda_cfg.num_classes
        self.backbone_lr_factor = margs.get("backbone_lr_factor", 1.0)
        self.use_slide_inference = margs.get("use_slide_inference", False)
        self.inference_crop_size = tuple(margs.get("inference_crop_size",
                                                   (1080, 1080)))
        self.inference_stride = tuple(margs.get("inference_stride",
                                                (420, 420)))
        self.metrics_cfg = parse_metrics(margs.get("metrics", {}))
        self.pretrained = margs.get("pretrained")

    # ------------------------------------------------------------------ init

    def build_student(self, seed: int = 0) -> Segmentor:
        """The student from the config, its weights drawn from ``seed``
        (on the CPU), then the backbone's ``pretrained`` file loaded."""
        backbone, bb_pretrained = build_backbone(self.margs["backbone"])
        widths = backbone_widths(backbone)
        head, _ = build_head(self.margs["head"], widths)
        scale_attention = None
        if self.use_hrda and self.margs.get("hrda_scale_attention"):
            scale_attention, _ = build_head(
                self.margs["hrda_scale_attention"], widths)
        gen = torch.Generator().manual_seed(seed)
        for m in (backbone, head, scale_attention):
            if m is not None:
                m.init_weights(gen)
        if bb_pretrained:
            load_pretrained_backbone(backbone, bb_pretrained)
        return Segmentor(backbone, head, scale_attention,
                         hrda_output_stride=self.hrda_output_stride)

    def build_align_net(self, seed: int = 0) -> Optional[AlignmentNet]:
        """The alignment network from the config (fp32, on the CPU), its
        weights drawn from ``seed`` + 1, then its ``pretrained`` files
        loaded; None where the config has none."""
        if not self.has_align:
            return None
        backbone, bb_pre = build_backbone(self.margs["alignment_backbone"])
        head, head_pre = build_head(self.margs["alignment_head"])
        gen = torch.Generator().manual_seed(seed + 1)
        backbone.init_weights(gen)
        head.init_weights(gen)
        if bb_pre:
            load_pretrained_backbone(backbone, bb_pre)
        if head_pre:
            path = _resolve(head_pre)
            ckpt.load_state(head, ckpt.alignment_head_state(
                ckpt.read_reference(path)), what=path)
        return AlignmentNet(backbone, head)

    def init_state(self, seed: int = 0) -> UDATrainer:
        """The UDA trainer on the task's device: student (fp32 masters),
        teacher, ImageNet copy, AdamW with the warmup-poly schedule, the
        frozen alignment network; then the model-level ``pretrained``
        full checkpoint, strict."""
        student = self.build_student(seed)
        align_net = self.build_align_net(seed)
        groups = None
        if self.pretrained:
            path = _resolve(self.pretrained)
            groups = ckpt.uda_groups(ckpt.read_reference(path))
            if not groups:
                raise KeyError(f"no recognized submodules in {path}")
        student.to(self.device)
        opt, sched = make_uda_optimizer(
            student, self.opt.lr, self.opt.weight_decay,
            self.sched.max_steps, backbone_lr_factor=self.backbone_lr_factor,
            warmup_iters=self.sched.warmup_iters, power=self.sched.power,
            warmup_ratio=self.sched.warmup_ratio, min_lr=self.sched.min_lr,
            betas=self.opt.betas)
        state = init_uda_state(student, opt, sched,
                               enable_fdist=self.uda_cfg.enable_fdist)
        if groups is not None:
            self._load_full(state, align_net, groups)
        if align_net is not None:
            cast_floating(align_net, self.uda_cfg.dtype)
            align_net = align_net.to(self.device).eval().requires_grad_(
                False)
        return UDATrainer(self.uda_cfg, state, align_net,
                          torch.Generator(device=self.device))

    def _load_full(self, state, align_net, groups) -> None:
        """A full reference UDA checkpoint, strict: it must cover every
        submodule the model owns (reference segmentation_model.py:436)."""
        nets = {"": state.student, "m_": state.teacher}
        mapping = [(p + g, net, g) for p, net in nets.items()
                   for g in ("backbone", "head", "scale_attention")
                   if getattr(net, g, None) is not None]
        required = {src for src, _, _ in mapping}
        if state.imnet is not None:
            required.add("imnet_backbone")
        missing = sorted(required - set(groups))
        if missing:
            raise KeyError(
                f"pretrained checkpoint is missing submodule groups "
                f"{missing} (has {sorted(groups)}); the reference loads "
                f"full-state checkpoints with strict=True")
        for src, net, attr in mapping:
            ckpt.load_state(getattr(net, attr), groups[src], what=src)
        if state.imnet is not None:
            ckpt.load_state(state.imnet, groups["imnet_backbone"],
                            what="imnet_backbone")
        if align_net is not None:
            if "alignment_head" in groups:
                ckpt.load_state(align_net.head, groups["alignment_head"],
                                what="alignment_head")
            if "alignment_backbone" in groups:
                ckpt.load_state(align_net.backbone,
                                groups["alignment_backbone"], subset=True,
                                what="alignment_backbone")

    def restore(self, path: str, seed: int = 0) -> UDATrainer:
        """A trainer with the train state of a port checkpoint."""
        trainer = self.init_state(seed)
        ckpt.load_train_state(trainer, ckpt.restore_checkpoint(path))
        return trainer

    # ----------------------------------------------------------------- infer

    def forward(self, model: Segmentor, x: torch.Tensor,
                out_size: Tuple[int, int]) -> torch.Tensor:
        """Eval logits at ``out_size`` (reference segmentation_model.py:
        304-318): whole or slide inference, then a bilinear resize."""
        if self.use_slide_inference:
            logits = slide_inference(model.whole, x,
                                     self.inference_crop_size,
                                     self.inference_stride)
        else:
            logits = model.whole(x)
        return interpolate(logits, out_size, mode="bilinear",
                           align_corners=False)

    # ------------------------------------------------------------------ eval

    def evaluate(self, stage: str, trainer: Optional[UDATrainer] = None
                 ) -> Dict[str, float]:
        """Per-dataset IoU of the student on ``stage``."""
        if stage not in self.datamodule.datasets:
            self.datamodule.setup("validate" if stage == "val" else stage)
        if trainer is None:
            trainer = self.init_state(0)
        model = trainer.state.student
        was_training = model.training
        model.eval()
        results: Dict[str, float] = {}
        self.last_confmats: Dict[str, Dict[int, torch.Tensor]] = {}
        loaders = self.datamodule.eval_dataloaders(stage)
        names = self.datamodule.stage_on[stage]
        try:
            for name, loader in zip(names, loaders):
                specs = self.metrics_cfg.get(stage, {}).get(
                    name, [("IoU", {})])
                for mname, margs_ in specs:
                    if mname != "IoU":
                        raise ValueError(
                            f"unsupported metric '{mname}' for segmentation "
                            f"dataset '{name}' (supported: IoU)")
                    nc = margs_.get("num_classes", self.num_classes)
                    if nc != self.num_classes:
                        raise ValueError(f"metric num_classes {nc} != model "
                                         f"{self.num_classes}")
                ign_list = sorted({m.get("ignore_index", 255)
                                   for _, m in specs})
                # int64: an int32 accumulator wraps past 2**31 pixels per
                # cell on large evaluations
                confmats = {ig: iou_init(self.num_classes).to(self.device)
                            for ig in ign_list}
                for batch in loader:
                    x = batch["image"].to(self.device)
                    y = batch["semantic"].to(self.device)
                    with torch.inference_mode():
                        preds = self.forward(model, x,
                                             tuple(y.shape[1:3])).argmax(-1)
                        for ig in ign_list:
                            confmats[ig] = iou_update(confmats[ig], preds, y,
                                                      ignore_index=ig)
                for i, (mname, margs_) in enumerate(specs):
                    val = float(iou_compute(
                        confmats[margs_.get("ignore_index", 255)].cpu(),
                        margs_.get("average", "macro"),
                        absent_score=margs_.get("absent_score", 0.0),
                        over_present_classes=margs_.get(
                            "over_present_classes", False)))
                    key = f"{stage}_{name}_{mname}"
                    if len(specs) > 1 and i > 0:
                        key = f"{key}_{i}"
                    results[key] = val
                self.last_confmats[name] = {ig: c.cpu() for ig, c
                                            in confmats.items()}
        finally:
            for loader in loaders:
                loader.close()
            model.train(was_training)
        return results

    # ------------------------------------------------------------------- fit

    def fit(self, workdir: str, seed: int = 0,
            resume: Optional[str] = None) -> Dict[str, float]:
        os.makedirs(workdir, exist_ok=True)
        dm = self.datamodule
        dm.setup("fit")
        loaders = dm.train_dataloaders(seed=seed)
        iters = [iter(InfiniteLoader(l)) for l in loaders]

        trainer = self.init_state(seed)
        # the step's host draws (DACS, HRDA crops, the dropout seed);
        # jax.random has no counterpart, so they differ from the JAX task's
        draw_gen = torch.Generator().manual_seed(seed)
        if resume:
            ckpt.load_train_state(trainer, ckpt.restore_checkpoint(resume),
                                  {"draws": draw_gen})
        # the JAX task sizes its device mesh on the first batch of every
        # loader; the port draws it too, so its steps see the same batches
        dm.merge_train_batch([next(it) for it in iters], drop_half=False)

        # the adapt-to-reference coin (reference segmentation_model.py:195)
        coin_rng = np.random.RandomState(seed ^ 0x5EED)
        cfg = self.uda_cfg
        bk = FitBookkeeper(
            workdir, self.trainer_cfg,
            lambda s: warmup_poly_lr(
                s, self.opt.lr, self.sched.max_steps,
                warmup_iters=self.sched.warmup_iters,
                warmup_ratio=self.sched.warmup_ratio,
                power=self.sched.power, min_lr=self.sched.min_lr),
            lambda: self.evaluate("val", trainer),
            lambda step: ckpt.save_checkpoint(
                bk.ckpt_dir, ckpt.train_state(trainer, {"draws": draw_gen}),
                step),
            default_max_steps=40000)
        put = (cuda_put(self.device) if self.device.type == "cuda"
               else (lambda b: b))
        prefetcher = DevicePrefetcher(
            lambda: dm.merge_train_batch([next(it) for it in iters]), put)
        start_step = trainer.state.step
        try:
            for step in range(start_step, bk.max_steps):
                t_start = time.perf_counter()
                batch = prefetcher.next()
                wait = time.perf_counter() - t_start
                batch = {k: v.to(self.device) for k, v in batch.items()}
                batch["semantic_src"] = batch["semantic_src"].long()
                draws = draw_step(cfg, batch, draw_gen)
                draws.use_ref_as_target = (cfg.adapt_to_ref
                                           and bool(coin_rng.rand() < 0.5))
                logs = train_step(trainer, batch, draws)
                bk.on_step(step, start_step, logs, t_start, wait)
        finally:
            prefetcher.close()
            for l in loaders:
                l.close()
        return bk.finish()

    # ---------------------------------------------------------------- predict

    def predict(self, workdir: str, trainer: Optional[UDATrainer] = None
                ) -> None:
        """argmax -> trainId PNG + palette-colorized PNG
        (reference segmentation_model.py:283-302)."""
        from PIL import Image
        self.datamodule.setup("predict")
        if trainer is None:
            trainer = self.init_state(0)
        model = trainer.state.student
        was_training = model.training
        model.eval()
        loaders = self.datamodule.eval_dataloaders("predict")
        names = self.datamodule.stage_on["predict"]
        try:
            for name, loader, ds in zip(names, loaders,
                                        self.datamodule.datasets["predict"]):
                save_dir = os.path.join(workdir, "preds", name)
                col_dir = os.path.join(workdir, "color_preds", name)
                os.makedirs(save_dir, exist_ok=True)
                os.makedirs(col_dir, exist_ok=True)
                out_size = tuple(ds.orig_dims)
                for batch in loader:
                    x = batch["image"].to(self.device)
                    with torch.inference_mode():
                        preds = self.forward(model, x, out_size).argmax(-1)
                    preds = preds.to(torch.uint8).cpu().numpy()
                    for pred, fn in zip(preds, batch["filename"]):
                        Image.fromarray(pred).save(os.path.join(save_dir, fn))
                        colorize_mask(pred).save(os.path.join(col_dir, fn))
        finally:
            for loader in loaders:
                loader.close()
            model.train(was_training)
