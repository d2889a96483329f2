"""Alignment (UAWarpC) task: fit / validate / test (counterpart of
``refign_tpu/tasks/align_task.py``).

The reference AlignmentModel + Lightning runtime
(models/alignment_model.py): frozen VGG + UAWarpC head training with the
synthetic-flow supervision made on the card (``alignment/trainer.py``),
and sparse EPE / PCK / AUSE evaluation (``utils/sparse_epe.py``).

Evaluation runs the frozen backbone as the train state holds it (in the
compute dtype) and a copy of the head cast to the same dtype; the JAX
task evaluates in fp32.  With ``trainer.precision: 32`` both are fp32.
``model.init_args`` sets the step's options as the JAX task reads them:
``apply_constant_flow_weights``, the unsupervised loss's
``visibility_mask``, ``alpha_1`` and ``alpha_2``, and the memory options
``remat_modules`` (default on), ``remat_head``, ``remat_head_policy``,
``remat_skip_last`` and ``fold_passes``; the data's ``normalize_settings``
give ``norm_mean`` and ``norm_std``.

Data parallel (``parallel/mesh.py``): the fit checks that the world size
divides the batch, every rank builds the global batch and its draws and
keeps its rows; validation takes the batches ``k`` with ``k % world ==
rank`` on each rank and sums the SparseEPE accumulators over the ranks.
"""
from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, Optional

import torch

from ..alignment import trainer as atr
from ..alignment.trainer import AlignmentNet, align_forward
from ..config import (OptimizerSpec, SchedulerSpec, align_config,
                      build_alignment_net, parse_metrics, resolve_device)
from ..data.loader import DevicePrefetcher, InfiniteLoader, cuda_put
from ..parallel import mesh
from ..parallel.mesh import cast_floating
from ..train.loop import FitBookkeeper
from ..train.optim import make_adam_optimizer, multistep_lr
from ..utils import checkpoint as ckpt
from ..utils.sparse_epe import SparseEPE
from .seg_task import load_alignment_pretrained


def _host_batch_from(raw_batches):
    """Concatenate per-loader sub-batches into one train batch (reference
    on_before_batch_transfer cat semantics, combined_data_module.py:
    263-310); maps the datasets' 'image' key to the step's image_trg."""
    def cat(key):
        xs = [r[key] for r in raw_batches]
        return xs[0] if len(xs) == 1 else torch.cat(xs)
    return {"image_ref": cat("image_ref"), "image_trg": cat("image")}


class AlignTask:

    def __init__(self, margs: Dict[str, Any], opt: OptimizerSpec,
                 sched: SchedulerSpec, trainer_cfg: Dict[str, Any],
                 datamodule, device="cuda", data_normalize: bool = True):
        self.device = resolve_device(device)
        self.margs = margs
        self.opt = opt
        self.sched = sched
        self.trainer_cfg = trainer_cfg or {}
        self.datamodule = datamodule
        self.align_cfg = align_config(margs, self.trainer_cfg, datamodule,
                                      data_normalize)
        self.pretrained = margs.get("pretrained")
        self.metrics_cfg = parse_metrics(margs.get("metrics", {}))

    def init_state(self, seed: int = 0) -> atr.AlignTrainer:
        """The frozen backbone (cast to the compute dtype) and the head
        (fp32 masters) from the config with weights drawn from ``seed``,
        their ``pretrained`` files loaded, Adam with MultiStepLR."""
        net = build_alignment_net(self.margs, seed)
        net.head.remat_modules = self.align_cfg.remat_modules
        load_alignment_pretrained(net, self.margs, self.pretrained)
        backbone, head = net.backbone, net.head
        backbone.to(self.device)
        head.to(self.device)
        opt, sched = make_adam_optimizer(
            head.parameters(), self.opt.lr,
            self.sched.milestones or [10 ** 9], gamma=self.sched.gamma,
            weight_decay=self.opt.weight_decay, betas=self.opt.betas)
        state = atr.init_align_state(backbone, head, opt, sched,
                                     self.align_cfg.dtype)
        mesh.replicate([backbone, head])
        return atr.AlignTrainer(self.align_cfg, state)

    def restore(self, path: str, seed: int = 0) -> atr.AlignTrainer:
        trainer = self.init_state(seed)
        ckpt.load_train_state(trainer, ckpt.restore_checkpoint(path))
        return trainer

    # ------------------------------------------------------------------- fit

    def fit(self, workdir: str, seed: int = 0,
            resume: Optional[str] = None) -> Dict[str, float]:
        """All train loaders contribute each step: per-loader sub-batches
        are concatenated like the reference's on_before_batch_transfer."""
        os.makedirs(workdir, exist_ok=True)
        self.datamodule.setup("fit")
        loaders = self.datamodule.train_dataloaders(seed=seed)
        iters = [iter(InfiniteLoader(l)) for l in loaders]
        trainer = self.init_state(seed)
        # the step's host draws; jax.random has no counterpart, so they
        # differ from the JAX task's
        draw_gen = torch.Generator().manual_seed(seed)
        if resume:
            ckpt.load_train_state(trainer, ckpt.restore_checkpoint(resume),
                                  {"draws": draw_gen})
        # the JAX task sizes its device mesh on the first batch of every
        # loader; the port draws it too, so its steps see the same batches,
        # and raises where the world size does not divide it
        probe = _host_batch_from([next(i) for i in iters])
        mesh.check_world_divides(mesh.batch_rows(probe).values())

        bk = FitBookkeeper(
            workdir, self.trainer_cfg,
            lambda s: multistep_lr(s, self.opt.lr,
                                   self.sched.milestones or [10 ** 9],
                                   self.sched.gamma),
            lambda: self.evaluate("val", trainer),
            lambda step: ckpt.save_checkpoint(
                bk.ckpt_dir, ckpt.train_state(trainer, {"draws": draw_gen}),
                step),
            default_max_steps=400000)
        put = (cuda_put(self.device) if self.device.type == "cuda"
               else (lambda b: b))
        prefetcher = DevicePrefetcher(
            lambda: _host_batch_from([next(i) for i in iters]), put)
        start_step = trainer.state.step
        try:
            for step in range(start_step, bk.max_steps):
                t_start = time.perf_counter()
                batch = prefetcher.next()
                wait = time.perf_counter() - t_start
                batch = {k: v.to(self.device) for k, v in batch.items()}
                B, H, W = batch["image_trg"].shape[:3]
                draws = atr.draw_align(self.align_cfg, B, H, W, draw_gen)
                logs = atr.train_step(trainer, batch, draws)
                bk.on_step(step, start_step, logs, t_start, wait)
        finally:
            prefetcher.close()
            for l in loaders:
                l.close()
        return bk.finish()

    # ------------------------------------------------------------------ eval

    def eval_net(self, trainer: atr.AlignTrainer) -> AlignmentNet:
        """The frozen backbone with an eval-mode copy of the head in the
        backbone's dtype."""
        st = trainer.state
        dtype = next(st.backbone.parameters()).dtype
        head = cast_floating(copy.deepcopy(st.head), dtype).eval()
        return AlignmentNet(st.backbone, head)

    def evaluate(self, stage: str, trainer=None) -> Dict[str, float]:
        if stage not in self.datamodule.datasets:
            self.datamodule.setup("validate" if stage == "val" else stage)
        if trainer is None:
            trainer = self.init_state(0)
        net = self.eval_net(trainer)
        results = {}
        loaders = self.datamodule.eval_dataloaders(stage)
        names = self.datamodule.stage_on[stage]
        try:
            for name, loader in zip(names, loaders):
                specs = self.metrics_cfg.get(stage, {}).get(
                    name, [("SparseEPE", {})])
                for mname, _ in specs:
                    if mname != "SparseEPE":
                        raise ValueError(
                            f"unsupported metric '{mname}' for matching "
                            f"dataset '{name}' (supported: SparseEPE)")
                metric = SparseEPE(uncertainty_estimation=any(
                    a.get("uncertainty_estimation") for _, a in specs))
                for k, batch in enumerate(loader):
                    if k % mesh.world_size() != mesh.rank():
                        continue
                    with torch.inference_mode():
                        flow, uncert = align_forward(
                            net, batch["image"].to(self.device),
                            batch["image_ref"].to(self.device))
                    h, w = batch["image"].shape[1:3]
                    metric.update(flow.float().cpu().numpy(),
                                  batch["corr_pts_ref"], batch["corr_pts"],
                                  (h, w), uncert.float().cpu().numpy())
                metric.reduce()
                for k, v in metric.compute().items():
                    results[f"{stage}_{name}_{k}"] = float(v)
        finally:
            for loader in loaders:
                loader.close()
        return results
