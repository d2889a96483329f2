"""Entry points of the port.

Each builder reads its file under ``configs/`` and builds through
``config.py``, as the CLI does (``load_spec``, ``load_task``), with weights
drawn from a seed in place of the files' ``pretrained`` entries and
normalisation off the device with the default ImageNet constants.  A new
configuration costs a file, not code here.

- HRDA★ inference (``__graft_entry__.entry()``, ``bench.py``):
  ``build_hrda_star`` (``refign_hrda_star.yaml``, eval mode) and
  ``hrda_slide_forward``: 1080^2 crops at stride 420 over a 1080x1920
  frame, each through ``Segmentor.whole``, folded back onto the image.
- Alignment: ``build_alignment`` (the same file's frozen VGG-16 + UAWarpC),
  ``align_forward`` and ``refign_align_refine`` (Refign's align and refine
  of the teacher's pseudo-labels).
- DeepLabV2 inference: ``build_deeplabv2`` (``refign_deeplabv2.yaml``) and
  ``deeplabv2_forward`` (whole images, no slide).
- Training: ``build_uda_trainer`` (``SegTask.init_state`` of a
  segmentation file) with ``uda_train_step``, and ``build_align_trainer``
  (``AlignTask.init_state`` of ``megadepth/uawarpc_stage{1,2}.yaml``) with
  ``align_train_step``; each step's random draws come from a host
  generator.  Under a process group (``parallel/mesh.py``) both steps take
  the global batch, draw for all of it and run this rank's rows;
  ``dryrun_multigpu`` runs one Refign-HRDA step on n ranks
  (``__graft_entry__.dryrun_multichip``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import torch

from .alignment import trainer as align_trainer
from .alignment.trainer import AlignmentNet, align_forward as _align_forward
from .config import (build_alignment_net, build_segmentor, build_task,
                     load_yaml, resolve_device)
from .models.segmentor import Segmentor, slide_inference
from .parallel import mesh
from .parallel.mesh import cast_floating
from .uda.refine import refine
from .uda.trainer import (UDAConfig, UDATrainer, align_fn, draw_step,
                          train_step)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
HRDA_STAR = "cityscapes_acdc/refign_hrda_star.yaml"
DEEPLABV2 = "cityscapes_acdc/refign_deeplabv2.yaml"
_MODEL_SECTIONS = ("backbone", "head", "hrda_scale_attention",
                   "alignment_backbone", "alignment_head")


def load_spec(config: str, model_type: Optional[str] = None,
              channels: Optional[int] = None,
              max_steps: Optional[int] = None,
              warmup_iters: Optional[int] = None,
              num_classes: Optional[int] = None) -> Dict[str, Any]:
    """``configs/<config>`` as a dict, its ``pretrained`` entries dropped
    (weights come from a seed), with the overrides that are set:
    ``model_type`` of the backbone (the alignment backbone in an
    alignment file), ``channels`` of the heads (the DAFormer head's
    embedding too), ``num_classes`` of the heads, and the schedule's
    ``max_steps`` and ``warmup_iters``."""
    spec = load_yaml(os.path.join(CONFIGS, config))
    margs = spec["model"]["init_args"]
    margs.pop("pretrained", None)
    for key in _MODEL_SECTIONS:
        if key in margs:
            margs[key].setdefault("init_args", {}).pop("pretrained", None)
    if model_type is not None:
        key = "backbone" if "backbone" in margs else "alignment_backbone"
        margs[key]["init_args"]["model_type"] = model_type
    for key, widths in (("head", ("channels", "embed_dims")),
                        ("hrda_scale_attention", ("channels",))):
        if key not in margs:
            continue
        if channels is not None:
            margs[key]["init_args"].update(dict.fromkeys(widths, channels))
        if num_classes is not None:
            margs[key]["init_args"]["num_classes"] = num_classes
    if max_steps is not None:
        spec["trainer"]["max_steps"] = max_steps
        spec["lr_scheduler"]["init_args"]["max_steps"] = max_steps
    if warmup_iters is not None:
        spec["lr_scheduler"]["init_args"]["warmup_iters"] = warmup_iters
    return spec


def load_task(config: str, device="cpu", **overrides):
    """The ``SegTask`` or ``AlignTask`` of ``configs/<config>`` on
    ``device``, built by ``config.build_task`` as the CLI builds it, from
    :func:`load_spec`'s dict with ``overrides``; its step settings keep
    normalisation off the device with the default constants."""
    task, _ = build_task(load_spec(config, **overrides), device=device,
                         data_normalize=False)
    return task


def _align_stage(stage: int):
    task = load_task(f"megadepth/uawarpc_stage{stage}.yaml")
    return (task.align_cfg, task.opt.lr, task.opt.weight_decay,
            task.sched.milestones)


def __getattr__(name: str):
    """Two settings read from their files at each use (~20 ms a file), so
    that importing the module reads no file: ``REFIGN_HRDA_STAR``, the
    ``UDAConfig`` of ``refign_hrda_star.yaml``, and ``ALIGN_STAGES``, each
    UAWarpC stage's ``(AlignConfig, Adam's rate, L2 decay, MultiStepLR
    milestones)``."""
    if name == "REFIGN_HRDA_STAR":
        return load_task(HRDA_STAR).uda_cfg
    if name == "ALIGN_STAGES":
        return {stage: _align_stage(stage) for stage in (1, 2)}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _frozen(model: torch.nn.Module, dtype: torch.dtype, dev):
    """``model`` in ``dtype`` (BatchNorm statistics fp32) on ``dev``, in
    eval mode, without gradients."""
    cast_floating(model, dtype)
    return model.to(dev).eval().requires_grad_(False)


def build_hrda_star(model_type: Optional[str] = None,
                    num_classes: Optional[int] = None,
                    dtype: torch.dtype = torch.bfloat16, device="cuda",
                    seed: int = 0, channels: Optional[int] = None
                    ) -> Segmentor:
    """Eval-mode Refign-HRDA★ of ``refign_hrda_star.yaml`` on ``device``
    with weights drawn from ``seed`` (parameters in ``dtype``, BatchNorm
    statistics fp32), without drop path or remat.  ``model_type``,
    ``num_classes`` and ``channels`` (both heads' widths) default to the
    file's: mit_b5, 19 and 256."""
    dev = resolve_device(device)
    margs = load_spec(HRDA_STAR, model_type, channels,
                      num_classes=num_classes)["model"]["init_args"]
    margs["backbone"]["init_args"].update(drop_path_rate=0.0, remat=False)
    return _frozen(build_segmentor(margs, seed), dtype, dev)


def hrda_slide_forward(model: Segmentor, img: torch.Tensor,
                       crop_size: Tuple[int, int] = (1080, 1080),
                       stride: Tuple[int, int] = (420, 420)) -> torch.Tensor:
    """(B, H, W, 3) image -> (B, H, W, num_classes) logits through the
    slide + HRDA pipeline of ``bench.py``."""
    with torch.inference_mode():
        return slide_inference(model.whole, img, crop_size, stride)


def build_deeplabv2(model_type: Optional[str] = None,
                    num_classes: Optional[int] = None,
                    dtype: torch.dtype = torch.bfloat16, device="cuda",
                    seed: int = 0) -> Segmentor:
    """Eval-mode DeepLabV2 of ``refign_deeplabv2.yaml`` on ``device`` with
    weights drawn from ``seed`` (parameters in ``dtype``, BatchNorm
    statistics fp32): ResNet v1c (``model_type``, default the file's
    resnet101_v1c) dilated to output stride 8, the DeepLabV2 head on
    layer4."""
    dev = resolve_device(device)
    margs = load_spec(DEEPLABV2, model_type,
                      num_classes=num_classes)["model"]["init_args"]
    return _frozen(build_segmentor(margs, seed), dtype, dev)


def deeplabv2_forward(model: Segmentor, img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, H, W, num_classes) logits through
    ``Segmentor.whole`` (the configurations' whole-image inference at
    540x960, no slide)."""
    with torch.inference_mode():
        return model.whole(img)


def build_alignment(model_type: Optional[str] = None,
                    iterative_refinement: bool = False,
                    dtype: torch.dtype = torch.bfloat16, device="cuda",
                    seed: int = 0) -> AlignmentNet:
    """Eval-mode alignment network of ``refign_hrda_star.yaml`` on
    ``device`` with weights drawn from ``seed`` (parameters in ``dtype``,
    BatchNorm statistics fp32): VGG (``model_type``, default the file's
    vgg16) with ``out_indices`` (2, 3, 4), UAWarpC with ``in_index`` (0, 1)
    and uncertainty estimation."""
    dev = resolve_device(device)
    margs = load_spec(HRDA_STAR)["model"]["init_args"]
    if model_type is not None:
        margs["alignment_backbone"]["init_args"]["model_type"] = model_type
    margs["alignment_head"]["init_args"]["iterative_refinement"] = \
        iterative_refinement
    return _frozen(build_alignment_net(margs, seed), dtype, dev)


def align_forward(net: AlignmentNet, images_i: torch.Tensor,
                  images_j: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) images i and j -> flow i -> j (B, H, W, 2) and the
    uncertainty 1 - P_R (B, H, W, 1), both fp32."""
    with torch.inference_mode():
        return _align_forward(net, images_i, images_j)


def refign_align_refine(net: AlignmentNet, logits_trg: torch.Tensor,
                        logits_ref: torch.Tensor, images_trg: torch.Tensor,
                        images_ref: torch.Tensor, gamma: float = 0.25
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refign's align and refine: warp the teacher's logits of the
    reference image onto the adverse target and mix them into its
    pseudo-label.  Logits (B, H, W, 19), images (B, H, W, 3).  Returns the
    refined probabilities (B, H, W, 19) fp32, the warp mask (B, H, W) and
    the confidence (B, H, W, 1) fp32."""
    with torch.inference_mode():
        warped, mask, cert = align_fn(net, logits_ref, images_ref,
                                      images_trg)
        probs = refine(logits_trg, warped, mask, cert, gamma)
    return probs, mask, cert


def build_uda_trainer(model_type: Optional[str] = None,
                      cfg: Optional[UDAConfig] = None, device="cuda",
                      seed: int = 0, channels: Optional[int] = None,
                      max_steps: Optional[int] = None,
                      warmup_iters: Optional[int] = None,
                      config: str = HRDA_STAR) -> UDATrainer:
    """The UDA trainer of ``configs/<config>`` (the CLI's ``--config``) on
    ``device`` with weights drawn from ``seed``, as ``SegTask.init_state``
    builds it.  ``model_type`` (the backbone), ``channels`` (the heads'
    widths), ``max_steps`` and ``warmup_iters`` override the file's where
    set.  ``cfg`` (default: the file's, ``REFIGN_HRDA_STAR`` for the
    default file) replaces the step settings and sets the heads' class
    count and the student's HRDA."""
    spec = load_spec(config, model_type, channels, max_steps, warmup_iters,
                     num_classes=None if cfg is None else cfg.num_classes)
    if cfg is not None:
        spec["model"]["init_args"].update(
            use_hrda=cfg.use_hrda, hrda_output_stride=cfg.hrda_output_stride)
    task, _ = build_task(spec, device=device, data_normalize=False)
    if cfg is not None:
        task.uda_cfg = cfg
    return task.init_state(seed)


def uda_train_step(trainer: UDATrainer, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One UDA step in place on ``trainer``.  ``batch``: ``image_src``,
    ``image_trg``, ``image_ref`` (B, H, W, 3) normalised images (or uint8
    with ``device_normalize``) and ``semantic_src`` (B, H, W) labels, moved
    to the trainer's device; ``generator``: a CPU generator for the step's
    random draws.  Returns the losses as 0-d tensors on the device.  Under
    a process group ``batch`` is the global batch and the losses are its
    (every rank's generator in the same state)."""
    dev = next(trainer.state.student.parameters()).device
    batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
    draws = draw_step(trainer.cfg, batch, generator)
    return train_step(trainer, batch, draws)


def build_align_trainer(stage: int = 1, model_type: Optional[str] = None,
                        cfg: Optional[align_trainer.AlignConfig] = None,
                        device="cuda", seed: int = 0
                        ) -> align_trainer.AlignTrainer:
    """The UAWarpC trainer of ``megadepth/uawarpc_stage{stage}.yaml`` on
    ``device`` with weights drawn from ``seed``, as ``AlignTask.init_state``
    builds it (``ALIGN_STAGES`` holds each stage's settings).
    ``model_type`` overrides the file's VGG; ``cfg`` (default the stage's)
    replaces the step settings, ``remat_modules`` among them."""
    if stage not in (1, 2):
        raise ValueError(f"stage must be 1 or 2, got {stage}")
    task = load_task(f"megadepth/uawarpc_stage{stage}.yaml", device,
                     model_type=model_type)
    if cfg is not None:
        task.align_cfg = cfg
    return task.init_state(seed)


def align_train_step(trainer: align_trainer.AlignTrainer,
                     batch: Dict[str, torch.Tensor],
                     generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One UAWarpC step in place on ``trainer``.  ``batch``: ``image_ref``
    and ``image_trg`` (B, H, W, 3), uint8 (normalised on the device) or
    normalised floats, moved to the trainer's device; ``generator``: a CPU
    generator for the step's random draws.  Returns ``train_matching_loss``,
    ``loss_ss`` and ``loss_us`` as 0-d tensors on the device.  Under a
    process group ``batch`` is the global batch and the losses are its."""
    dev = next(trainer.state.head.parameters()).device
    batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
    B, H, W = batch["image_trg"].shape[:3]
    draws = align_trainer.draw_align(trainer.cfg, B, H, W, generator)
    return align_trainer.train_step(trainer, batch, draws)


def _dryrun_rank(rank: int, world: int, device: str, port: int) -> None:
    """One rank of :func:`dryrun_multigpu`."""
    env = {"RANK": str(rank), "WORLD_SIZE": str(world),
           "LOCAL_RANK": str(rank), "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port)}
    torch.set_num_threads(1)
    _, _, dev = mesh.init_distributed(device, env=env)
    try:
        cfg = dataclasses.replace(load_task(HRDA_STAR).uda_cfg,
                                  compute_dtype="float32"
                                  if dev.type == "cpu" else "bfloat16")
        trainer = build_uda_trainer("mit_b0", cfg=cfg, device=dev,
                                    channels=32)
        gen = torch.Generator().manual_seed(0)
        B, S = 2 * world, 64
        batch = dict(image_src=torch.randn(B, S, S, 3, generator=gen),
                     image_trg=torch.randn(B, S, S, 3, generator=gen),
                     image_ref=torch.randn(B, S, S, 3, generator=gen),
                     semantic_src=torch.randint(0, 19, (B, S, S),
                                                generator=gen))
        draws = draw_step(cfg, batch, gen)
        draws.use_ref_as_target = False   # the refine branch
        batch = {k: v.to(dev) for k, v in batch.items()}
        logs = train_step(trainer, batch, draws)
        loss = float(logs["train_loss_total"])
        if not loss == loss or abs(loss) == float("inf"):
            raise RuntimeError(f"rank {rank}: loss {loss}")
        st = trainer.state
        diff = mesh.max_param_divergence([st.student, st.teacher])
        if diff != 0.0:
            raise RuntimeError(f"parameters differ across ranks by {diff}")
        if rank == 0:
            print(f"dryrun_multigpu({world}) on {dev.type}: train step ok, "
                  f"loss={loss:.4f}, parameters equal on every rank",
                  flush=True)
    finally:
        mesh.destroy_distributed()


def dryrun_multigpu(n: int, device: str = "cuda") -> None:
    """One full Refign-HRDA step (mit_b0, 32-wide heads, VGG-16 + UAWarpC,
    64^2, two images a rank, the refine branch) on ``n`` ranks: gloo on
    the CPU for ``device='cpu'``, NCCL over ``n`` cards otherwise (raises
    without them).  Checks the loss is finite and every parameter equal
    on every rank.  The ranks meet on a free port of localhost."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multigpu({n}) needs {n} CUDA devices, "
                           f"found {torch.cuda.device_count()}; pass "
                           f"device='cpu' for gloo on the CPU")
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_dryrun_rank, args=(n, device, port), nprocs=n,
                       start_method="spawn")
