"""Entry points of the port.

HRDA★ inference (counterpart of ``__graft_entry__.entry()`` and the
pipeline of ``bench.py``): ``build_hrda_star`` builds Refign-HRDA★ (MiT
backbone, DAFormer head, SegFormer scale attention) in eval mode with
seeded random weights; ``hrda_slide_forward`` runs the 1080x1920 slide
pipeline: an outer slide of 1080^2 crops at stride 420, each crop through
``Segmentor.whole`` (HRDA eval, upsampled to the crop), folded back onto
the image.

Alignment: ``build_alignment`` builds the frozen alignment network (VGG-16
pyramid, UAWarpC head with uncertainty) of
``configs/cityscapes_acdc/refign_hrda_star.yaml``; ``align_forward`` is
UAWarpC's evaluation forward and ``refign_align_refine`` Refign's align
and refine of the teacher's pseudo-labels inside a UDA step.

DeepLabV2 inference (the evaluation of
``configs/*/refign_deeplabv2.yaml``): ``build_deeplabv2`` builds the
dilated ResNet v1c + DeepLabV2 ASPP head in eval mode with seeded random
weights; ``deeplabv2_forward`` runs ``Segmentor.whole`` on whole images
(the test configuration's 540x960).

UDA training (counterpart of ``make_uda_train_step`` with the
``configs/cityscapes_acdc/refign_hrda_star.yaml`` settings, or those of
``refign_deeplabv2.yaml`` for a ResNet ``model_type``):
``build_uda_trainer`` builds the student (MiT + DAFormer + SegFormer scale
attention, fp32 masters, remat; or ResNet v1c + DeepLabV2), its EMA
teacher, the frozen ImageNet backbone copy, the frozen alignment network
and AdamW with the warmup-poly schedule, all from a seed;
``uda_train_step`` takes one step on a batch, its random draws made from a
host generator.

UAWarpC alignment training (counterpart of ``make_align_train_step`` with
the ``configs/megadepth/uawarpc_stage{1,2}.yaml`` settings):
``build_align_trainer`` builds the frozen VGG-16 and the UAWarpC head
(fp32 masters) and Adam with MultiStepLR, from a seed;
``align_train_step`` takes one step on a batch of image pairs, its random
draws made from a host generator.

Data parallel (one process per card over ``torch.distributed``,
``parallel/mesh.py``): under a process group both step entry points take
the global batch, draw for all of it and run this rank's rows.
``dryrun_multigpu`` spawns n ranks (gloo on the CPU, NCCL over n cards)
and runs one full Refign-HRDA step on each (the counterpart of
``__graft_entry__.dryrun_multichip``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .alignment import trainer as align_trainer
from .alignment.trainer import AlignmentNet, align_forward as _align_forward
from .models.heads.daformer import DAFormerHead
from .models.heads.deeplabv2 import DeepLabV2Head
from .models.heads.segformer import SegFormerHead
from .models.heads.uawarpc import UAWarpCHead
from .models.mix_transformer import MixVisionTransformer
from .models.resnet import ARCH_SETTINGS as RESNETS, ResNet
from .models.segmentor import Segmentor, slide_inference
from .models.vgg import VGG
from .parallel import mesh
from .parallel.mesh import cast_floating
from .train.optim import make_adam_optimizer, make_uda_optimizer
from .uda.refine import refine
from .uda.trainer import (UDAConfig, UDATrainer, align_fn, draw_step,
                          init_uda_state, train_step)

# the UDA settings of configs/cityscapes_acdc/refign_hrda_star.yaml
REFIGN_HRDA_STAR = UDAConfig(use_hrda=True, hrda_output_stride=4,
                             hr_loss_weight=0.1, use_refign=True,
                             use_align=True, adapt_to_ref=True, gamma=0.25,
                             enable_fdist=True)
# the model and optimizer settings of the same file
UDA_REMAT = True
UDA_DROP_PATH_RATE = 0.1
UDA_DROPOUT_RATIO = 0.1
UDA_BASE_LR = 6e-4
UDA_WEIGHT_DECAY = 0.01
UDA_POLY_POWER = 1.0
UDA_BACKBONE_LR_FACTOR = 0.1
# the UDA settings of configs/{cityscapes_acdc,cityscapes_darkzurich,
# cityscapes_robotcar}/refign_deeplabv2.yaml; their optimizer and schedule
# are the HRDA★ file's, and they set no drop path, dropout or with_cp
REFIGN_DEEPLABV2 = UDAConfig(use_hrda=False, use_refign=True,
                             use_align=True, adapt_to_ref=True, gamma=0.25,
                             enable_fdist=True)
# the model of the same files: ResNet-101 v1c, dilated to output stride 8,
# and the DeepLabV2 head on layer4
DEEPLABV2_STRIDES = (1, 2, 1, 1)
DEEPLABV2_DILATIONS = (1, 1, 2, 4)
DEEPLABV2_IN_INDEX = 3

# configs/megadepth/uawarpc_stage1.yaml as tasks/align_task.py reads it:
# 750^2 loads, the prime's ColorJitter 0.6/0.6/0.6/0, ChannelShuffle and
# GaussianBlur(p 0.2, k 7, sigma 0.2-2), CompositeFlow, CenterCrop 520,
# bf16 compute, remat_modules
UAWARPC_STAGE1 = align_trainer.AlignConfig(
    prime_jitter=(0.6, 0.6, 0.6, 0.0), prime_channel_shuffle=True,
    prime_blur=(0.2, 7, 0.2, 2.0), crop_after_flow=(520, 520),
    remat_modules=True)
# uawarpc_stage2.yaml: the visibility mask, larger perturbations and the
# elastic flow
UAWARPC_STAGE2 = dataclasses.replace(
    UAWARPC_STAGE1, visibility_mask=True, random_t_hom=0.4,
    random_t_tps=0.4, random_t_tps_for_afftps=0.26, add_elastic=True)
# each stage: the step's settings, and Adam's rate, L2 decay and
# MultiStepLR milestones
ALIGN_STAGES = {
    1: (UAWARPC_STAGE1, 1e-4, 4e-4, (250000, 325000)),
    2: (UAWARPC_STAGE2, 5e-5, 4e-4, (100000, 150000, 200000)),
}
ALIGN_LR_GAMMA = 0.5


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "refign_tpu_torch entry points run on CUDA by default and no "
            "CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def build_hrda_star(model_type: str = "mit_b5", num_classes: int = 19,
                    dtype: torch.dtype = torch.bfloat16, device="cuda",
                    seed: int = 0, channels: int = 256) -> Segmentor:
    """Eval-mode Refign-HRDA★ on ``device`` with weights drawn from
    ``seed`` (parameters in ``dtype``, BatchNorm statistics fp32).
    ``channels`` sets both heads' widths (256 in the published model)."""
    dev = _resolve_device(device)
    backbone = MixVisionTransformer(model_type=model_type,
                                    drop_path_rate=0.0)
    dims = backbone.embed_dims
    head = DAFormerHead(num_classes, in_channels=dims, channels=channels,
                        embed_dims=channels)
    scale_attention = SegFormerHead(num_classes, in_channels=dims,
                                    channels=channels)
    gen = torch.Generator().manual_seed(seed)
    backbone.init_weights(gen)
    head.init_weights(gen)
    scale_attention.init_weights(gen)
    model = Segmentor(backbone, head, scale_attention)
    cast_floating(model, dtype)
    return model.to(dev).eval().requires_grad_(False)


def hrda_slide_forward(model: Segmentor, img: torch.Tensor,
                       crop_size: Tuple[int, int] = (1080, 1080),
                       stride: Tuple[int, int] = (420, 420)) -> torch.Tensor:
    """(B, H, W, 3) image -> (B, H, W, num_classes) logits through the
    slide + HRDA pipeline of ``bench.py``."""
    with torch.inference_mode():
        return slide_inference(model.whole, img, crop_size, stride)


def deeplabv2_segmentor(model_type: str = "resnet101_v1c",
                        num_classes: int = 19, seed: int = 0,
                        **backbone_kw) -> Segmentor:
    """ResNet v1c (``model_type``) with DeepLabV2's strides and dilations
    and the DeepLabV2 head on layer4, fp32 weights drawn from ``seed``, on
    the CPU; ``backbone_kw`` goes to ``ResNet`` (stem and base widths,
    ``norm_eval``, ...)."""
    backbone = ResNet(model_type, strides=DEEPLABV2_STRIDES,
                      dilations=DEEPLABV2_DILATIONS, **backbone_kw)
    head = DeepLabV2Head(num_classes,
                         in_channels=backbone.out_channels[DEEPLABV2_IN_INDEX],
                         in_index=DEEPLABV2_IN_INDEX)
    gen = torch.Generator().manual_seed(seed)
    backbone.init_weights(gen)
    head.init_weights(gen)
    return Segmentor(backbone, head)


def build_deeplabv2(model_type: str = "resnet101_v1c", num_classes: int = 19,
                    dtype: torch.dtype = torch.bfloat16, device="cuda",
                    seed: int = 0) -> Segmentor:
    """Eval-mode DeepLabV2 of ``refign_deeplabv2.yaml`` on ``device`` with
    weights drawn from ``seed`` (parameters in ``dtype``, BatchNorm
    statistics fp32): ResNet v1c with strides (1, 2, 1, 1) and dilations
    (1, 1, 2, 4), the DeepLabV2 head with ``in_index`` 3."""
    dev = _resolve_device(device)
    model = deeplabv2_segmentor(model_type, num_classes, seed)
    cast_floating(model, dtype)
    return model.to(dev).eval().requires_grad_(False)


def deeplabv2_forward(model: Segmentor, img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, H, W, num_classes) logits through
    ``Segmentor.whole`` (the configurations' whole-image inference at
    540x960, no slide)."""
    with torch.inference_mode():
        return model.whole(img)


def build_alignment(model_type: str = "vgg16",
                    iterative_refinement: bool = False,
                    dtype: torch.dtype = torch.bfloat16, device="cuda",
                    seed: int = 0) -> AlignmentNet:
    """Eval-mode alignment network on ``device`` with weights drawn from
    ``seed`` (parameters in ``dtype``, BatchNorm statistics fp32): VGG-16
    (the only ``model_type`` ported) with ``out_indices`` (2, 3, 4),
    UAWarpC with ``in_index`` (0, 1) and uncertainty estimation."""
    dev = _resolve_device(device)
    backbone = VGG(model_type, out_indices=(2, 3, 4))
    head = UAWarpCHead(in_index=(0, 1), estimate_uncertainty=True,
                       iterative_refinement=iterative_refinement)
    gen = torch.Generator().manual_seed(seed)
    backbone.init_weights(gen)
    head.init_weights(gen)
    net = AlignmentNet(backbone, head)
    cast_floating(net, dtype)
    return net.to(dev).eval().requires_grad_(False)


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


def _hrda_student(model_type: str, cfg: UDAConfig, seed: int,
                  channels: int) -> Segmentor:
    """MiT (drop path, remat) + DAFormer (dropout) + the SegFormer scale
    attention where ``cfg.use_hrda``, fp32, from ``seed``, on the CPU."""
    backbone = MixVisionTransformer(model_type=model_type,
                                    drop_path_rate=UDA_DROP_PATH_RATE,
                                    remat=UDA_REMAT)
    dims = backbone.embed_dims
    head = DAFormerHead(cfg.num_classes, in_channels=dims, channels=channels,
                        embed_dims=channels, dropout_ratio=UDA_DROPOUT_RATIO)
    scale_attention = (SegFormerHead(cfg.num_classes, in_channels=dims,
                                     channels=channels,
                                     dropout_ratio=UDA_DROPOUT_RATIO)
                       if cfg.use_hrda else None)
    gen = torch.Generator().manual_seed(seed)
    backbone.init_weights(gen)
    head.init_weights(gen)
    if scale_attention is not None:
        scale_attention.init_weights(gen)
    return Segmentor(backbone, head, scale_attention,
                     hrda_output_stride=cfg.hrda_output_stride)


def build_uda_trainer(model_type: str = "mit_b5",
                      cfg: Optional[UDAConfig] = None, device="cuda",
                      seed: int = 0, channels: int = 256,
                      max_steps: int = 40000,
                      warmup_iters: int = 1500) -> UDATrainer:
    """A UDA trainer on ``device`` with weights drawn from ``seed``.

    For a ResNet ``model_type`` (``resnet18_v1c``, ``resnet50_v1c``,
    ``resnet101_v1c``) the settings are those of ``refign_deeplabv2.yaml``:
    the DeepLabV2 student (``build_deeplabv2``'s network, fp32 masters, no
    drop path, dropout or remat) and ``REFIGN_DEEPLABV2`` (no HRDA) by
    default; the alignment network, the ImageNet copy, the optimizer and
    the schedule are as below.  ``channels`` is unused there.

    Otherwise the settings are those of ``refign_hrda_star.yaml``: MiT-B5
    with remat and drop path 0.1, DAFormer (256) and the SegFormer scale
    attention (256) with dropout 0.1, HRDA with output stride 4 and HR loss
    weight 0.1, Refign with the frozen VGG-16 + UAWarpC alignment network
    (``build_alignment``, in the compute dtype), adapt-to-reference with
    gamma 0.25, the ImageNet feature distance, DACS with colour jitter
    0.2 / 0.2 and blur, AdamW at 6e-4 with weight decay 0.01 and a
    backbone factor of 0.1, warmup 1500 -> poly(1.0) over 40,000 steps,
    bf16 compute on fp32 masters.  ``cfg`` (default ``REFIGN_HRDA_STAR``)
    also sets the class count of the heads."""
    dev = _resolve_device(device)
    if model_type in RESNETS:
        cfg = REFIGN_DEEPLABV2 if cfg is None else cfg
        if cfg.use_hrda:
            raise ValueError("the DeepLabV2 student has no HRDA scale "
                             "attention; use_hrda must be False")
        student = deeplabv2_segmentor(model_type, cfg.num_classes,
                                      seed).to(dev)
    else:
        cfg = REFIGN_HRDA_STAR if cfg is None else cfg
        student = _hrda_student(model_type, cfg, seed, channels).to(dev)
    opt, sched = make_uda_optimizer(
        student, UDA_BASE_LR, UDA_WEIGHT_DECAY, max_steps,
        backbone_lr_factor=UDA_BACKBONE_LR_FACTOR, warmup_iters=warmup_iters,
        power=UDA_POLY_POWER)
    state = init_uda_state(student, opt, sched, cfg.enable_fdist)
    align_net = None
    if cfg.use_refign and cfg.use_align:
        align_net = build_alignment(dtype=cfg.dtype, device=dev,
                                    seed=seed + 1)
    return UDATrainer(cfg, state, align_net, torch.Generator(device=dev))


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


def build_align_trainer(stage: int = 1, model_type: str = "vgg16",
                        cfg: Optional[align_trainer.AlignConfig] = None,
                        device="cuda", seed: int = 0
                        ) -> align_trainer.AlignTrainer:
    """A UAWarpC trainer on ``device`` with weights drawn from ``seed``.

    The settings are those of ``uawarpc_stage{stage}.yaml``: the frozen
    VGG (``model_type``, VGG-16 in both stages) with ``out_indices`` (2, 3,
    4) in the compute dtype, the UAWarpC head with ``in_index`` (0, 1) and
    uncertainty estimation (fp32 masters, train mode, ``remat_modules``
    per ``cfg``), Adam with the stage's rate and L2 decay 4e-4, and
    MultiStepLR (gamma 0.5) at the stage's milestones.  ``cfg`` (default
    the stage's) sets the step's options, the compute dtype among them."""
    if stage not in ALIGN_STAGES:
        raise ValueError(f"stage must be 1 or 2, got {stage}")
    stage_cfg, lr, wd, milestones = ALIGN_STAGES[stage]
    cfg = stage_cfg if cfg is None else cfg
    dev = _resolve_device(device)
    backbone = VGG(model_type, out_indices=(2, 3, 4))
    head = UAWarpCHead(in_index=(0, 1), estimate_uncertainty=True,
                       remat_modules=cfg.remat_modules)
    gen = torch.Generator().manual_seed(seed)
    backbone.init_weights(gen)
    head.init_weights(gen)
    backbone.to(dev)
    head.to(dev)
    opt, sched = make_adam_optimizer(head.parameters(), lr, milestones,
                                     gamma=ALIGN_LR_GAMMA, weight_decay=wd)
    state = align_trainer.init_align_state(backbone, head, opt, sched,
                                           cfg.dtype)
    return align_trainer.AlignTrainer(cfg, state)


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
        cfg = dataclasses.replace(REFIGN_HRDA_STAR,
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
