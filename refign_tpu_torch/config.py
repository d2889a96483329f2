"""YAML config system (counterpart of ``refign_tpu/config.py``).

Parses the reference's LightningCLI schema (helpers/cli.py:10-21,
tools/run.py:1-9): ``model:``, ``data:``, ``optimizer:``,
``lr_scheduler:``, ``trainer:`` sections with ``class_path``/``init_args``.
Reference class paths (``models.backbones.MixVisionTransformer`` etc.) map
onto the port's modules by their last component, so every YAML under
``configs/`` runs unchanged.  The JAX modules infer their input widths at
init; the port's heads take them from the backbone they are built for.

This module owns the whole mapping from a file to the port's objects: the
step settings (``uda_config``, ``align_config``), the networks
(``build_segmentor``, ``build_alignment_net``) and the tasks
(``build_task``).  The CLI and ``entry.py`` both build through it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import yaml


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "refign_tpu_torch entry points run on CUDA by default and no "
            "CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def precision_dtype(precision) -> str:
    """reference --trainer.precision {16,32} -> compute dtype
    (16/'16'/'bf16' => bfloat16)."""
    if str(precision) in ("16", "bf16", "bfloat16"):
        return "bfloat16"
    return "float32"


def class_name(spec: Dict[str, Any]) -> str:
    return spec["class_path"].rsplit(".", 1)[-1]


def init_args(spec: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    return dict((spec or {}).get("init_args") or {})


def _known(args: Dict[str, Any], names: Sequence[str],
           tuples: Sequence[str] = ()) -> Dict[str, Any]:
    out = {k: v for k, v in args.items() if k in names}
    for k in tuples:
        if k in out and isinstance(out[k], (list, tuple)):
            out[k] = tuple(out[k])
    return out


# ---------------------------------------------------------------------------
# model component builders
# ---------------------------------------------------------------------------

def build_backbone(spec: Dict[str, Any]):
    """Returns (module, pretrained_path_or_keyword).  Arguments neither
    package knows are ignored."""
    from .models.mix_transformer import MixVisionTransformer
    from .models.resnet import ResNet
    from .models.vgg import VGG
    name = class_name(spec)
    args = init_args(spec)
    pretrained = args.pop("pretrained", None)
    if name == "MixVisionTransformer":
        return MixVisionTransformer(**_known(
            args, ("model_type", "drop_path_rate", "qk_scale", "in_chans",
                   "remat", "remat_policy"))), pretrained
    if name == "ResNet":
        return ResNet(**_known(
            args, ("model_type", "strides", "dilations", "out_indices",
                   "contract_dilation", "norm_eval", "max_pool_ceil_mode",
                   "stem_channels", "base_channels"),
            ("strides", "dilations", "out_indices"))), pretrained
    if name == "VGG":
        return VGG(**_known(args, ("model_type", "out_indices"),
                            ("out_indices",))), pretrained
    raise ValueError(f"unknown backbone {name}")


def backbone_widths(backbone) -> list:
    """Channel widths of the backbone's output levels."""
    if hasattr(backbone, "embed_dims"):
        return list(backbone.embed_dims)
    return list(backbone.out_channels)


def build_head(spec: Dict[str, Any], in_channels: Sequence[int] = ()):
    """Returns (module, pretrained).  ``in_channels``: the widths of the
    backbone levels the head reads (unused by UAWarpC)."""
    from .models.heads.daformer import DAFormerHead
    from .models.heads.deeplabv2 import DeepLabV2Head
    from .models.heads.segformer import SegFormerHead
    from .models.heads.uawarpc import UAWarpCHead
    name = class_name(spec)
    args = init_args(spec)
    pretrained = args.pop("pretrained", None)
    if name == "DAFormerHead":
        known = _known(args, ("num_classes", "channels", "embed_dims",
                              "dropout_ratio", "in_index"), ("in_index",))
        idx = known.get("in_index", (0, 1, 2, 3))
        return DAFormerHead(in_channels=[in_channels[i] for i in idx],
                            **known), pretrained
    if name == "SegFormerHead":
        known = _known(args, ("num_classes", "channels", "dropout_ratio",
                              "in_index"), ("in_index",))
        idx = known.get("in_index", (0, 1, 2, 3))
        return SegFormerHead(in_channels=[in_channels[i] for i in idx],
                             **known), pretrained
    if name == "DeepLabV2Head":
        known = _known(args, ("num_classes", "dilation_series", "in_index",
                              "input_transform"), ("dilation_series",))
        idx = known.get("in_index", -1)
        if not isinstance(idx, int):
            raise ValueError("DeepLabV2Head: in_index must be one level")
        return DeepLabV2Head(in_channels=in_channels[idx], **known), \
            pretrained
    if name == "UAWarpCHead":
        return UAWarpCHead(**_known(
            args, ("in_index", "batch_norm", "refinement_at_adaptive_res",
                   "refinement_at_finest_level", "estimate_uncertainty",
                   "iterative_refinement"), ("in_index",))), pretrained
    raise ValueError(f"unknown head {name}")


def build_segmentor(model_args: Dict[str, Any], seed: int = 0):
    """The segmentor of a model section: backbone, head and (with
    ``use_hrda``) the ``hrda_scale_attention``, their weights drawn in that
    order from one generator seeded with ``seed``, fp32 on the CPU.  No
    ``pretrained`` file is loaded."""
    from .models.segmentor import Segmentor
    backbone, _ = build_backbone(model_args["backbone"])
    widths = backbone_widths(backbone)
    head, _ = build_head(model_args["head"], widths)
    scale_attention = None
    if model_args.get("use_hrda", False) and \
            model_args.get("hrda_scale_attention"):
        scale_attention, _ = build_head(model_args["hrda_scale_attention"],
                                        widths)
    gen = torch.Generator().manual_seed(seed)
    for m in (backbone, head, scale_attention):
        if m is not None:
            m.init_weights(gen)
    return Segmentor(backbone, head, scale_attention,
                     hrda_output_stride=model_args.get("hrda_output_stride",
                                                       4))


def build_alignment_net(model_args: Dict[str, Any], seed: int = 0):
    """The alignment network of a model section (``alignment_backbone``,
    ``alignment_head``), its weights drawn from ``seed``, fp32 on the CPU.
    No ``pretrained`` file is loaded."""
    from .alignment.trainer import AlignmentNet
    backbone, _ = build_backbone(model_args["alignment_backbone"])
    head, _ = build_head(model_args["alignment_head"])
    gen = torch.Generator().manual_seed(seed)
    backbone.init_weights(gen)
    head.init_weights(gen)
    return AlignmentNet(backbone, head)


# ---------------------------------------------------------------------------
# step settings
# ---------------------------------------------------------------------------

def _normalization(datamodule, data_normalize: bool) -> Dict[str, Any]:
    """``norm_mean`` / ``norm_std`` of the data section's Normalize, or
    nothing (the configs' default constants) where it has none or
    ``data_normalize`` is off."""
    norm = getattr(datamodule, "normalize_settings", None)
    if not (data_normalize and norm):
        return {}
    return {"norm_mean": tuple(norm["mean"]), "norm_std": tuple(norm["std"])}


# the model keys each step reads under its own field names; a key the file
# leaves out keeps the field's default
_UDA_KEYS = ("use_hrda", "hrda_output_stride", "hr_loss_weight", "use_refign",
             "use_align", "adapt_to_ref", "gamma", "disable_M", "disable_P",
             "ema_momentum", "pseudo_label_threshold", "psweight_ignore_top",
             "psweight_ignore_bottom", "enable_fdist", "fdist_lambda",
             "fdist_classes", "fdist_scale_min_ratio", "color_jitter_s",
             "color_jitter_p", "blur")
_ALIGN_FLAGS = ("apply_constant_flow_weights", "remat_head", "remat_skip_last",
                "fold_passes")
_FLOW_KEYS = ("include_transforms", "random_alpha", "random_s", "random_tx",
              "random_ty", "random_t_hom", "random_t_tps",
              "random_t_tps_for_afftps", "add_elastic", "crop_after_flow")


def uda_config(model_args: Dict[str, Any], trainer_cfg: Dict[str, Any],
               datamodule=None, data_normalize: bool = True):
    """A ``DomainAdaptationSegmentationModel`` section -> ``UDAConfig``.
    ``device_normalize`` and the normalisation constants come from
    ``datamodule``; with ``data_normalize`` off, normalisation stays off
    the device with the default constants."""
    from .uda.trainer import UDAConfig
    return UDAConfig(
        num_classes=init_args(model_args["head"]).get("num_classes", 19),
        compute_dtype=precision_dtype((trainer_cfg or {}).get("precision",
                                                              16)),
        device_normalize=data_normalize and bool(
            getattr(datamodule, "device_normalize", False)),
        **_known(model_args, _UDA_KEYS, ("fdist_classes",)),
        **_normalization(datamodule, data_normalize))


def align_config(model_args: Dict[str, Any], trainer_cfg: Dict[str, Any],
                 datamodule=None, data_normalize: bool = True):
    """An ``AlignmentModel`` section -> ``AlignConfig``.  The synthetic
    flow, its crop and the prime view's photometric settings come from
    ``datamodule``'s train pipeline, and so do the normalisation constants
    unless ``data_normalize`` is off."""
    from .alignment.trainer import AlignConfig
    flow = getattr(datamodule, "composite_flow_settings", None) or {}
    prime = getattr(datamodule, "prime_photometric_settings", None) or {}
    unsupervised = init_args(model_args.get("unsupervised_loss"))
    return AlignConfig(
        compute_dtype=precision_dtype((trainer_cfg or {}).get("precision",
                                                              16)),
        remat_head_policy=model_args.get("remat_head_policy"),
        remat_modules=bool(model_args.get("remat_modules", True)),
        **{k: bool(v) for k, v in _known(model_args, _ALIGN_FLAGS).items()},
        **{"prime_" + k: v for k, v in prime.items()},
        **_known(flow, _FLOW_KEYS, ("include_transforms",)),
        **_known(unsupervised, ("visibility_mask", "alpha_1", "alpha_2")),
        **_normalization(datamodule, data_normalize))


# ---------------------------------------------------------------------------
# optimizer / schedule specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OptimizerSpec:
    name: str               # 'AdamW' | 'Adam'
    lr: float
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)


@dataclasses.dataclass
class SchedulerSpec:
    name: str               # 'LinearWarmupPolynomialLR' | 'MultiStepLR'
    warmup_iters: int = 1500
    warmup_ratio: float = 1e-6
    power: float = 0.9
    min_lr: float = 0.0
    milestones: Tuple[int, ...] = ()
    gamma: float = 0.5
    max_steps: Optional[int] = None


def parse_optimizer(spec: Dict[str, Any]) -> OptimizerSpec:
    args = init_args(spec)
    return OptimizerSpec(
        name=class_name(spec),
        lr=float(args.get("lr", 1e-3)),
        weight_decay=float(args.get("weight_decay", 0.0)),
        betas=tuple(args.get("betas", (0.9, 0.999))),
    )


def parse_scheduler(spec: Dict[str, Any],
                    max_steps: Optional[int]) -> SchedulerSpec:
    args = init_args(spec)
    return SchedulerSpec(
        name=class_name(spec),
        warmup_iters=int(args.get("warmup_iters", 1500)),
        warmup_ratio=float(args.get("warmup_ratio", 1e-6)),
        power=float(args.get("power", 0.9)),
        min_lr=float(args.get("min_lr", 0.0)),
        milestones=tuple(args.get("milestones", ())),
        gamma=float(args.get("gamma", 0.5)),
        max_steps=int(args.get("max_steps") or max_steps or 40000),
    )


def parse_metrics(metrics_cfg: Dict[str, Any]) -> Dict[str, Dict[str, list]]:
    """{'val': {ds: [metric spec]}, ...} -> {'val': {ds: [(name, args)]}}"""
    out = {}
    for stage, per_ds in (metrics_cfg or {}).items():
        out[stage] = {}
        for ds, specs in per_ds.items():
            out[stage][ds] = [(class_name(s), init_args(s)) for s in specs]
    return out


def build_datamodule(cfg: Dict[str, Any], data_dir: Optional[str] = None):
    from .data.module import CombinedDataModule
    args = init_args(cfg)
    args.pop("pin_memory", None)
    if data_dir:
        args["data_dir"] = data_dir
    return CombinedDataModule(**args)


def build_task(cfg: Dict[str, Any], data_dir: Optional[str] = None,
               device="cuda", data_normalize: bool = True):
    """Top-level: config dict -> (task, datamodule), the task on
    ``device`` (which raises when it is ``cuda`` and there is no card).
    ``data_normalize``: as in :func:`uda_config`."""
    model_cfg = cfg["model"]
    name = class_name(model_cfg)
    datamodule = build_datamodule(cfg["data"], data_dir)
    trainer_cfg = cfg.get("trainer", {}) or {}
    opt = parse_optimizer(cfg.get("optimizer", {
        "class_path": "AdamW", "init_args": {"lr": 6e-4}}))
    sched = parse_scheduler(cfg.get("lr_scheduler", {
        "class_path": "LinearWarmupPolynomialLR"}),
        trainer_cfg.get("max_steps"))
    if name == "DomainAdaptationSegmentationModel":
        from .tasks.seg_task import SegTask
        return SegTask(init_args(model_cfg), opt, sched, trainer_cfg,
                       datamodule, device=device,
                       data_normalize=data_normalize), datamodule
    if name == "AlignmentModel":
        from .tasks.align_task import AlignTask
        return AlignTask(init_args(model_cfg), opt, sched, trainer_cfg,
                         datamodule, device=device,
                         data_normalize=data_normalize), datamodule
    raise ValueError(f"unknown model class {name}")
