"""YAML config system (counterpart of ``refign_tpu/config.py``).

Parses the reference's LightningCLI schema (helpers/cli.py:10-21,
tools/run.py:1-9): ``model:``, ``data:``, ``optimizer:``,
``lr_scheduler:``, ``trainer:`` sections with ``class_path``/``init_args``.
Reference class paths (``models.backbones.MixVisionTransformer`` etc.) map
onto the port's modules by their last component, so every YAML under
``configs/`` runs unchanged.  The JAX modules infer their input widths at
init; the port's heads take them from the backbone they are built for.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import yaml


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
    """Returns (module, pretrained_path_or_keyword).  The JAX package's
    TPU remat policy (``remat_policy``) has no counterpart and is
    ignored, as are arguments neither package knows."""
    from .models.mix_transformer import MixVisionTransformer
    from .models.resnet import ResNet
    from .models.vgg import VGG
    name = class_name(spec)
    args = init_args(spec)
    pretrained = args.pop("pretrained", None)
    if name == "MixVisionTransformer":
        return MixVisionTransformer(**_known(
            args, ("model_type", "drop_path_rate", "qk_scale", "in_chans",
                   "remat"))), pretrained
    if name == "ResNet":
        return ResNet(**_known(
            args, ("model_type", "strides", "dilations", "out_indices",
                   "contract_dilation", "norm_eval", "max_pool_ceil_mode"),
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
        for opt in ("batch_norm", "refinement_at_adaptive_res",
                    "refinement_at_finest_level"):
            if not args.get(opt, True):
                raise ValueError(f"UAWarpCHead: {opt}=False is not ported "
                                 "(every configuration leaves it True)")
        return UAWarpCHead(**_known(
            args, ("in_index", "estimate_uncertainty",
                   "iterative_refinement"), ("in_index",))), pretrained
    raise ValueError(f"unknown head {name}")


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
               device="cuda"):
    """Top-level: config dict -> (task, datamodule), the task on
    ``device`` (which raises when it is ``cuda`` and there is no card)."""
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
                       datamodule, device=device), datamodule
    if name == "AlignmentModel":
        from .tasks.align_task import AlignTask
        return AlignTask(init_args(model_cfg), opt, sched, trainer_cfg,
                         datamodule, device=device), datamodule
    raise ValueError(f"unknown model class {name}")
