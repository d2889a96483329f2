"""Build the plain reference of each configuration from its file in
``benchmark/configs``.  Modules are made on the device given (``meta`` for
shapes and operation counts) with uninitialised tensors; the benchmark
loads the weights it made from the seed."""
from __future__ import annotations

from typing import Optional

import torch

from .align import AlignTrainer
from .segformer import Segmentor
from .uawarpc import AlignmentNet
from .uda import UDATrainer


def student_overrides(overrides: dict) -> dict:
    """A test's smaller student from a run's overrides: its backbone, and
    one width for both heads (as the port's ``channels``)."""
    return {k: overrides[k] for k in ("backbone", "channels")
            if k in overrides}


def segmentor(cfg: dict, train: bool, device,
              overrides: Optional[dict] = None) -> Segmentor:
    """MiT + DAFormer + the SegFormer scale attention of ``cfg['student']``
    (``overrides``: ``backbone``, ``channels`` for both heads); drop path
    and dropout only where ``train``."""
    s, o = cfg["student"], overrides or {}
    ch = o.get("channels", s["channels"])
    att = o.get("channels", s["scale_attention_channels"])
    with torch.device(device):
        return Segmentor(o.get("backbone", s["backbone"]), s["num_classes"],
                         ch, att, s["drop_path_rate"] if train else 0.0,
                         s["dropout_ratio"] if train else 0.0,
                         s["hrda_output_stride"])


def alignment_net(cfg: dict, device) -> AlignmentNet:
    """The frozen VGG-16 + UAWarpC network of ``cfg['align_net']``."""
    with torch.device(device):
        return AlignmentNet(cfg["align_net"]["backbone"]).eval()


def uda_trainer(cfg: dict, device,
                overrides: Optional[dict] = None) -> UDATrainer:
    return UDATrainer(cfg, segmentor(cfg, True, device, overrides),
                      alignment_net(cfg, device))


def align_trainer(cfg: dict, device,
                  vgg: Optional[str] = None) -> AlignTrainer:
    with torch.device(device):
        return AlignTrainer(cfg, vgg or cfg["backbone"]["name"])
