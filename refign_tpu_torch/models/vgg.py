"""VGG feature-pyramid backbone for UAWarpC on NHWC tensors
(counterpart of ``refign_tpu/models/vgg.py``).

torchvision's VGG configurations (vgg11/13/16/19, each with or without
BatchNorm), exposing per-level features: the levels are [after the first
ReLU, after pool1, ..., after pool5], filtered by ``out_indices`` at
construction and by ``extract_only_indices`` per call.  Like the JAX
module it holds the layers up to the last level of ``out_indices`` only,
and the forward stops after the last level it needs.  Parameter keys are
torchvision's ``features.{i}`` (the conv, and ``features.{i+1}`` its BN in
the ``_bn`` variants), which fuse to the flax ``features_{i}``.  The BN
layers always normalise with their running statistics, as the JAX module
calls them with ``use_running_average=True``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..nn.layers import TorchBatchNorm, conv2d, init_convs_kaiming_fanout_
from .matching_modules import max_pool_2x2

CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}

# model_type -> (configuration, BatchNorm after each conv)
ARCH_SETTINGS = {
    "vgg11": ("A", False), "vgg11_bn": ("A", True),
    "vgg13": ("B", False), "vgg13_bn": ("B", True),
    "vgg16": ("D", False), "vgg16_bn": ("D", True),
    "vgg19": ("E", False), "vgg19_bn": ("E", True),
}


class VGG(nn.Module):
    def __init__(self, model_type: str = "vgg16",
                 out_indices: Sequence[int] = (0, 1, 2, 3, 4, 5)):
        super().__init__()
        if model_type not in ARCH_SETTINGS:
            raise ValueError(f"unknown VGG model_type {model_type!r}; one of "
                             f"{sorted(ARCH_SETTINGS)}")
        cfg_key, batch_norm = ARCH_SETTINGS[model_type]
        cfg = CFGS[cfg_key]
        step = 3 if batch_norm else 2  # conv (+ BN) + ReLU positions
        # level marks: torch Sequential positions after which a level is
        # emitted (after the first conv's ReLU, then after every pool)
        level_marks, idx = [], 0
        for v in cfg:
            idx += 1 if v == "M" else step
            if v == "M" or not level_marks:
                level_marks.append(idx)
        self.selected = [level_marks[i] for i in out_indices]
        # layers up to the last selected level only, as the JAX module
        # creates them: ("pool", None) or ("conv", Sequential index)
        self.plan, features = [], {}
        idx, cin = 0, 3
        for v in cfg:
            if idx >= max(self.selected):
                break
            if v == "M":
                self.plan.append(("pool", None))
                idx += 1
                continue
            self.plan.append(("conv", idx))
            features[str(idx)] = conv2d(cin, v, kernel_size=3, padding=1)
            if batch_norm:
                features[str(idx + 1)] = TorchBatchNorm(v)
            idx += step
            cin = v
        self.step = step
        self.features = nn.ModuleDict(features)
        self.train(self.training)

    def train(self, mode: bool = True) -> "VGG":
        """Train or eval mode for the module; its BatchNorm layers stay on
        their running statistics either way."""
        super().train(mode)
        for m in self.features.values():
            if isinstance(m, TorchBatchNorm):
                m.eval()
        return self

    def forward(self, x: torch.Tensor,
                extract_only_indices: Optional[Sequence[int]] = None
                ) -> List[torch.Tensor]:
        selected = self.selected
        if extract_only_indices is not None:
            selected = [selected[i] for i in extract_only_indices]
        last_needed = max(selected)
        outs, pos = [], 0
        for kind, i in self.plan:
            if pos >= last_needed:
                break
            if kind == "pool":
                x = max_pool_2x2(x)
                pos += 1
            else:
                x = self.features[str(i)](x)
                if self.step == 3:
                    x = self.features[str(i + 1)](x)
                x = torch.relu(x)
                pos += self.step
            if pos in selected:
                outs.append(x)
        return outs

    def init_weights(self, generator: torch.Generator) -> None:
        """Kaiming fan-out convs with zero bias."""
        init_convs_kaiming_fanout_(self, generator)
