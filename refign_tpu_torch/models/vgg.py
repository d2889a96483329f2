"""VGG-16 feature-pyramid backbone for UAWarpC on NHWC tensors
(counterpart of ``refign_tpu/models/vgg.py``).

torchvision's VGG-16 (config "D", no BatchNorm), the one every shipped
config uses, exposing per-level features: the levels are [after the first
ReLU, after pool1, ..., after pool5], filtered by ``out_indices`` at
construction and by ``extract_only_indices`` per call.  Like the JAX
module it holds the layers up to the last level of ``out_indices`` only,
and the forward stops after the last level it needs.  Parameter keys are
torchvision's ``features.{i}``, which fuse to the flax ``features_{i}``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..nn.layers import conv2d, init_convs_kaiming_fanout_
from .matching_modules import max_pool_2x2

VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]


class VGG(nn.Module):
    def __init__(self, model_type: str = "vgg16",
                 out_indices: Sequence[int] = (0, 1, 2, 3, 4, 5)):
        super().__init__()
        if model_type != "vgg16":
            raise ValueError(f"only vgg16 is ported, got {model_type!r}")
        # level marks: torch Sequential positions after which a level is
        # emitted (after the first conv's ReLU, then after every pool)
        level_marks, idx = [], 0
        for v in VGG16_CFG:
            idx += 1 if v == "M" else 2
            if v == "M" or not level_marks:
                level_marks.append(idx)
        self.selected = [level_marks[i] for i in out_indices]
        # layers up to the last selected level only, as the JAX module
        # creates them: ("pool", None) or ("conv", Sequential index)
        self.plan, features = [], {}
        idx, cin = 0, 3
        for v in VGG16_CFG:
            if idx >= max(self.selected):
                break
            if v == "M":
                self.plan.append(("pool", None))
                idx += 1
                continue
            self.plan.append(("conv", idx))
            features[str(idx)] = conv2d(cin, v, kernel_size=3, padding=1)
            idx += 2
            cin = v
        self.features = nn.ModuleDict(features)

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
                x = torch.relu(self.features[str(i)](x))
                pos += 2
            if pos in selected:
                outs.append(x)
        return outs

    def init_weights(self, generator: torch.Generator) -> None:
        """Kaiming fan-out convs with zero bias."""
        init_convs_kaiming_fanout_(self, generator)
