"""DeepLabV2 ASPP head on NHWC tensors (counterpart of
``refign_tpu/models/heads/deeplabv2.py``): the sum of four parallel 3x3
convs with bias at dilation = padding = 6, 12, 18, 24
(``conv2d_list.{0..3}``)."""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ...nn.layers import conv2d, normal_
from .base import transform_inputs


class DeepLabV2Head(nn.Module):
    def __init__(self, num_classes: int, in_channels: int = 2048,
                 dilation_series: Sequence[int] = (6, 12, 18, 24),
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None):
        super().__init__()
        self.in_index = in_index
        self.input_transform = input_transform
        self.conv2d_list = nn.ModuleList(
            conv2d(in_channels, num_classes, 3, 1, d, d)
            for d in dilation_series)

    def forward(self, inputs: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits at the input feature's resolution; ``generator`` is unused
        (the head has no dropout)."""
        x = transform_inputs(inputs, self.in_index, self.input_transform)
        out = None
        for conv in self.conv2d_list:
            y = conv(x)
            out = y if out is None else out + y
        return out

    def init_weights(self, generator: torch.Generator) -> None:
        """Reference init (``refign_tpu/models/heads/deeplabv2.py:26``):
        weights N(0, 0.01), zero bias."""
        for conv in self.conv2d_list:
            normal_(conv.weight, 0.01, generator)
            nn.init.zeros_(conv.bias)
