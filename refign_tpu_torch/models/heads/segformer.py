"""SegFormer all-MLP decode head on NHWC tensors (counterpart of
``refign_tpu/models/heads/segformer.py``).

Each stage feature is linearly embedded, bilinearly upsampled
(align_corners=False) to the 1/4 grid, concatenated in [c4, c3, c2, c1]
order, fused by a 1x1 ConvBNReLU and classified 1x1.  HRDA uses it as its
scale-attention head.  Train mode as in the DAFormer head: batch-statistics
BN, dropout from the generator passed to ``forward``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...nn.layers import ConvBNReLU, Dropout2d, MLPEmbed, conv2d, normal_
from ...ops.resize import interpolate
from .base import transform_inputs


class SegFormerHead(nn.Module):
    def __init__(self, num_classes: int,
                 in_channels: Sequence[int] = (64, 128, 320, 512),
                 channels: int = 256, dropout_ratio: float = 0.1,
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 input_transform: str = "multiple_select"):
        super().__init__()
        if input_transform != "multiple_select":
            raise ValueError("SegFormerHead supports input_transform="
                             f"'multiple_select' only, got {input_transform!r}")
        self.in_index = list(in_index)
        self.input_transform = input_transform
        c1, c2, c3, c4 = (in_channels[i] for i in self.in_index)
        self.linear_c4 = MLPEmbed(c4, channels)
        self.linear_c3 = MLPEmbed(c3, channels)
        self.linear_c2 = MLPEmbed(c2, channels)
        self.linear_c1 = MLPEmbed(c1, channels)
        self.linear_fuse = ConvBNReLU(4 * channels, channels, kernel_size=1)
        self.dropout = Dropout2d(dropout_ratio)
        self.linear_pred = conv2d(channels, num_classes, kernel_size=1)

    def forward(self, inputs: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c1, c2, c3, c4 = transform_inputs(inputs, self.in_index,
                                          self.input_transform)
        size = c1.shape[1:3]

        def embed_up(layer, c):
            e = layer(c)
            if e.shape[1:3] != size:
                e = interpolate(e, size, mode="bilinear", align_corners=False)
            return e

        x = torch.cat([embed_up(self.linear_c4, c4),
                       embed_up(self.linear_c3, c3),
                       embed_up(self.linear_c2, c2),
                       embed_up(self.linear_c1, c1)], dim=-1)
        x = self.linear_fuse(x)
        return self.linear_pred(self.dropout(x, generator))

    def init_weights(self, generator: torch.Generator) -> None:
        """mmseg init: MLP embeds torch default, fuse conv kaiming fan_out,
        classifier N(0, .01) with zero bias."""
        for m in (self.linear_c4, self.linear_c3, self.linear_c2,
                  self.linear_c1, self.linear_fuse):
            m.init_weights(generator)
        normal_(self.linear_pred.weight, 0.01, generator)
        nn.init.zeros_(self.linear_pred.bias)
