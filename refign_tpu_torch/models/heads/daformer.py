"""DAFormer context-aware fusion decode head on NHWC tensors
(counterpart of ``refign_tpu/models/heads/daformer.py``).

Per-stage MLP embeddings upsampled to the 1/4 grid, concatenated, fused by
a depthwise-separable ASPP (dilations 1, 6, 12, 18, no image pool), then a
1x1 classifier.  In train mode its BatchNorms use batch statistics, and the
dropout before the classifier draws from the generator passed to
``forward`` (none: off).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...nn.layers import ConvBNReLU, Dropout2d, MLPEmbed, conv2d, normal_
from ...ops.resize import interpolate
from .base import transform_inputs


class DepthwiseSeparableASPP(nn.Module):
    """ASPP with depthwise-separable dilated branches + bottleneck fuse."""

    def __init__(self, in_channels: int, channels: int,
                 dilations: Sequence[int] = (1, 6, 12, 18)):
        super().__init__()
        self.aspp_modules = nn.ModuleList([
            ConvBNReLU(in_channels, channels, kernel_size=1, padding=0)
            if d == 1 else
            ConvBNReLU(in_channels, channels, kernel_size=3, dilation=d,
                       padding=d, depthwise_separable=True)
            for d in dilations])
        self.bottleneck = ConvBNReLU(len(dilations) * channels, channels,
                                     kernel_size=3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([m(x) for m in self.aspp_modules], dim=-1)
        return self.bottleneck(x)


class DAFormerHead(nn.Module):
    def __init__(self, num_classes: int,
                 in_channels: Sequence[int] = (64, 128, 320, 512),
                 channels: int = 256, embed_dims: int = 256,
                 dropout_ratio: float = 0.1,
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 input_transform: str = "multiple_select"):
        super().__init__()
        if input_transform != "multiple_select":
            raise ValueError("DAFormerHead supports input_transform="
                             f"'multiple_select' only, got {input_transform!r}")
        self.in_index = list(in_index)
        self.input_transform = input_transform
        self.embed_layers = nn.ModuleList([
            MLPEmbed(in_channels[i], embed_dims) for i in self.in_index])
        self.fuse_layer = DepthwiseSeparableASPP(
            len(self.in_index) * embed_dims, channels)
        self.dropout = Dropout2d(dropout_ratio)
        self.conv_seg = conv2d(channels, num_classes, kernel_size=1)

    def forward(self, inputs: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = transform_inputs(inputs, self.in_index, self.input_transform)
        size = feats[0].shape[1:3]
        embedded = []
        for layer, f in zip(self.embed_layers, feats):
            e = layer(f)
            if e.shape[1:3] != size:
                e = interpolate(e, size, mode="bilinear", align_corners=False)
            embedded.append(e)
        x = self.fuse_layer(torch.cat(embedded, dim=-1))
        return self.conv_seg(self.dropout(x, generator))

    def init_weights(self, generator: torch.Generator) -> None:
        """mmseg init: ConvBNReLU kaiming fan_out, MLP embeds torch default,
        classifier N(0, .01) with zero bias."""
        for m in self.embed_layers:
            m.init_weights(generator)
        for m in self.fuse_layer.modules():
            if isinstance(m, ConvBNReLU) and not m.depthwise_separable:
                m.init_weights(generator)
        normal_(self.conv_seg.weight, 0.01, generator)
        nn.init.zeros_(self.conv_seg.bias)
