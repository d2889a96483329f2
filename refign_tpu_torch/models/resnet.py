"""mmseg-style ResNet v1c backbone on NHWC tensors (counterpart of
``refign_tpu/models/resnet.py``).

Deep 3x3-conv stem (``stem.{0..8}``), BasicBlock / Bottleneck stages with
configurable strides and dilations (DeepLabV2: strides (1, 2, 1, 1),
dilations (1, 1, 2, 4)), ``contract_dilation``, ``norm_eval`` and
``max_pool_ceil_mode``.  Parameter names are the reference's torch keys
(``layer1.0.conv1``, ``layer1.0.downsample.0``), so the JAX package's
``convert_state_dict`` and :mod:`..utils.jax_convert` map them.  BatchNorm
follows the module's mode: batch statistics in train mode, running ones in
eval mode or with ``norm_eval``, which keeps every BatchNorm in eval mode
whatever ``train()`` sets.  ``remat`` recomputes each residual block in the
backward (the reference's ``with_cp``), updating its BatchNorm running
statistics once (:func:`..nn.layers.remat_call`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import (TorchBatchNorm, TorchConv, conv2d,
                         kaiming_normal_fanout_, remat_call)

__all__ = ["ARCH_SETTINGS", "max_pool_3x3_s2", "BasicBlock", "Bottleneck",
           "ResNet"]

ARCH_SETTINGS = {
    "resnet18_v1c": dict(block="basic", stage_blocks=(2, 2, 2, 2)),
    "resnet50_v1c": dict(block="bottleneck", stage_blocks=(3, 4, 6, 3)),
    "resnet101_v1c": dict(block="bottleneck", stage_blocks=(3, 4, 23, 3)),
}


def max_pool_3x3_s2(x: torch.Tensor, ceil_mode: bool = False) -> torch.Tensor:
    """torch ``MaxPool2d(3, stride=2, padding=1, ceil_mode)`` on NHWC (the
    JAX package pads with -inf, and one more bottom/right row where
    ``(dim + 2 - 3) % 2 != 0`` in ceil mode: the same windows)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1, ceil_mode=ceil_mode)
    return y.permute(0, 2, 3, 1)


class BasicBlock(nn.Module):
    """Two 3x3 convs (``refign_tpu/models/resnet.py:48-79``); the stride
    and dilation on the first."""
    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = conv2d(in_channels, planes, 3, stride, dilation,
                            dilation, bias=False)
        self.bn1 = TorchBatchNorm(planes)
        self.conv2 = conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = TorchBatchNorm(planes)
        self.downsample = (nn.Sequential(
            conv2d(in_channels, planes, 1, stride, 0, bias=False),
            TorchBatchNorm(planes)) if has_downsample else None)

    def last_bn(self) -> TorchBatchNorm:
        return self.bn2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1, 3x3 (stride, dilation), 1x1 x4 (``refign_tpu/models/
    resnet.py:81-119``, style 'pytorch')."""
    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = conv2d(in_channels, planes, 1, 1, 0, bias=False)
        self.bn1 = TorchBatchNorm(planes)
        self.conv2 = conv2d(planes, planes, 3, stride, dilation, dilation,
                            bias=False)
        self.bn2 = TorchBatchNorm(planes)
        self.conv3 = conv2d(planes, out, 1, 1, 0, bias=False)
        self.bn3 = TorchBatchNorm(out)
        self.downsample = (nn.Sequential(
            conv2d(in_channels, out, 1, stride, 0, bias=False),
            TorchBatchNorm(out)) if has_downsample else None)

    def last_bn(self) -> TorchBatchNorm:
        return self.bn3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet v1c (``refign_tpu/models/resnet.py:122-184``); ``forward``
    returns the stage outputs of ``out_indices``."""

    def __init__(self, model_type: str = "resnet101_v1c",
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 stem_channels: int = 64, base_channels: int = 64,
                 contract_dilation: bool = False, norm_eval: bool = False,
                 max_pool_ceil_mode: bool = False, remat: bool = False):
        super().__init__()
        if model_type not in ARCH_SETTINGS:
            raise ValueError(f"unknown ResNet {model_type!r}; one of "
                             f"{sorted(ARCH_SETTINGS)}")
        cfg = ARCH_SETTINGS[model_type]
        block = BasicBlock if cfg["block"] == "basic" else Bottleneck
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        self.max_pool_ceil_mode = max_pool_ceil_mode
        self.remat = remat
        c = stem_channels
        stem = []
        for cin, cout, stride in ((3, c // 2, 2), (c // 2, c // 2, 1),
                                  (c // 2, c, 1)):
            stem += [conv2d(cin, cout, 3, stride, 1, bias=False),
                     TorchBatchNorm(cout), nn.ReLU()]
        self.stem = nn.Sequential(*stem)
        in_ch = stem_channels
        self.out_channels = []
        for si, num_blocks in enumerate(cfg["stage_blocks"]):
            stride, dilation = strides[si], dilations[si]
            planes = base_channels * 2 ** si
            out_ch = planes * block.expansion
            # the first block of a dilated stage takes half the dilation
            # where contract_dilation; it downsamples where the stride or
            # the width changes (layer1's stride-1 downsample)
            first_dil = (dilation // 2 if dilation > 1 and contract_dilation
                         else dilation)
            blocks = [block(in_ch, planes, stride, first_dil,
                            stride != 1 or in_ch != out_ch)]
            blocks += [block(out_ch, planes, 1, dilation)
                       for _ in range(num_blocks - 1)]
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))
            in_ch = out_ch
            self.out_channels.append(out_ch)

    def stages(self) -> List[nn.Sequential]:
        return [getattr(self, f"layer{i + 1}") for i in range(4)]

    def train(self, mode: bool = True) -> "ResNet":
        """Train mode, with every BatchNorm kept in eval mode where
        ``norm_eval`` (reference ``resnet.py:378-385``)."""
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, TorchBatchNorm):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """(B, H, W, 3) -> the NHWC stage outputs of ``out_indices``;
        ``generator`` is unused (the network has no dropout)."""
        x = max_pool_3x3_s2(self.stem(x), self.max_pool_ceil_mode)
        remat = self.remat and torch.is_grad_enabled()
        outs = []
        for si, stage in enumerate(self.stages()):
            for blk in stage:
                x = remat_call(blk, x) if remat else blk(x)
            if si in self.out_indices:
                outs.append(x)
        return outs

    def init_weights(self, generator: torch.Generator) -> None:
        """Reference init (``refign_tpu/models/resnet.py:20-22``): Kaiming
        normal fan-out on every conv, BatchNorm ones/zeros, and a zero
        scale on the last BatchNorm of each residual branch."""
        for m in self.modules():
            if isinstance(m, TorchConv):
                kaiming_normal_fanout_(m.weight, generator)
            elif isinstance(m, TorchBatchNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for stage in self.stages():
            for blk in stage:
                nn.init.zeros_(blk.last_bn().weight)
