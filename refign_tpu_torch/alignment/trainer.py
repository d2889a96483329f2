"""Forward of the frozen UAWarpC alignment network (counterpart of
``align_forward`` in ``refign_tpu/alignment/trainer.py``; its training
step comes with UAWarpC training).

Both callers, ``align_forward`` here and the UDA align step, batch the
backbone the same way: one call on ``cat([source, target])`` at the image
size with ``extract_only_indices=[-3, -2]``, one on the 256^2
area-resized pair with ``[-2, -1]``; the head then matches the target
(first argument) against the source.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.resize import interpolate
from ..ops.warp import confidence_from_logvar


class AlignmentNet(nn.Module):
    """The alignment network: a VGG pyramid ``backbone`` and a UAWarpC
    ``head`` with uncertainty estimation."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    @property
    def dtype(self) -> torch.dtype:
        return next(self.head.parameters()).dtype


def flow_and_logvar(net: AlignmentNet, images_trg: torch.Tensor,
                    images_src: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finest-level flow target -> source and its log-variance, upsampled
    to the image size, both fp32.  Images (B, H, W, 3) are cast to the
    network's dtype first."""
    B, H, W = images_trg.shape[:3]
    images_trg = images_trg.to(net.dtype)
    images_src = images_src.to(net.dtype)

    def to256(x):
        return interpolate(x, (256, 256), mode="area")

    full = net.backbone(torch.cat([images_src, images_trg]),
                        extract_only_indices=[-3, -2])
    small = net.backbone(torch.cat([to256(images_src), to256(images_trg)]),
                         extract_only_indices=[-2, -1])
    pyr_src = [f[:B] for f in full]
    pyr_trg = [f[B:] for f in full]
    pyr_src_256 = [f[:B] for f in small]
    pyr_trg_256 = [f[B:] for f in small]
    flow, logvar = net.head(pyr_trg, pyr_src, pyr_trg_256, pyr_src_256,
                            (H, W))[-1]
    flow = interpolate(flow, (H, W), mode="bilinear", align_corners=False)
    logvar = interpolate(logvar, (H, W), mode="bilinear",
                         align_corners=False)
    return flow, logvar


def align_forward(net: AlignmentNet, images_i: torch.Tensor,
                  images_j: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AlignmentModel.forward: flow i -> j at the image size (B, H, W, 2)
    and the uncertainty 1 - P_R (B, H, W, 1), R = 1."""
    flow, logvar = flow_and_logvar(net, images_i, images_j)
    return flow, 1.0 - confidence_from_logvar(logvar, R=1.0)
