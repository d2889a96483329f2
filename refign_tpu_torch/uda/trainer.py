"""The align step of Refign's UDA train step (counterpart of ``align_fn``
in ``refign_tpu/uda/trainer.py``); the teacher forward, ClassMix and the
losses come with the training slice.

Order matters and is easy to get wrong with a plausible-looking result:
the reference image goes first into the backbone batch, the adverse target
is the head's target, and the reference logits are warped by the flow
target -> reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..alignment.trainer import AlignmentNet, flow_and_logvar
from ..ops.warp import confidence_from_logvar, warp


def align_fn(net: AlignmentNet, logits_ref: torch.Tensor,
             images_ref: torch.Tensor, images_trg: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warp the reference logits onto the target view.  Returns the warped
    logits (logits_ref's dtype), the strictly-in-bounds warp mask (B, H, W)
    and the confidence P_R (B, H, W, 1) fp32."""
    flow, logvar = flow_and_logvar(net, images_trg, images_ref)
    cert = confidence_from_logvar(logvar, R=1.0)
    warped, mask = warp(logits_ref, flow, return_mask=True)
    return warped, mask, cert
