"""Segmentation losses (counterpart of ``refign_tpu/uda/losses.py``)."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["pixel_weighted_cross_entropy"]


def pixel_weighted_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                                 pixel_weight: Optional[torch.Tensor] = None,
                                 ignore_index: int = 255) -> torch.Tensor:
    """CE with ``ignore_index`` holes and optional per-pixel weights, in
    fp32: the per-pixel loss (0 where ignored) times the weight, summed
    over ALL pixels and divided by the full pixel count, ignored pixels
    included (the reference's mean over the whole map).

    logits (B, H, W, C); target (B, H, W) integer labels; pixel_weight
    (B, H, W) or None.
    """
    valid = target != ignore_index
    t = torch.where(valid, target, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, t[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    if pixel_weight is not None:
        nll = nll * pixel_weight.float()
    return nll.mean()
