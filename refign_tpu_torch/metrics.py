"""Evaluation metrics (counterpart of ``refign_tpu/metrics.py``): IoU over
a confusion matrix, accumulated on the device.

The JAX package keeps the state a pytree that ``jax.lax.psum`` reduces
across devices; here the state is a plain int64 tensor.  Under a process
group every rank holds the whole prediction (the evaluation row spread
reassembles it, ``parallel/mesh.py``), so every rank's matrix is already
the global one.  SparseEPE lives in ``utils/sparse_epe.py``.
"""
from __future__ import annotations

import torch

__all__ = ["iou_init", "iou_update", "iou_compute"]


def iou_init(num_classes: int) -> torch.Tensor:
    """(C, C) int64 confusion matrix [target, pred], zeros (move it to the
    predictions' device to accumulate there)."""
    return torch.zeros((num_classes, num_classes), dtype=torch.int64)


def iou_update(confmat: torch.Tensor, preds: torch.Tensor,
               target: torch.Tensor, ignore_index: int = 255
               ) -> torch.Tensor:
    """The confusion matrix with one batch added.

    Args:
      confmat: (C, C) running confusion matrix [target, pred].
      preds: (B, H, W, C) logits or (B, H, W) class indices.
      target: (B, H, W) int labels with ``ignore_index`` holes.
    """
    C = confmat.shape[0]
    if preds.dim() == target.dim() + 1:
        preds = preds.argmax(-1)
    preds = preds.reshape(-1).long()
    target = target.reshape(-1).long().to(preds.device)
    valid = target != ignore_index
    idx = target[valid] * C + preds[valid]
    counts = torch.bincount(idx, minlength=C * C)
    return confmat + counts.reshape(C, C).to(confmat.device, confmat.dtype)


def iou_compute(confmat: torch.Tensor, average: str = "macro",
                absent_score: float = 0.0,
                over_present_classes: bool = False) -> torch.Tensor:
    """Jaccard index from the confusion matrix, in fp32 (the JAX package's
    default precision): per class (``average`` 'none' or None; absent
    classes NaN with ``over_present_classes``) or their mean ('macro'; over
    the classes present in the targets with ``over_present_classes``)."""
    confmat = confmat.float()
    inter = confmat.diagonal()
    union = confmat.sum(0) + confmat.sum(1) - inter
    scores = torch.where(union == 0, torch.full_like(union, absent_score),
                         inter / union.clamp_min(1))
    present = confmat.sum(1) != 0
    if average in ("none", None):
        if over_present_classes:
            return torch.where(present, scores,
                               torch.full_like(scores, float("nan")))
        return scores
    if average == "macro":
        if over_present_classes:
            n = present.sum().clamp_min(1)
            return torch.where(present, scores, 0.0).sum() / n
        return scores.mean()
    raise ValueError(f"unsupported average: {average}")
