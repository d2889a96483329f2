"""Refign's adaptive pseudo-label refinement and the ImageNet feature
distance (counterpart of ``refign_tpu/uda/refine.py``).  Pure tensor
functions, computed in fp32, on NHWC tensors."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..parallel import mesh

# the large static Cityscapes classes kept in M; the other channels are
# zeroed
STATIC_LARGE_CLASSES = (0, 1, 2, 3, 4, 8, 9, 10)


def _class_mask(classes: Sequence[int], n: int,
                device: torch.device) -> torch.Tensor:
    m = torch.zeros(n, dtype=torch.bool, device=device)
    m[list(classes)] = True
    return m


def eta(logits: torch.Tensor) -> torch.Tensor:
    """Normalised entropy of softmax(logits) over the last axis."""
    C = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(logp.exp() * logp).sum(-1) / math.log(C)


def refine(logits_trg: torch.Tensor, logits_ref: torch.Tensor,
           warp_mask: Optional[torch.Tensor], certs: Optional[torch.Tensor],
           gamma: float = 0.25, disable_M: bool = False,
           disable_P: bool = False) -> torch.Tensor:
    """Adaptive label correction: (B,H,W,19) target and (warped) reference
    logits, the (B,H,W) warp mask and the (B,H,W,1) confidence (either may
    be None) -> refined (B,H,W,19) probabilities."""
    C = logits_trg.shape[-1]
    if C != 19:
        raise ValueError(f"refine assumes the 19 Cityscapes classes, got {C}")
    probs_trg = torch.softmax(logits_trg.float(), dim=-1)
    probs_ref = torch.softmax(logits_ref.float(), dim=-1)
    # trust score: mean normalised entropy ** gamma, per image
    s = eta(logits_trg).mean(dim=(1, 2)) ** gamma
    static = _class_mask(STATIC_LARGE_CLASSES, C, probs_trg.device)
    m2d = static[probs_trg.argmax(-1)] & static[probs_ref.argmax(-1)]
    M = m2d[..., None] & static
    if disable_M:
        M = torch.zeros_like(M)
    if disable_P or certs is None:
        P = torch.full_like(probs_trg, 0.5)
    else:
        P = certs.float().expand_as(probs_trg)
    epsilon = s[:, None, None, None] * torch.maximum(P, M.float())
    if warp_mask is not None:
        epsilon = epsilon * warp_mask[..., None].float()
    return (1.0 - epsilon) * probs_trg + epsilon * probs_ref


def downscale_label_ratio(gt: torch.Tensor, scale_factor: int,
                          min_ratio: float, n_classes: int,
                          ignore_index: int = 255) -> torch.Tensor:
    """Majority-vote label downscale with a purity threshold: (B,H,W) ->
    (B,H/s,W/s)."""
    if scale_factor <= 1:
        raise ValueError(f"scale_factor must be > 1, got {scale_factor}")
    sub = torch.where(gt == ignore_index, n_classes, gt).long()
    onehot = F.one_hot(sub, n_classes + 1).float().permute(0, 3, 1, 2)
    pooled = F.avg_pool2d(onehot, scale_factor, scale_factor)
    ratio = pooled.amax(dim=1)
    out = pooled.argmax(dim=1)
    out = torch.where(out == n_classes, ignore_index, out)
    return torch.where(ratio < min_ratio, ignore_index, out)


def masked_feat_dist(f1: torch.Tensor, f2: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean L2 norm of the feature difference over masked positions;
    f1, f2 (B,h,w,C), mask (B,h,w) bool.  Under a process group the mask
    count is the global one and the result this rank's share of the
    global mean (``parallel/mesh.py:masked_mean``)."""
    ss = (f1 - f2).float().square().sum(-1)
    d = ss.clamp_min(1e-24).sqrt()
    if mask is None:
        return d.mean()
    m = mask.float()
    return mesh.masked_mean((d * m).sum(), m.sum())


def fdist_loss(feat: torch.Tensor, feat_imnet: torch.Tensor,
               gt: torch.Tensor, fdist_classes: Sequence[int],
               scale_min_ratio: float = 0.75, num_classes: int = 19,
               fdist_lambda: float = 0.005) -> torch.Tensor:
    """Thing-class ImageNet feature distance: feat, feat_imnet the last
    backbone stage (B,h,w,C); gt (B,H,W)."""
    scale = gt.shape[-1] // feat.shape[-2]
    gt_small = downscale_label_ratio(gt, scale, scale_min_ratio, num_classes)
    fdc = _class_mask(fdist_classes, num_classes + 256, gt.device)
    mask = fdc[gt_small.clamp(0, num_classes + 255)]
    return fdist_lambda * masked_feat_dist(feat, feat_imnet.detach(), mask)
