"""UAWarpC matching losses on NHWC tensors (counterpart of
``refign_tpu/alignment/losses.py``).

``multi_scale_flow_loss``: per pyramid level, the Huber (or L1, L2) flow
error summed over the two flow channels, turned into a Gaussian negative
log-likelihood by a 1- or 2-component log-variance (log-sum-exp mixture),
reduced by a masked mean (0 on an empty mask) and summed over the levels
with weights.  ``wbipath_loss``: the warp-bipath composition of the flows
target' -> source and source -> target (the latter warped by the former,
whose warp flow is detached) supervised by the known synthetic flow, with
the optional cyclic-consistency visibility mask.
``adaptive_loss_weights``: the reference's adaptive ss/us weighting.

Flows are channel-last (..., 2), log-variances (..., 1 or 2); the losses
are fp32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..ops.resize import interpolate
from ..ops.warp import gt_correspondence_mask, warp
from ..parallel import mesh

__all__ = ["huber", "multi_scale_flow_loss", "wbipath_loss",
           "adaptive_loss_weights"]


def huber(d: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """2 * smooth_l1(beta=delta) * delta."""
    ad = d.abs()
    sl1 = torch.where(ad < delta, 0.5 * d * d / delta, ad - 0.5 * delta)
    return 2.0 * sl1 * delta


_LOSS_FNS = {
    "L1Loss": torch.abs,
    "L2Loss": lambda d: d * d,
    "HuberLoss": huber,
}


def _bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    return interpolate(x, hw, mode="bilinear", align_corners=False)


def _downsample_mask(mask: torch.Tensor, hw: Tuple[int, int]
                     ) -> torch.Tensor:
    """Bilinear resize of the 0/1 mask, then floor, as bool."""
    if tuple(mask.shape[1:3]) == tuple(hw):
        return mask.bool()
    m = _bilinear(mask.float()[..., None], hw)[..., 0]
    return torch.floor(m).bool()


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The masked mean of x, 0 on an empty mask; under a process group
    over every rank's mask (this rank's share of the global mean,
    ``parallel/mesh.py:masked_mean``)."""
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    total = mesh.all_reduce_sum(m.sum())
    share = (x * m).sum() * mesh.world_size() / total.clamp_min(1.0)
    return torch.where(total > 0, share,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _one_scale(est_flow: torch.Tensor, gt_flow: torch.Tensor,
               est_uncert: Optional[torch.Tensor],
               mask: Optional[torch.Tensor], loss_type: str) -> torch.Tensor:
    h, w = est_flow.shape[1:3]
    gt = _bilinear(gt_flow, (h, w))
    if mask is not None:
        mask = _downsample_mask(mask, (h, w))
    loss = _LOSS_FNS[loss_type]((est_flow - gt).float()).sum(-1)
    if est_uncert is not None:
        if loss_type not in ("L2Loss", "HuberLoss"):
            raise ValueError(f"a probabilistic loss needs L2Loss or "
                             f"HuberLoss, got {loss_type}")
        if est_uncert.shape[-1] == 1:
            log_var = est_uncert[..., 0]
        elif est_uncert.shape[-1] == 2:
            log_var = torch.logsumexp(est_uncert, dim=-1)
        else:
            raise ValueError(f"log-variance of {est_uncert.shape[-1]} "
                             f"components")
        log_var = log_var.float()
        loss = (0.5 * torch.exp(-log_var) * loss + log_var
                + math.log(2 * math.pi))
    return _masked_mean(loss, mask)


def multi_scale_flow_loss(flow_output, gt_flow: torch.Tensor, mask=None,
                          loss_type: str = "HuberLoss",
                          level_weights: Optional[Sequence[float]] = None
                          ) -> torch.Tensor:
    """Sum over the levels of the (probabilistic) flow loss.

    flow_output: a list over levels of flows (B, h, w, 2) or of (flow,
    log-variance) pairs; gt_flow: (B, H, W, 2) at the image size; mask:
    (B, H, W), or one mask per level, or None."""
    if not isinstance(flow_output, (list, tuple)):
        flow_output = [flow_output]
    weights = (list(level_weights) if level_weights
               else [1.0] * len(flow_output))
    if len(weights) != len(flow_output):
        raise ValueError(f"{len(weights)} level weights for "
                         f"{len(flow_output)} levels")
    total = 0.0
    for i, (out, w_lvl) in enumerate(zip(flow_output, weights)):
        m = mask[i] if isinstance(mask, (list, tuple)) else mask
        flow, uncert = out if isinstance(out, tuple) else (out, None)
        total = total + w_lvl * _one_scale(flow, gt_flow, uncert, m,
                                           loss_type)
    return total


def _cyclic_consistency_mask(flow_a: torch.Tensor, warped_b: torch.Tensor,
                             gt_flow: torch.Tensor, alpha_1: float,
                             alpha_2: float) -> torch.Tensor:
    """Forward-backward visibility: a pixel is visible where
    |a + b_warped - gt|^2 <= alpha_1 * (|a|^2 + |b_warped|^2 + |gt|^2)
    + alpha_2, the synthetic flow resized to the level without rescaling
    its values."""
    h, w = flow_a.shape[1:3]
    gt = _bilinear(gt_flow, (h, w)).float()
    fa = flow_a.detach().float()
    wb = warped_b.detach().float()

    def length_sq(x):
        return (x * x).sum(-1)

    mag_sq = length_sq(fa) + length_sq(wb) + length_sq(gt)
    occluded = length_sq(fa + wb - gt) > alpha_1 * mag_sq + alpha_2
    return ~occluded


def wbipath_loss(flows_tp_to_s, flows_s_to_t, gt_flow: torch.Tensor,
                 mask_used: Optional[torch.Tensor],
                 loss_type: str = "HuberLoss",
                 level_weights: Optional[Sequence[float]] = None,
                 visibility_mask: bool = False, alpha_1: float = 0.03,
                 alpha_2: float = 0.5) -> torch.Tensor:
    """W-bipath composition loss.

    flows_tp_to_s, flows_s_to_t: per-level lists of flows (B, h, w, 2) or
    (flow, log-variance (B, h, w, 1)) pairs in pixels of the image;
    gt_flow: (B, H, W, 2) synthetic flow target' -> target; mask_used:
    (B, H, W) validity of the synthetic flow, or None."""
    H, W = gt_flow.shape[1:3]
    if not isinstance(flows_tp_to_s, (list, tuple)):
        flows_tp_to_s = [flows_tp_to_s]
    if not isinstance(flows_s_to_t, (list, tuple)):
        flows_s_to_t = [flows_s_to_t]
    composed, masks = [], []
    for a, b in zip(flows_tp_to_s, flows_s_to_t):
        probabilistic = isinstance(a, tuple)
        flow_a, unc_a = a if probabilistic else (a, None)
        flow_b, unc_b = b if probabilistic else (b, None)
        h, w = flow_a.shape[1:3]
        # the warp flow in level pixels, detached
        warp_flow = torch.stack([flow_a[..., 0] * (w / W),
                                 flow_a[..., 1] * (h / H)], dim=-1).detach()
        warped_b = warp(flow_b, warp_flow)
        comp = flow_a + warped_b
        if probabilistic:
            comp = (comp, torch.cat([unc_a, warp(unc_b, warp_flow)], dim=-1))
        composed.append(comp)
        m = gt_correspondence_mask(warp_flow)
        if mask_used is not None:
            m = m & _downsample_mask(mask_used, (h, w))
        if visibility_mask:
            m = m & _cyclic_consistency_mask(flow_a, warped_b, gt_flow,
                                             alpha_1, alpha_2)
        masks.append(m)
    return multi_scale_flow_loss(composed, gt_flow, mask=masks,
                                 loss_type=loss_type,
                                 level_weights=level_weights)


def adaptive_loss_weights(loss_ss: torch.Tensor, loss_un: torch.Tensor,
                          weight_ss: float = 1.0, weight_un: float = 1.0,
                          apply_constant: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The adaptive ss/us weights, detached (reference
    ``alignment_model.py:217-232``).  The step passes
    ``apply_constant_flow_weights`` in the ``weight_ss`` slot, as the
    reference does (``alignment_model.py:141-143``): with the default False
    the ratio is 0, which gives weights (0, 1) where loss_un > loss_ss and
    (1, 100) otherwise."""
    loss_ss, loss_un = loss_ss.detach().float(), loss_un.detach().float()
    if apply_constant:
        return (torch.full_like(loss_ss, weight_ss),
                torch.full_like(loss_un, weight_un))
    ratio = weight_ss / weight_un
    s_when_un_bigger = (loss_un / loss_ss.clamp_min(1e-8) * ratio
                        ).clamp(max=100.0)
    if ratio > 0:
        u_when_ss_bigger = (loss_ss / loss_un.clamp_min(1e-8)
                            / max(ratio, 1e-38)).clamp(max=100.0)
    else:
        u_when_ss_bigger = torch.full_like(loss_ss, 100.0)
    un_bigger = loss_un > loss_ss
    one = torch.ones_like(loss_ss)
    return (torch.where(un_bigger, s_when_un_bigger, one),
            torch.where(un_bigger, one, u_when_ss_bigger))
