"""Flow-based warping and flow/mapping conversions on NHWC tensors
(counterpart of ``refign_tpu/ops/warp.py``).

Flows and mappings are channel-last ``(..., H, W, 2)`` in ``(x, y)`` order.
``grid_sample`` is ``F.grid_sample`` on the NCHW view of the input, computed
in fp32 and cast back to the input dtype, as the JAX package computes its
own gather formulation.  The JAX ``REFIGN_TPU_WARP_PACK`` switch is a TPU
A/B knob and has no counterpart here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "grid_sample", "warp", "warp_window", "flow_to_mapping",
    "mapping_to_flow", "unnormalize_mapping_to_flow", "gt_correspondence_mask",
    "confidence_from_logvar",
]


def grid_sample(x: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = True,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear grid sample with torch semantics: x (B,H,W,C), grid
    (B,Ho,Wo,2) in [-1, 1], (x, y) order -> (B,Ho,Wo,C) in x's dtype."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode must be 'zeros' or 'border', got "
                         f"{padding_mode!r}")
    y = F.grid_sample(x.float().permute(0, 3, 1, 2), grid.float(),
                      mode="bilinear", padding_mode=padding_mode,
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _base_grid(H: int, W: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """(H, W, 2) pixel-coordinate grid, channel order (x, y)."""
    yy, xx = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                            torch.arange(W, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def _sample(x: torch.Tensor, vgrid: torch.Tensor, H: int, W: int,
            padding_mode: str):
    """Bilinear samples of x at the pixel coordinates vgrid (B,h,w,2) of
    an H x W image (align_corners=True), and the strictly-in-bounds mask
    of those coordinates."""
    gx = 2.0 * vgrid[..., 0] / max(W - 1, 1) - 1.0
    gy = 2.0 * vgrid[..., 1] / max(H - 1, 1) - 1.0
    out = grid_sample(x, torch.stack([gx, gy], dim=-1), align_corners=True,
                      padding_mode=padding_mode)
    return out, (gx > -1) & (gx < 1) & (gy > -1) & (gy < 1)


def warp(x: torch.Tensor, flow: torch.Tensor, padding_mode: str = "zeros",
         return_mask: bool = False):
    """Backward-warp x (B,H,W,C) by the pixel flow (B,H,W,2).

    Like the JAX version it does not short-circuit on an all-zero flow; the
    mask (B,H,W) is the strictly-in-bounds test of the sample grid."""
    H, W = flow.shape[1:3]
    vgrid = _base_grid(H, W, torch.float32, flow.device) + flow.float()
    out, mask = _sample(x, vgrid, H, W, padding_mode)
    return (out, mask) if return_mask else out


def warp_window(x: torch.Tensor, flow: torch.Tensor, top: int, left: int,
                padding_mode: str = "zeros"):
    """``warp(x, full_flow, return_mask=True)`` cut to the window of
    ``flow`` (B,h,w,2), the full flow's values at rows top .. top+h-1 and
    columns left .. left+w-1, computed from that window alone: output
    pixel (top+i, left+j) samples the whole image x (B,H,W,C) at its own
    grid point plus its flow.  Returns (samples (B,h,w,C), mask (B,h,w))."""
    H, W = x.shape[1:3]
    h, w = flow.shape[1:3]
    offset = torch.tensor([left, top], dtype=torch.float32,
                          device=flow.device)
    vgrid = _base_grid(h, w, torch.float32, flow.device) + offset \
        + flow.float()
    return _sample(x, vgrid, H, W, padding_mode)


def flow_to_mapping(flow: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 2) flow -> absolute pixel mapping."""
    H, W = flow.shape[-3], flow.shape[-2]
    return flow + _base_grid(H, W, flow.dtype, flow.device)


def mapping_to_flow(mapping: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 2) absolute pixel mapping -> flow."""
    H, W = mapping.shape[-3], mapping.shape[-2]
    return mapping - _base_grid(H, W, mapping.dtype, mapping.device)


def unnormalize_mapping_to_flow(nmap: torch.Tensor) -> torch.Tensor:
    """[-1, 1]-normalised mapping (..., H, W, 2) -> pixel flow."""
    H, W = nmap.shape[-3], nmap.shape[-2]
    mx = (nmap[..., 0] + 1.0) * (W - 1) / 2.0
    my = (nmap[..., 1] + 1.0) * (H - 1) / 2.0
    return mapping_to_flow(torch.stack([mx, my], dim=-1))


def gt_correspondence_mask(flow: torch.Tensor) -> torch.Tensor:
    """Flows whose target lands inside the image (inclusive bounds)."""
    m = flow_to_mapping(flow)
    H, W = flow.shape[-3], flow.shape[-2]
    return ((m[..., 0] >= 0) & (m[..., 0] <= W - 1)
            & (m[..., 1] >= 0) & (m[..., 1] <= H - 1))


def confidence_from_logvar(logvar: torch.Tensor,
                           R: float = 1.0) -> torch.Tensor:
    """P_R = 1 - exp(-R^2 / (2 sigma^2)) for a single-Gaussian
    log-variance."""
    return 1.0 - torch.exp(-(R ** 2) / (2.0 * torch.exp(logvar)))
