"""Synthetic flows for UAWarpC's warp supervision, on the device
(counterpart of ``refign_tpu/alignment/synthetic_flows.py``).

Each mapping takes its parameters as arguments and computes in fp32:

* affine: A = R_alpha R_sh^T D R_sh and a translation, on the
  align_corners=False pixel-centre grid;
* homography: the 4-point DLT (an 8x8 solve in fp32) on the inclusive
  [-1, 1] grid;
* TPS: a 3x3 control grid, the precomputed L^-1 and the kernel r^2 log r^2;
* afftps: the affine mapping, with strictly-out-of-bounds values set to
  -1e10, sampled at the TPS coordinates with grid_sample's corner algebra
  (the affine field is linear in the pixel grid, so each corner is computed
  in place of a gather);
* elastic: Gaussian-blurred uniform noise (an exact FFT Gaussian,
  ``torch.fft.rfft2``/``irfft2``, circular boundary) modulated by random
  Gaussian blobs, composed with the flow through a warp.

:func:`draw_flow` makes one image's parameters from a host
``torch.Generator`` (the transform, its scalars, the blobs); the two
(H, W) uniform noise fields of the elastic part are drawn on the device
(:func:`draw_elastic_noise`), since copying them from the host each step
would cost more than drawing them.  Mappings are [-1, 1]-normalised and
channel-last (x, y); flows are pixel displacements.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.warp import (flow_to_mapping, gt_correspondence_mask,
                        mapping_to_flow, unnormalize_mapping_to_flow, warp,
                        warp_window)

__all__ = ["ElasticDraws", "FlowDraws", "draw_flow", "draw_elastic_noise",
           "affine_matrix", "affine_mapping", "homography_mapping",
           "tps_mapping", "afftps_mapping", "elastic_flow_field",
           "elastic_blob_mask", "apply_elastic", "composite_flow",
           "apply_synthetic_flow", "batched_composite_flow", "tps_control"]

F32 = torch.float32
BLOBS = 13   # the most elastic blobs an image gets (5 .. 13)


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ElasticDraws:
    """One image's elastic perturbation, less its two noise fields: the
    blur sigma and amplitude in pixels, the blob count and, for each of the
    BLOBS blobs, its integer sigma and the two uniforms that place it."""
    sigma: float
    alpha: float
    n_blobs: int
    blob_sigma: Tuple[int, ...]
    blob_ux: Tuple[float, ...]
    blob_uy: Tuple[float, ...]


@dataclasses.dataclass
class FlowDraws:
    """One image's synthetic flow: the transform ("hom", "tps", "affine" or
    "afftps"), its parameters and the elastic part or None.  ``theta`` is
    the homography's 8 or the TPS's 18 control values (afftps: its TPS);
    ``affine`` is (rotation, shear angle, l1, l2, tx, ty)."""
    kind: str
    theta: Optional[Tuple[float, ...]] = None
    affine: Optional[Tuple[float, ...]] = None
    elastic: Optional[ElasticDraws] = None


def _u(generator: torch.Generator, n: int = 0):
    """U(0, 1) in fp32 from a host generator: a float, or a tensor of n."""
    x = torch.rand((n,) if n else (), generator=generator, dtype=F32)
    return x if n else float(x)


def _draw_affine(generator, random_alpha, random_s, random_tx, random_ty):
    f = np.float32
    rot = (f(_u(generator)) - f(0.5)) * f(2) * f(random_alpha)
    sh = (f(_u(generator)) - f(0.5)) * f(2) * f(random_alpha)
    l1 = f(1) + (f(2) * f(_u(generator)) - f(1)) * f(random_s)
    tx = (f(2) * f(_u(generator)) - f(1)) * f(random_tx)
    ty = (f(2) * f(_u(generator)) - f(1)) * f(random_ty)
    # preserve_aspect_ratio, the only setting any config uses: l2 = l1
    return tuple(float(v) for v in (rot, sh, l1, l1, tx, ty))


def _draw_theta(generator, base: torch.Tensor, t: float):
    return tuple((base + (_u(generator, base.numel()) - 0.5) * 2 * t)
                 .tolist())


def draw_flow(generator: torch.Generator, H: int, W: int,
              include_transforms: Sequence[str] = ("hom", "tps", "afftps"),
              random_alpha=0.065, random_s=0.6, random_tx=0.3,
              random_ty=0.1, random_t_tps=0.0, random_t_hom=0.3,
              random_t_tps_for_afftps=0.0, add_elastic: bool = False
              ) -> FlowDraws:
    """One image's draws (``composite_flow``'s distribution): a uniform
    choice of transform, then its parameters, then the elastic part."""
    kind = include_transforms[int(torch.randint(
        0, len(include_transforms), (), generator=generator))]
    if kind == "hom":
        draw = FlowDraws(kind, theta=_draw_theta(
            generator, torch.tensor(_HOM_BASE), random_t_hom))
    elif kind == "tps":
        draw = FlowDraws(kind, theta=_draw_theta(
            generator, _tps_base(), random_t_tps))
    elif kind == "affine":
        draw = FlowDraws(kind, affine=_draw_affine(
            generator, random_alpha, random_s, random_tx, random_ty))
    elif kind == "afftps":
        draw = FlowDraws(
            kind, affine=_draw_affine(generator, random_alpha, random_s,
                                      random_tx, random_ty),
            theta=_draw_theta(generator, _tps_base(),
                              random_t_tps_for_afftps))
    else:
        raise ValueError(f"unknown transform {kind!r}")
    if add_elastic:
        draw.elastic = _draw_elastic(generator, H, W)
    return draw


def _draw_elastic(generator, H: int, W: int, min_sigma=0.1, max_sigma=0.08,
                  min_alpha=1.0, max_alpha=1.0, min_nbr=5, max_nbr=BLOBS,
                  min_sigma_mask=10, max_sigma_mask=40) -> ElasticDraws:
    f = np.float32
    m = f(max(H, W))
    sigma = m * (f(min_sigma) + f(max_sigma) * f(_u(generator)))
    alpha = m * (f(min_alpha) + f(max_alpha) * f(_u(generator)))
    n = int(torch.randint(min_nbr, max_nbr + 1, (), generator=generator))
    sig = torch.randint(min_sigma_mask, max_sigma_mask + 1, (max_nbr,),
                        generator=generator)
    return ElasticDraws(float(sigma), float(alpha), n,
                        tuple(int(v) for v in sig),
                        tuple(_u(generator, max_nbr).tolist()),
                        tuple(_u(generator, max_nbr).tolist()))


def draw_elastic_noise(generator: torch.Generator, B: int, H: int, W: int
                       ) -> torch.Tensor:
    """(B, 2, H, W) U(0, 1) noise fields of the elastic perturbations,
    drawn on the generator's device."""
    return torch.rand((B, 2, H, W), generator=generator, dtype=F32,
                      device=generator.device)


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------

def _grid_ac_false(H: int, W: int, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """torch affine_grid align_corners=False pixel-centre grid."""
    xs = (2.0 * torch.arange(W, dtype=F32, device=device) + 1.0) / W - 1.0
    ys = (2.0 * torch.arange(H, dtype=F32, device=device) + 1.0) / H - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx, gy


def _grid_ac_true(H: int, W: int, device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The inclusive grid of torch.linspace(-1, 1, n)."""
    xs = torch.linspace(-1.0, 1.0, W, dtype=F32, device=device)
    ys = torch.linspace(-1.0, 1.0, H, dtype=F32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx, gy


# ---------------------------------------------------------------------------
# affine
# ---------------------------------------------------------------------------

def affine_matrix(params: Sequence[float]) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(A (2, 2), t (2,)) in fp32 from (rotation, shear angle, l1, l2, tx,
    ty): A = R_rot R_sh^T diag(l1, l2) R_sh."""
    rot, sh, l1, l2, tx, ty = (torch.tensor(v, dtype=F32) for v in params)
    c, s = torch.cos(sh), torch.sin(sh)
    R_sh = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    ca, sa = torch.cos(rot), torch.sin(rot)
    R_a = torch.stack([torch.stack([ca, -sa]), torch.stack([sa, ca])])
    D = torch.diag(torch.stack([l1, l2]))
    return R_a @ R_sh.T @ D @ R_sh, torch.stack([tx, ty])


def affine_mapping(H: int, W: int, params: Sequence[float],
                   device="cpu") -> torch.Tensor:
    A, t = (v.tolist() for v in affine_matrix(params))
    gx, gy = _grid_ac_false(H, W, device)
    mx = A[0][0] * gx + A[0][1] * gy + t[0]
    my = A[1][0] * gx + A[1][1] * gy + t[1]
    return torch.stack([mx, my], dim=-1)


# ---------------------------------------------------------------------------
# homography (4-point DLT)
# ---------------------------------------------------------------------------

_HOM_BASE = (-1., -1., 1., 1., -1., 1., -1., 1.)


def _homography_matrix(theta: Sequence[float]) -> List[float]:
    """The 9 homography entries (the last 1) for the corners moved to
    theta = (x'0..3, y'0..3), from an fp32 8x8 solve."""
    th = torch.tensor(theta, dtype=F32)
    xp, yp = th[:4], th[4:]
    x = torch.tensor([-1., -1., 1., 1.])
    y = torch.tensor([-1., 1., -1., 1.])
    o, z = torch.ones(4), torch.zeros(4)
    rows_x = torch.stack([-x, -y, -o, z, z, z, x * xp, y * xp, xp], dim=1)
    rows_y = torch.stack([z, z, z, -x, -y, -o, x * yp, y * yp, yp], dim=1)
    A = torch.cat([rows_x, rows_y])
    h8 = torch.linalg.solve(A[:, :8], -A[:, 8])
    return h8.tolist() + [1.0]


def homography_mapping(H: int, W: int, theta: Sequence[float],
                       device="cpu") -> torch.Tensor:
    Hm = _homography_matrix(theta)
    gx, gy = _grid_ac_true(H, W, device)
    X = gx * Hm[0] + gy * Hm[1] + Hm[2]
    Y = gx * Hm[3] + gy * Hm[4] + Hm[5]
    K = gx * Hm[6] + gy * Hm[7] + Hm[8]
    return torch.stack([X / K, Y / K], dim=-1)


# ---------------------------------------------------------------------------
# TPS
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def tps_control(grid_size: int = 3):
    """Control points P_X, P_Y (fp32) and L^-1 (fp64 inverse, fp32)."""
    axis = np.linspace(-1, 1, grid_size)
    P_Y, P_X = np.meshgrid(axis, axis)
    P_X = P_X.reshape(-1)
    P_Y = P_Y.reshape(-1)
    N = grid_size * grid_size
    d2 = ((P_X[:, None] - P_X[None, :]) ** 2
          + (P_Y[:, None] - P_Y[None, :]) ** 2)
    d2[d2 == 0] = 1.0
    K = d2 * np.log(d2)
    P = np.stack([np.ones(N), P_X, P_Y], axis=1)
    L = np.block([[K, P], [P.T, np.zeros((3, 3))]])
    Li = np.linalg.inv(L).astype(np.float32)
    return P_X.astype(np.float32), P_Y.astype(np.float32), Li


def _tps_base() -> torch.Tensor:
    P_X, P_Y, _ = tps_control()
    return torch.from_numpy(np.concatenate([P_X, P_Y]))


def tps_mapping(H: int, W: int, theta: Sequence[float],
                device="cpu") -> torch.Tensor:
    P_X, P_Y, Li = (torch.from_numpy(a) for a in tps_control())
    N = P_X.numel()
    th = torch.tensor(theta, dtype=F32)
    Q_X, Q_Y = th[:N], th[N:]
    W_X = (Li[:N, :N] @ Q_X).to(device)
    W_Y = (Li[:N, :N] @ Q_Y).to(device)
    A_X = (Li[N:, :N] @ Q_X).tolist()
    A_Y = (Li[N:, :N] @ Q_Y).tolist()
    gx, gy = _grid_ac_true(H, W, device)
    dx = gx[..., None] - P_X.to(device)
    dy = gy[..., None] - P_Y.to(device)
    d2 = dx * dx + dy * dy
    d2 = torch.where(d2 == 0, 1.0, d2)
    U = d2 * torch.log(d2)
    mx = A_X[0] + A_X[1] * gx + A_X[2] * gy + (W_X * U).sum(-1)
    my = A_Y[0] + A_Y[1] * gx + A_Y[2] * gy + (W_Y * U).sum(-1)
    return torch.stack([mx, my], dim=-1)


# ---------------------------------------------------------------------------
# afftps
# ---------------------------------------------------------------------------

def _oob_sentinel_wrt(values: torch.Tensor, grid: torch.Tensor
                      ) -> torch.Tensor:
    """values where grid is strictly inside (-1, 1)^2, else -1e10."""
    inb = ((grid[..., 0] > -1) & (grid[..., 0] < 1)
           & (grid[..., 1] > -1) & (grid[..., 1] < 1))[..., None]
    f = inb.to(values.dtype)
    return f * values + (f - 1.0) * 1e10


def _affine_value(A, t, ix, iy, H: int, W: int):
    """The sentineled affine mapping at integer pixel coordinates."""
    gx = (2.0 * ix + 1.0) / W - 1.0
    gy = (2.0 * iy + 1.0) / H - 1.0
    mx = A[0][0] * gx + A[0][1] * gy + t[0]
    my = A[1][0] * gx + A[1][1] * gy + t[1]
    f = ((mx > -1) & (mx < 1) & (my > -1) & (my < 1)).to(mx.dtype)
    return f * mx + (f - 1.0) * 1e10, f * my + (f - 1.0) * 1e10


def _compose_affine_at(A, t, grid: torch.Tensor, H: int, W: int
                       ) -> torch.Tensor:
    """grid_sample(sentineled affine mapping, grid, align_corners=True,
    zero padding) with grid_sample's corners, weights, clipping and zero
    padding, each corner computed from the affine map."""
    g = grid.float()
    gx = (g[..., 0] + 1.0) * 0.5 * (W - 1)
    gy = (g[..., 1] + 1.0) * 0.5 * (H - 1)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0, gy - y0

    def corner(ix, iy):
        valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        ixc = ix.clamp(0, W - 1).to(torch.int32).to(F32)
        iyc = iy.clamp(0, H - 1).to(torch.int32).to(F32)
        vx, vy = _affine_value(A, t, ixc, iyc, H, W)
        f = valid.to(vx.dtype)
        return vx * f, vy * f

    v00x, v00y = corner(x0, y0)
    v01x, v01y = corner(x0 + 1, y0)
    v10x, v10y = corner(x0, y0 + 1)
    v11x, v11y = corner(x0 + 1, y0 + 1)
    mx = (v00x * (1 - wx) * (1 - wy) + v01x * wx * (1 - wy)
          + v10x * (1 - wx) * wy + v11x * wx * wy)
    my = (v00y * (1 - wx) * (1 - wy) + v01y * wx * (1 - wy)
          + v10y * (1 - wx) * wy + v11y * wx * wy)
    return torch.stack([mx, my], dim=-1)


def afftps_mapping(H: int, W: int, affine: Sequence[float],
                   theta: Sequence[float], device="cpu") -> torch.Tensor:
    """The affine mapping sampled at the TPS coordinates, -1e10 where
    either leaves (-1, 1)."""
    A, t = (v.tolist() for v in affine_matrix(affine))
    tps = tps_mapping(H, W, theta, device)
    return _oob_sentinel_wrt(_compose_affine_at(A, t, tps, H, W), tps)


# ---------------------------------------------------------------------------
# elastic
# ---------------------------------------------------------------------------

def _fft_gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Exact Gaussian low-pass of an (H, W) field via the FFT (circular
    boundary); the transfer function of a Gaussian of std sigma pixels is
    exp(-2 pi^2 sigma^2 f^2)."""
    H, W = x.shape
    fy = torch.fft.fftfreq(H, dtype=F32, device=x.device)
    fx = torch.fft.rfftfreq(W, dtype=F32, device=x.device)
    c = np.float32(-2.0 * math.pi ** 2) * np.float32(sigma) ** 2
    gy = torch.exp(float(c) * fy ** 2)
    gx = torch.exp(float(c) * fx ** 2)
    return torch.fft.irfft2(torch.fft.rfft2(x) * gy[:, None] * gx[None, :],
                            s=(H, W))


def elastic_flow_field(noise: torch.Tensor, sigma: float, alpha: float
                       ) -> torch.Tensor:
    """(H, W, 2) displacement from the (2, H, W) U(0, 1) noise fields."""
    dx = _fft_gaussian_blur(noise[0] * 2.0 - 1.0, sigma) * alpha
    dy = _fft_gaussian_blur(noise[1] * 2.0 - 1.0, sigma) * alpha
    return torch.stack([dx, dy], dim=-1)


def elastic_blob_mask(H: int, W: int, draws: ElasticDraws,
                      device="cpu") -> torch.Tensor:
    """Sum of the first ``n_blobs`` random Gaussian blobs, each scaled to
    a peak of 2 and clamped to [0, 1], then clamped to [0, 1].  As in the
    reference, the first-axis centre is drawn from the W range and the
    second from the H range, and a blob is divided by sigma * 2 pi before
    its < 1e-6 peak is dropped."""
    rows = torch.arange(H, dtype=F32, device=device)
    cols = torch.arange(W, dtype=F32, device=device)
    acc = torch.zeros((H, W), dtype=F32, device=device)
    f = np.float32
    for i in range(draws.n_blobs):
        sigma = f(draws.blob_sigma[i])
        x = float(np.floor(f(3) * sigma + f(draws.blob_ux[i])
                           * (f(W) - f(6) * sigma + f(1))))
        y = float(np.floor(f(3) * sigma + f(draws.blob_uy[i])
                           * (f(H) - f(6) * sigma + f(1))))
        two_var = float(f(2) * sigma * sigma)
        g1 = torch.exp(-torch.square(rows - x) / two_var)
        g2 = torch.exp(-torch.square(cols - y) / two_var)
        blob = torch.outer(g1, g2) / float(sigma * f(2.0 * math.pi))
        mx = blob.max()
        blob = torch.where(mx < 1e-6, 0.0,
                           (2.0 / mx.clamp_min(1e-12) * blob).clamp(0.0, 1.0))
        acc = acc + blob
    return acc.clamp(0.0, 1.0)


def apply_elastic(flow: torch.Tensor, draws: ElasticDraws,
                  noise: torch.Tensor) -> torch.Tensor:
    """Compose an (H, W, 2) pixel flow with the elastic perturbation of
    ``draws`` and the (2, H, W) noise fields."""
    H, W = flow.shape[:2]
    pert = elastic_flow_field(noise, draws.sigma, draws.alpha)
    pert = pert * elastic_blob_mask(H, W, draws, flow.device)[..., None]
    mapping = flow_to_mapping(flow)
    return mapping_to_flow(warp(mapping[None], pert[None])[0])


# ---------------------------------------------------------------------------
# composite + application
# ---------------------------------------------------------------------------

def composite_flow(draws: FlowDraws, H: int, W: int, device="cpu",
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (H, W, 2) pixel flow of one image's draws; ``noise`` (2, H, W)
    is needed where they have an elastic part."""
    if draws.kind == "hom":
        mapping = homography_mapping(H, W, draws.theta, device)
    elif draws.kind == "tps":
        mapping = tps_mapping(H, W, draws.theta, device)
    elif draws.kind == "affine":
        mapping = affine_mapping(H, W, draws.affine, device)
    elif draws.kind == "afftps":
        mapping = afftps_mapping(H, W, draws.affine, draws.theta, device)
    else:
        raise ValueError(f"unknown transform {draws.kind!r}")
    flow = unnormalize_mapping_to_flow(mapping)
    if draws.elastic is not None:
        if noise is None:
            raise ValueError("an elastic flow needs its noise fields")
        flow = apply_elastic(flow, draws.elastic, noise)
    return flow


def apply_synthetic_flow(image: torch.Tensor, flow: torch.Tensor,
                         min_fraction_valid_corr: float = 0.1,
                         out_slice=None):
    """Warp an (H, W, C) image by the (H, W, 2) synthetic flow and build
    the supervision mask: the strict in-bounds mask of the warp, or, where
    under ``min_fraction_valid_corr`` of the FULL grid's flow lands inside
    the image, that inclusive border mask.  ``out_slice`` (top, left, th,
    tw) computes the warp on that window only, which equals warping at full
    size and then slicing.  Returns (image', flow, mask), sliced where
    asked."""
    H, W = flow.shape[:2]
    border_mask = gt_correspondence_mask(flow[None])[0]
    too_small = border_mask.sum() < H * W * min_fraction_valid_corr
    if out_slice is None:
        warped, warp_mask = warp(image[None], flow[None], return_mask=True)
        return (warped[0], flow,
                torch.where(too_small, border_mask, warp_mask[0]))
    top, left, th, tw = out_slice
    fc = flow[top:top + th, left:left + tw]
    warped, warp_mask = warp_window(image[None], fc[None], top, left)
    bm = border_mask[top:top + th, left:left + tw]
    return warped[0], fc, torch.where(too_small, bm, warp_mask[0])


def batched_composite_flow(draws: Sequence[FlowDraws], images: torch.Tensor,
                           out_slice=None,
                           noise: Optional[torch.Tensor] = None):
    """Per image: its flow, the warped image and the mask, stacked.
    images (B, H, W, C); noise (B, 2, H, W) where the draws are elastic.
    Returns (image', flow, mask), each sliced to ``out_slice`` if given."""
    B, H, W, _ = images.shape
    outs = [apply_synthetic_flow(
        images[b], composite_flow(draws[b], H, W, images.device,
                                  None if noise is None else noise[b]),
        out_slice=out_slice) for b in range(B)]
    return tuple(torch.stack(parts) for parts in zip(*outs))
