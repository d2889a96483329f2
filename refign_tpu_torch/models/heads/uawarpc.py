"""UAWarpC coarse-to-fine, uncertainty-aware dense-matching head on NHWC
tensors (counterpart of ``refign_tpu/models/heads/uawarpc.py``).

  L4 (16x16):  global correlation (mutual matching) -> mapping decoder ->
               normalised map -> flow at 256 scale
  L3 (32x32):  warp source features by the upsampled flow -> local
               correlation (P = 9, kernel K3) -> residual flow decoder
               (+ adaptive-resolution refinement)
  L2 (1/8):    the same at the image scale
  L1 (1/4):    the same + upsampled 2-channel feature skip + finest
               refinement
  Per-level uncertainty modules chain a 1-channel log-variance.

In train mode the BatchNorm layers of every decoder, refinement and
uncertainty module normalise with the batch statistics and update their
running ones; ``remat_modules`` runs each of those modules under a
non-reentrant checkpoint (``nn.layers.remat_call``: recomputed in the
backward, its BN statistics updated once), the JAX head's
``remat_modules``; the iterative refinement is eval-only.

dtype boundaries as in the JAX head: correlations run in fp32 and are cast
to the compute dtype (that of the features; the local correlations are
written in it by the kernel); decoders run in the compute
dtype; the additive flow and log-variance chains stay fp32.  The eval-only
iterative refinement unrolls a number of extra levels fixed by
``out_size`` and reuses ``decoder2`` and the level-2 uncertainty module.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from ...nn.layers import conv2d, init_convs_torch_default_, remat_call
from ...ops.correlation import (global_correlation_relu_l2norm,
                                local_correlation_relu_l2norm)
from ...ops.resize import interpolate
from ...ops.warp import unnormalize_mapping_to_flow, warp
from ..matching_modules import (FEAT, OpticalFlowEstimator,
                                RefinementModule, UncertaintyModule)

PATCH = 9           # local search window (P x P)
GLOBAL_GRID = 16    # level-4 feature grid (16 x 16 at 256^2 input)


def _l2norm_channels(x: torch.Tensor) -> torch.Tensor:
    """F.normalize over channels in fp32, cast back to x's dtype."""
    x32 = x.float()
    ss = x32.square().sum(-1, keepdim=True)
    return (x32 / ss.clamp_min(1e-24).sqrt()).to(x.dtype)


def _scale_flow(flow: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    return torch.stack([flow[..., 0] * sx, flow[..., 1] * sy], dim=-1)


def _bilinear(x: torch.Tensor, size) -> torch.Tensor:
    return interpolate(x, size, mode="bilinear", align_corners=False)


class UAWarpCHead(nn.Module):
    """The head (the JAX head's options): ``batch_norm`` in every decoder,
    refinement and uncertainty module (else a bias on each conv), the
    refinement modules at the adaptive resolution (level 3) and at the
    finest level, each left out where its flag is False (with its
    parameters).  ``nn.layers.grouped_bn(head, G)`` normalises G row
    groups of the batch each on its own statistics in train mode (G head
    calls in one, the folded UAWarpC step's; JAX's ``bn_groups``)."""

    def __init__(self, in_index: Sequence[int] = (0, 1),
                 batch_norm: bool = True,
                 refinement_at_adaptive_res: bool = True,
                 refinement_at_finest_level: bool = True,
                 estimate_uncertainty: bool = True,
                 iterative_refinement: bool = False,
                 remat_modules: bool = False):
        super().__init__()
        self.in_index = list(in_index)
        self.remat_modules = remat_modules
        self.estimate_uncertainty = estimate_uncertainty
        self.iterative_refinement = iterative_refinement
        local_in = PATCH * PATCH + 2 + (1 if estimate_uncertainty else 0)
        norm = dict(batch_norm=batch_norm)
        self.decoder4 = OpticalFlowEstimator(GLOBAL_GRID ** 2, **norm)
        self.decoder3 = OpticalFlowEstimator(local_in, **norm)
        self.decoder2 = OpticalFlowEstimator(local_in, **norm)
        self.decoder1 = OpticalFlowEstimator(local_in + 2, **norm)
        self.refinement_module_adaptive = (
            RefinementModule(FEAT, **norm) if refinement_at_adaptive_res
            else None)
        self.refinement_module_finest = (
            RefinementModule(FEAT, **norm) if refinement_at_finest_level
            else None)
        self.reduce = conv2d(FEAT, 2, kernel_size=1)
        if estimate_uncertainty:
            self.estimate_uncertainty_components4 = UncertaintyModule(
                GLOBAL_GRID, **norm)
            for lvl in (3, 2, 1):
                setattr(self, f"estimate_uncertainty_components{lvl}",
                        UncertaintyModule(PATCH, feed_in_previous=True,
                                          **norm))

    def init_weights(self, generator: torch.Generator) -> None:
        """torch's conv default, BN ones/zeros (the JAX head's init)."""
        init_convs_torch_default_(self, generator)

    def _run(self, module: nn.Module, *args):
        """A decoder, refinement or uncertainty module, checkpointed where
        ``remat_modules`` and grad are on."""
        if self.remat_modules and torch.is_grad_enabled():
            return remat_call(module, *args)
        return module(*args)

    def forward(self, trg, src, trg_256, src_256, out_size: Tuple[int, int]):
        """Two-level pyramids of target and source at the image scale (1/4,
        1/8) and at 256x256 (32^2, 16^2), and the image size.  Returns four
        levels, coarse to fine, of (flow, logvar) when estimating
        uncertainty, else of flows; flows are (B, h, w, 2) fp32 in pixels of
        ``out_size``."""
        c11, c12 = [trg[i] for i in self.in_index]
        c13, c14 = [trg_256[i] for i in self.in_index]
        c21, c22 = [src[i] for i in self.in_index]
        c23, c24 = [src_256[i] for i in self.in_index]
        c11, c12, c13, c14, c21, c22, c23, c24 = map(
            _l2norm_channels, (c11, c12, c13, c14, c21, c22, c23, c24))

        h_256 = w_256 = 256.0
        h_orig, w_orig = float(out_size[0]), float(out_size[1])
        diag_ratio_log = 2 * math.log(
            math.sqrt(h_orig ** 2 + w_orig ** 2)
            / math.sqrt(h_256 ** 2 + w_256 ** 2))
        uncert = self.estimate_uncertainty
        cdt = c14.dtype
        if uncert:
            um4 = self.estimate_uncertainty_components4
            um3 = self.estimate_uncertainty_components3
            um2 = self.estimate_uncertainty_components2
            um1 = self.estimate_uncertainty_components1

        def decoder_input(corr, up_flow, up_u, *extra):
            parts = [corr, up_flow.to(cdt), *(e.to(cdt) for e in extra)]
            if uncert:
                parts.append(up_u.to(cdt))
            return torch.cat(parts, dim=-1)

        # ---- level 4: 16x16 global correlation -> mapping ----
        h4, w4 = c14.shape[1:3]
        if (h4, w4) != (GLOBAL_GRID, GLOBAL_GRID):
            raise ValueError(f"level-4 features must be 16x16, got {h4}x{w4}")
        corr4 = global_correlation_relu_l2norm(c24, c14).to(cdt)
        est_map4, x4 = self._run(self.decoder4, corr4)
        flow4_256 = unnormalize_mapping_to_flow(est_map4.float())
        flow4_256 = _scale_flow(flow4_256, w_256 / w4, h_256 / h4)
        if uncert:
            u4_256 = (self._run(um4, corr4, x4).float()
                      + 2 * math.log(w_256 / w4))

        # ---- level 3: 32x32 local correlation ----
        h3, w3 = c13.shape[1:3]
        if (h3, w3) != (32, 32):
            raise ValueError(f"level-3 features must be 32x32, got {h3}x{w3}")
        up_flow4 = _bilinear(flow4_256, (h3, w3))
        up_u4 = _bilinear(u4_256, (h3, w3)) if uncert else None
        warp3 = warp(c23, _scale_flow(up_flow4, w3 / w_256, h3 / h_256))
        corr3 = local_correlation_relu_l2norm(c13, warp3, PATCH,
                                              out_dtype=cdt)
        res_flow3, x3 = self._run(self.decoder3,
                                  decoder_input(corr3, up_flow4, up_u4))
        if self.refinement_module_adaptive is not None:
            res_flow3 = res_flow3 + self._run(
                self.refinement_module_adaptive, x3)
        flow3 = res_flow3.float() + up_flow4
        if uncert:
            u3 = self._run(um3, corr3, x3, up_u4.to(cdt),
                           up_flow4.to(cdt)).float()
        # level-3 flow (and uncertainty) to image-resolution units
        flow3 = _scale_flow(flow3, w_orig / w_256, h_orig / h_256)
        if uncert:
            u3 = u3 + diag_ratio_log

        # ---- eval-only iterative refinement (static unroll) ----
        if self.iterative_refinement and not self.training:
            R = max(h_orig, w_orig) / 8.0 / 32.0
            n_extra = max(0, int(round(math.log(R / 3.0) / math.log(2))))
            for n in range(n_extra):
                ratio = 1.0 / (8.0 * 2 ** (n_extra - n))
                size = (int(h_orig * ratio), int(w_orig * ratio))
                up_flow3 = _bilinear(flow3, size)
                up_u3 = _bilinear(u3, size) if uncert else None
                c23_bis = interpolate(c22, size, mode="area")
                c13_bis = interpolate(c12, size, mode="area")
                warp3b = warp(c23_bis, up_flow3 * ratio)
                corr3b = local_correlation_relu_l2norm(
                    c13_bis, warp3b, PATCH, out_dtype=c13_bis.dtype)
                res_flow3, x3 = self.decoder2(
                    decoder_input(corr3b, up_flow3, up_u3))
                flow3 = res_flow3.float() + up_flow3
                if uncert:
                    u3 = um2(corr3b, x3, up_u3.to(cdt),
                             up_flow3.to(cdt)).float()

        # ---- level 2: 1/8 of the image ----
        h2, w2 = c12.shape[1:3]
        up_flow3 = _bilinear(flow3, (h2, w2))
        up_u3 = _bilinear(u3, (h2, w2)) if uncert else None
        warp2 = warp(c22, _scale_flow(up_flow3, w2 / w_orig, h2 / h_orig))
        corr2 = local_correlation_relu_l2norm(c12, warp2, PATCH,
                                              out_dtype=cdt)
        res_flow2, x2 = self._run(self.decoder2,
                                  decoder_input(corr2, up_flow3, up_u3))
        flow2 = res_flow2.float() + up_flow3
        if uncert:
            u2 = self._run(um2, corr2, x2, up_u3.to(cdt),
                           up_flow3.to(cdt)).float()

        # ---- level 1: 1/4 of the image ----
        h1, w1 = c11.shape[1:3]
        up_flow2 = _bilinear(flow2, (h1, w1))
        up_u2 = _bilinear(u2, (h1, w1)) if uncert else None
        up_feat2 = self.reduce(_bilinear(x2, (h1, w1)))
        warp1 = warp(c21, _scale_flow(up_flow2, w1 / w_orig, h1 / h_orig))
        corr1 = local_correlation_relu_l2norm(c11, warp1, PATCH,
                                              out_dtype=cdt)
        res_flow1, x1 = self._run(
            self.decoder1, decoder_input(corr1, up_flow2, up_u2, up_feat2))
        if self.refinement_module_finest is not None:
            res_flow1 = res_flow1 + self._run(self.refinement_module_finest,
                                              x1)
        flow1 = res_flow1.float() + up_flow2

        flow4 = _scale_flow(flow4_256, w_orig / w_256, h_orig / h_256)
        if uncert:
            u1 = self._run(um1, corr1, x1, up_u2.to(cdt),
                           up_flow2.to(cdt)).float()
            u4 = u4_256 + diag_ratio_log
            return [(flow4, u4), (flow3, u3), (flow2, u2), (flow1, u1)]
        return [flow4, flow3, flow2, flow1]
