"""Dense-matching building blocks of UAWarpC on NHWC tensors
(counterpart of ``refign_tpu/models/matching_modules.py``).

The residual-skip flow decoder, the dilated refinement module and the
correlation-uncertainty module.  Activation LeakyReLU(0.1), BatchNorm
(``batch_norm``, the reference's default; False puts a bias on each conv
instead): on its running statistics in eval mode, on the batch's in train
mode, where it updates the running ones (UAWarpC training,
``refign_tpu/models/matching_modules.py`` with ``train=True``).
``nn.layers.grouped_bn`` sets their BatchNorms to normalise G row groups
of the batch each on its own statistics, the JAX modules' ``bn_groups``
and ``_PackedBN.groups``.
The decoders take their input width, as torch layers do; the parameter
names are those of the JAX modules, so ``load_jax_variables`` fills them.

The uncertainty module treats the (B,H,W,S*S) correlation volume as B*H*W
little SxS images, at S = 16 and at S = 9 alike (the reference form).  The
JAX package computes S = 9 as a Toeplitz matmul with a packed BatchNorm
(``_PatchConv``/``_PackedBN``), a TPU workaround; here it is an ordinary
conv and BN on the little images, with the same parameters.  In train mode
the BN statistics are over the same samples as the packed form's (every
output position of every pixel's little image); the packed form applies
the bf16 affine in bf16, this one in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import ConvBNReLU, conv2d, leaky_relu

FEAT = 32  # width of the decoders' output feature


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """torch.nn.MaxPool2d(2, 2) on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class OpticalFlowEstimator(nn.Module):
    """Residual-skip flow decoder; returns (2-ch mapping or flow, feat)."""

    def __init__(self, in_channels: int, batch_norm: bool = True):
        super().__init__()

        def cbr(cin, cout, k):
            return ConvBNReLU(cin, cout, kernel_size=k, activation=None,
                              use_norm=batch_norm)

        self.conv_0 = cbr(in_channels, 128, 3)
        self.conv_1 = cbr(128, 128, 3)
        self.conv_2 = cbr(128, 96, 3)
        self.conv0_skip = cbr(128, 96, 1)
        self.conv_3 = cbr(96, 64, 3)
        self.conv_4 = cbr(64, 32, 3)
        self.conv2_skip = cbr(96, 32, 1)
        self.predict_mapping = conv2d(32, 2, kernel_size=3, padding=1)

    def forward(self, x: torch.Tensor):
        x0 = self.conv_0(x)
        x1 = leaky_relu(self.conv_1(leaky_relu(x0)))
        x2_skip = self.conv_2(x1) + self.conv0_skip(x0)
        x3 = leaky_relu(self.conv_3(leaky_relu(x2_skip)))
        x4_skip = self.conv_4(x3) + self.conv2_skip(x2_skip)
        feat = leaky_relu(x4_skip)
        return self.predict_mapping(feat), feat


class RefinementModule(nn.Module):
    """Dilated residual flow refiner: dilations 1, 2, 4, 8, 16, 1, then a
    3x3 prediction (``dc_convs.6``)."""

    def __init__(self, in_channels: int, batch_norm: bool = True):
        super().__init__()
        chans = [in_channels, 128, 128, 128, 96, 64, 32]
        dils = [1, 2, 4, 8, 16, 1]
        layers = [ConvBNReLU(chans[i], chans[i + 1], kernel_size=3,
                             dilation=d, activation=leaky_relu,
                             use_norm=batch_norm)
                  for i, d in enumerate(dils)]
        layers.append(conv2d(32, 2, kernel_size=3, padding=1))
        self.dc_convs = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dc_convs(x)


class UncertaintyModule(nn.Module):
    """Correlation-uncertainty head: the S x S correlation of each pixel is
    a little image, convolved down to 6 statistics, then joined with the
    decoder feature (and, with ``feed_in_previous``, the upsampled previous
    log-variance and flow) into a 1-channel log-variance."""

    def __init__(self, search_size: int = 9, feed_in_previous: bool = False,
                 batch_norm: bool = True):
        super().__init__()
        if search_size not in (9, 16):
            raise ValueError(f"unsupported search_size {search_size}")
        self.search_size = search_size
        self.feed_in_previous = feed_in_previous

        # a group's rows of the little images are its pixels' rows, as
        # the batch's rows lead the (B*H*W, S, S, 1) stack
        def cbr(cin, cout, padding=None):
            return ConvBNReLU(cin, cout, kernel_size=3, padding=padding,
                              activation=leaky_relu, use_norm=batch_norm)

        self.conv_0 = cbr(1, 32, padding=0)
        self.conv_1 = cbr(32, 32, padding=0)
        self.conv_2 = cbr(32, 16, padding=0)
        self.predict_uncertainty = conv2d(16, 6, kernel_size=3, padding=0)
        n_in = 6 + FEAT + (3 if feed_in_previous else 0)
        self.pred_conv_0 = cbr(n_in, 32)
        self.pred_conv_1 = cbr(32, 16)
        self.predict_uncertainty_final = conv2d(16, 1, kernel_size=3,
                                                padding=1)

    def forward(self, corr: torch.Tensor, feat: torch.Tensor,
                prev_uncert=None, prev_flow=None) -> torch.Tensor:
        B, H, W, SS = corr.shape
        S = self.search_size
        if SS != S * S:
            raise ValueError(f"correlation has {SS} channels, expected {S * S}")
        # the last axis is the search position, row first: (S, S) images
        x = self.conv_0(corr.reshape(B * H * W, S, S, 1))
        if S == 16:
            x = max_pool_2x2(x)
        x = self.conv_2(self.conv_1(x))
        uncert_corr = self.predict_uncertainty(x).reshape(B, H, W, 6)
        parts = [uncert_corr, feat]
        if self.feed_in_previous:
            parts += [prev_uncert, prev_flow]
        x = self.pred_conv_1(self.pred_conv_0(torch.cat(parts, dim=-1)))
        return self.predict_uncertainty_final(x)
