"""Dilated depthwise 3x3 conv with an optional eval BatchNorm + ReLU
epilogue: kernel K4 and its plain version.

No counterpart among the JAX package's ops: it leaves this conv, the
dilated branches of the DAFormer head's ASPP
(``refign_tpu/models/heads/daformer.py``), to XLA.
``dilated_dwconv3x3(x, w, dilation, affine=None)`` takes NHWC x, the OIHW
(C, 1, 3, 3) weight, stride 1, zero padding = dilation and no bias.
``affine = (a, c)``, per-channel fp32, adds the eval BatchNorm's fold and
ReLU to a bf16 x (the bf16 arm of ``TorchBatchNorm``; fp32 takes the conv
alone): ``relu(round(round(conv) * a + c))``, with ``a = w * rsqrt(var +
eps)`` and ``c = b - mean * a`` as ``nn.layers.TorchBatchNorm.eval_fold``
computes them, so the result equals the conv followed by
``TorchBatchNorm`` (eval, bf16) and ``F.relu`` bit for bit.

On a CUDA tensor it launches the hand-written kernel
``csrc/dilated_dwconv.cu`` (``launches`` counts every launch, ``fused`` the
launches with the epilogue); on a CPU tensor it runs
:func:`dilated_dwconv3x3_reference`.  Where x or w requires grad it runs
inside a ``torch.autograd.Function`` that saves x and w only, as
``F.conv2d``'s autograd does, and whose backward is aten's
``convolution_backward`` (cuDNN on the card), the arithmetic of
``F.conv2d``'s gradients.  The epilogue is for inference: with an input
that requires grad it raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["dilated_dwconv3x3", "dilated_dwconv3x3_reference"]

Affine = Optional[Tuple[torch.Tensor, torch.Tensor]]


def dilated_dwconv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                                dilation: int,
                                affine: Affine = None) -> torch.Tensor:
    """Plain version: fp32 grouped conv cast to x's dtype; with ``affine``
    (bf16 x), then the fp32 multiply and add, a cast to bf16 and ReLU."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float(), None, 1,
                 dilation, dilation, x.shape[-1])
    y = y.permute(0, 2, 3, 1).to(x.dtype)
    if affine is None:
        return y
    a, c = affine
    return F.relu((y.float() * a + c).to(x.dtype))


def _lib():
    fn = _build.load("dilated_dwconv").dilated_dwconv_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor, dilation: int,
           affine: Affine) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    C = x.shape[-1]
    if tuple(w.shape) != (C, 1, 3, 3):
        raise ValueError(f"depthwise 3x3 weight must be ({C},1,3,3), got "
                         f"{tuple(w.shape)}")
    if not isinstance(dilation, int) or dilation < 1:
        raise ValueError(f"dilation must be an int >= 1, got {dilation!r}")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError("x and w must share a dtype and a device")
    if affine is not None:
        if x.dtype != torch.bfloat16:
            raise ValueError(f"the BatchNorm + ReLU epilogue takes bf16 x, "
                             f"got {x.dtype}")
        for t in affine:
            if (t.shape != (C,) or t.dtype != torch.float32
                    or t.device != x.device or not t.is_contiguous()):
                raise ValueError(f"affine takes two contiguous fp32 ({C},) "
                                 f"tensors on x's device")
    if x.device.type == "cpu":
        return
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dilated_dwconv kernel takes fp32 or bf16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dilated_dwconv kernel needs NHWC-contiguous x")


def _forward(x: torch.Tensor, w: torch.Tensor, dilation: int,
             affine: Affine) -> torch.Tensor:
    if x.device.type == "cpu":
        return dilated_dwconv3x3_reference(x, w, dilation, affine)
    B, H, W, C = x.shape
    # the kernel reads tap (i, j) of channel c at w[i*si + j*sj + c*sc]
    w_sc, _, w_si, w_sj = w.stride()
    a = c = None  # null pointers: the conv alone
    if affine is not None:
        a, c = affine[0].data_ptr(), affine[1].data_ptr()
    y = torch.empty_like(x)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), a, c, y.data_ptr(),
                 int(x.dtype == torch.bfloat16), B, H, W, C, dilation, w_si,
                 w_sj, w_sc, stream)
    if err != 0:
        raise RuntimeError(f"dilated_dwconv kernel launch failed: CUDA "
                           f"error {err}")
    dilated_dwconv3x3.launches += 1
    dilated_dwconv3x3.fused += int(affine is not None)
    return y


class _DilatedDWConv(torch.autograd.Function):
    """K4 (or the plain version) forward; F.conv2d's backward."""

    @staticmethod
    def forward(ctx, x, w, dilation):
        ctx.save_for_backward(x, w)
        ctx.dilation = dilation
        return _forward(x, w, dilation, None)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d = ctx.dilation
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, None, [1, 1],
            [d, d], [d, d], False, [0, 0], x.shape[-1],
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return (None if dx is None else dx.permute(0, 2, 3, 1)), dw, None


def dilated_dwconv3x3(x: torch.Tensor, w: torch.Tensor, dilation: int,
                      affine: Affine = None) -> torch.Tensor:
    """Depthwise 3x3 conv of NHWC x, stride 1, zero padding and dilation
    ``dilation``, no bias; with ``affine = (a, c)`` followed by the fp32
    ``* a + c``, a round and ReLU.  CUDA tensors launch K4, CPU tensors take
    the plain version."""
    _check(x, w, dilation, affine)
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if affine is not None:
        if grad or (torch.is_grad_enabled()
                    and any(t.requires_grad for t in affine)):
            raise ValueError("the BatchNorm + ReLU epilogue is for "
                             "inference; inputs that require grad take "
                             "the conv alone")
        return _forward(x, w, dilation, affine)
    if grad:
        return _DilatedDWConv.apply(x, w, dilation)
    return _forward(x, w, dilation, None)


dilated_dwconv3x3.launches = 0
dilated_dwconv3x3.fused = 0
