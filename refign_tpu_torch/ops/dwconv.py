"""Fused depthwise 3x3 conv + bias + GELU: kernel K2 and its plain version.

Counterpart of ``refign_tpu/ops/dwconv.py``.  ``dwconv3x3_gelu(x, w, b)``
keeps the JAX signature: NHWC x, HWIO (3, 3, 1, C) w (the OIHW (C, 1, 3, 3)
view is taken too), (C,) b.  On a CUDA tensor it launches the hand-written
kernel ``csrc/dwconv3x3_gelu.cu``, and where x, w or b requires grad it
does so inside a ``torch.autograd.Function`` whose backward launches the
hand-written ``csrc/dwconv3x3_gelu_backward.cu`` (dx, dw, db; counted by
``dwconv3x3_gelu_backward.launches``); on a CPU tensor it runs
:func:`dwconv3x3_gelu_reference`, whose autograd is the plain backward.

GELU is the exact erf form on every dtype, as in the TPU kernel.  The JAX
package's default bf16 arm uses the tanh form (``refign_tpu/nn/layers.py:
86-98``); that difference is deliberate.

The backward (the JAX ``_fused_bwd``: the VJP of the fp32 shift-and-add
formulation) runs in fp32, g' = g * GELU'(z) included, and rounds dx, dw
and db once to the input dtype, as autograd of the plain version does; dw
comes back in the weight's own layout.  On bf16 maps of whole 8-channel
vectors it is one halo tile that keeps g' on chip
(``tests/test_torch_dwconv_bwd_tiling.py`` emulates its tiling); fp32
and other maps go through an fp32 g' map in device memory.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["dwconv3x3_gelu", "dwconv3x3_gelu_backward",
           "dwconv3x3_gelu_reference"]


def _as_oihw(w: torch.Tensor, C: int) -> torch.Tensor:
    if tuple(w.shape) == (3, 3, 1, C):
        return w.permute(3, 2, 0, 1)
    if tuple(w.shape) == (C, 1, 3, 3):
        return w
    raise ValueError(f"depthwise 3x3 weight must be (3,3,1,{C}) or "
                     f"({C},1,3,3), got {tuple(w.shape)}")


def dwconv3x3_gelu_reference(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 grouped conv + bias + exact GELU, cast to x's
    dtype (the JAX default arm, in fp32)."""
    C = x.shape[-1]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), _as_oihw(w, C).float(),
                 b.float(), padding=1, groups=C)
    return F.gelu(y, approximate="none").permute(0, 2, 3, 1).to(x.dtype)


def _lib():
    lib = _build.load("dwconv3x3_gelu")
    fn = lib.dwconv3x3_gelu_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = _build.load("dwconv3x3_gelu_backward")
    fn = lib.dwconv3x3_gelu_backward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.dwconv3x3_gelu_backward_scratch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.dwconv3x3_gelu_backward_scratch.restype = None
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dwconv3x3_gelu kernel takes fp32 or bf16, got "
                        f"{x.dtype}")
    if w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError("x, w and b must share a dtype")
    if not (w.device == x.device == b.device):
        raise ValueError("x, w and b must be on one device")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("dwconv3x3_gelu kernel needs NHWC-contiguous x")
    B, H, W, C = x.shape
    if b.shape != (C,):
        raise ValueError(f"bias must be ({C},), got {tuple(b.shape)}")
    _as_oihw(w, C)


def _launch(x: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    # the kernel reads tap (i, j) of channel c at w[i*si + j*sj + c*sc],
    # so either weight layout is taken in place, without a copy
    w_sc, _, w_si, w_sj = _as_oihw(w, C).stride()
    b = b.contiguous()
    y = torch.empty_like(x)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 int(x.dtype == torch.bfloat16), B, H, W, C, w_si, w_sj, w_sc,
                 stream)
    if err != 0:
        raise RuntimeError(f"dwconv3x3_gelu kernel launch failed: CUDA "
                           f"error {err}")
    dwconv3x3_gelu.launches += 1
    return y


def dwconv3x3_gelu_backward(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, g: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """dx, dw, db of ``dwconv3x3_gelu(x, w, b)`` for the output gradient
    ``g`` (NHWC, x's shape), through the backward kernels (``launches``
    counts each call that launches them).  CUDA only; dw has w's shape and
    layout."""
    _check(x, w, b)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must match x: {tuple(g.shape)} {g.dtype}")
    B, H, W, C = x.shape
    g = g.contiguous()
    w_sc, _, w_si, w_sj = _as_oihw(w, C).stride()
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    db = torch.empty_like(b, memory_format=torch.contiguous_format)
    dw_sc, _, dw_si, dw_sj = _as_oihw(dw, C).stride()
    lib = _bwd_lib()
    is_bf16 = int(x.dtype == torch.bfloat16)
    # the kernel picks its body from the dtype, C and the alignment of x, g
    # and dx, and says what scratch that body needs: the fp32 g' map (none
    # on the bf16 halo tile, which keeps g' on chip) and the partials
    sizes = (ctypes.c_longlong * 2)()
    lib.dwconv3x3_gelu_backward_scratch(x.data_ptr(), g.data_ptr(),
                                        dx.data_ptr(), is_bf16, B, H, W, C,
                                        sizes)
    f32 = dict(dtype=torch.float32, device=x.device)
    gp = torch.empty(sizes[0], **f32) if sizes[0] else None
    part = torch.empty(sizes[1], **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dwconv3x3_gelu_backward(
            x.data_ptr(), w.data_ptr(), b.contiguous().data_ptr(),
            g.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
            None if gp is None else gp.data_ptr(), part.data_ptr(), is_bf16,
            B, H, W, C, w_si, w_sj, w_sc, dw_si, dw_sj, dw_sc, stream)
    if err != 0:
        raise RuntimeError(f"dwconv3x3_gelu backward kernel launch failed: "
                           f"CUDA error {err}")
    dwconv3x3_gelu_backward.launches += 1
    return dx, dw, db


dwconv3x3_gelu_backward.launches = 0


class _DWConvGELU(torch.autograd.Function):
    """K2 forward and its backward kernels, for CUDA inputs that require
    grad (the JAX ``_fused`` custom_vjp)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return _launch(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        return dwconv3x3_gelu_backward(x, w, b, g)


def dwconv3x3_gelu(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 (stride 1, pad 1) conv + bias + exact GELU on NHWC.
    CUDA tensors launch the kernel (``launches`` counts each launch), and
    its backward kernels where an input requires grad; CPU tensors take the
    plain version."""
    if x.device.type == "cpu":
        return dwconv3x3_gelu_reference(x, w, b)
    _check(x, w, b)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return _DWConvGELU.apply(x, w, b)
    return _launch(x, w, b)


dwconv3x3_gelu.launches = 0
