"""LayerNorm over the last axis of bf16 rows without a gradient: kernel K5
and its plain version.

No counterpart among the JAX package's ops: it leaves LayerNorm to XLA.
``layer_norm(x, weight, bias, eps)`` computes the bf16 arm of
``refign_tpu/nn/layers.py:126-136`` (``nn.layers.TorchLayerNorm`` on bf16):
fp32 statistics, the variance as E[x^2] - E[x]^2 clamped at 0, then
``x*s + t`` with ``s = r*w`` and ``t = b - m*r*w`` (a product, then a sum)
and one rounding to bf16.  ``weight`` and ``bias`` are (C,), bf16 or fp32.

On a CUDA tensor it launches the hand-written kernel ``csrc/layer_norm.cu``
(``launches`` counts every launch), which takes C % 8 == 0 from 8 to 512;
on a CPU tensor it runs :func:`layer_norm_reference`, the composite that
``TorchLayerNorm`` runs where a gradient flows.  K5 has no backward: inputs
that require grad raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["layer_norm", "layer_norm_reference"]

MAX_C = 512  # the kernel's widest row (csrc/layer_norm.cu, MAX_C)


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version: the bf16 arm as fp32 torch ops, cast to x's dtype."""
    x32 = x.float()
    w = weight.float()
    b = bias.float()
    m = x32.mean(-1, keepdim=True)
    m2 = x32.square().mean(-1, keepdim=True)
    r = torch.rsqrt(torch.clamp(m2 - m.square(), min=0.0) + eps)
    s = r * w
    t = b - m * r * w
    return (x32 * s + t).to(x.dtype)


def _lib():
    fn = _build.load("layer_norm").layer_norm_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           eps: float) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"layer_norm takes bf16 x, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError("layer_norm needs a last axis to normalise")
    C = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        if tuple(t.shape) != (C,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({C},) tensor, "
                             f"got shape {tuple(t.shape)}")
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{name} must be bf16 or fp32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if weight.dtype != bias.dtype:
        raise TypeError(f"weight ({weight.dtype}) and bias ({bias.dtype}) "
                        f"must share a dtype")
    if not (isinstance(eps, (int, float)) and math.isfinite(eps)
            and eps > 0):
        raise ValueError(f"eps must be a finite number > 0, got {eps!r}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        raise ValueError("layer_norm has no backward; inputs that require "
                         "grad take layer_norm_reference")
    if x.device.type == "cpu":
        return
    if not x.is_contiguous():
        raise ValueError("layer_norm kernel needs rows stored densely "
                         "(contiguous x)")
    if C % 8 != 0 or not 8 <= C <= MAX_C:
        raise ValueError(f"layer_norm kernel takes C % 8 == 0 and 8 <= C "
                         f"<= {MAX_C}, got C = {C}")
    if x.data_ptr() % 16 != 0:
        raise ValueError("layer_norm kernel needs x 16-byte aligned")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm of bf16 x over its last axis, no gradient.  CUDA tensors
    launch K5, CPU tensors take the plain version."""
    _check(x, weight, bias, eps)
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    y = torch.empty_like(x)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), int(weight.dtype == torch.bfloat16),
                 x.numel() // x.shape[-1], x.shape[-1], float(eps), stream)
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error "
                           f"{err}")
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
