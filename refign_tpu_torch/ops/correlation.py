"""Local and global feature correlation: kernel K3, its backward, and their
plain versions.

Counterpart of ``refign_tpu/ops/correlation.py``.  NHWC throughout.  For an
odd patch size P (R = (P-1)//2) the local correlation is

    out[b, h, w, (dy+R)*P + (dx+R)] = sum_c t[b, h, w, c] * s[b, h+dy, w+dx, c]

with zeros where (h+dy, w+dx) falls outside the image, computed in fp32
whatever the input dtype.  On CUDA tensors both ``local_correlation(t, s,
P)`` (the raw fp32 volume) and ``local_correlation_relu_l2norm(t, s, P,
out_dtype)`` (its ReLU + L2 over the P*P axis, applied inside the kernel
before the volume leaves it, written in ``out_dtype``) launch the
hand-written kernel ``csrc/local_correlation.cu`` once; where t or s
requires grad they do so inside a ``torch.autograd.Function`` whose
backward launches ``csrc/local_correlation_backward.cu`` once (counted by
``local_correlation_backward.launches``), forming only the gradients that
``needs_input_grad`` asks for.  On CPU tensors they run their plain
versions, :func:`local_correlation_reference` and
:func:`local_correlation_relu_l2norm_reference`, whose autograd is the
plain backward.

Both backwards differentiate as JAX does at its two non-smooth points
(``refign_tpu/ops/correlation.py:181-184``): ``jnp.maximum(corr, 0)`` has
gradient 0.5 at an exact 0 (1 above, 0 below), and where a pixel's sum of
squares is under 1e-24 the clamp ``jnp.maximum(ss, 1e-24)`` passes
``g / 1e-12`` to the volume and nothing through the sum.  Exact zeros occur
at every zero-padded tap and wherever the warped source left the image.
``relu_l2norm`` is an ``autograd.Function`` with that backward written out
(``clamp_min`` would give 1 at 0, ``relu`` 0).

The global correlation is a plain fp32 batched product (``torch.bmm``), as
the JAX package leaves it to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "local_correlation", "local_correlation_reference",
    "local_correlation_backward", "relu_l2norm",
    "local_correlation_relu_l2norm",
    "local_correlation_relu_l2norm_reference", "global_correlation",
    "mutual_matching", "global_correlation_relu_l2norm", "MAX_PATCH",
]

# the kernel's 16-column window (x - 4 .. x + 11) of an 8-pixel row segment
# holds every dx of P <= 9, the size on the path
MAX_PATCH = 9


def _check_patch(patch_size: int) -> None:
    if patch_size % 2 != 1 or not 1 <= patch_size <= MAX_PATCH:
        raise ValueError(f"patch_size must be odd and <= {MAX_PATCH}, got "
                         f"{patch_size}")


def local_correlation_reference(t: torch.Tensor, s: torch.Tensor,
                                patch_size: int = 9) -> torch.Tensor:
    """Plain version: the static shift loop of the JAX package
    (``_local_correlation_xla``) on the fp32 values of the inputs; its
    autograd is the VJP that JAX's ``custom_vjp`` takes."""
    _check_patch(patch_size)
    B, H, W, _ = t.shape
    R = (patch_size - 1) // 2
    t32 = t.float()
    s_pad = F.pad(s.float(), (0, 0, R, R, R, R))
    outs = [(t32 * s_pad[:, dy:dy + H, dx:dx + W]).sum(-1)
            for dy in range(patch_size) for dx in range(patch_size)]
    return torch.stack(outs, dim=-1)


def _lib():
    lib = _build.load("local_correlation")
    fn = lib.local_correlation_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = _build.load("local_correlation_backward")
    fn = lib.local_correlation_backward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, s: torch.Tensor) -> None:
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"local_correlation kernel takes fp32 or bf16, got "
                        f"{t.dtype}")
    if s.dtype != t.dtype:
        raise TypeError("target and source must share a dtype")
    if s.device != t.device:
        raise ValueError("target and source must be on one device")
    if t.dim() != 4 or s.shape != t.shape:
        raise ValueError(f"target and source must be NHWC of one shape, got "
                         f"{tuple(t.shape)} and {tuple(s.shape)}")
    if t.shape[0] > 65535 or t.shape[1] > 65535:
        raise ValueError(f"local_correlation kernels take B, H <= 65535, got "
                         f"{tuple(t.shape)}")


def _launch(t: torch.Tensor, s: torch.Tensor, patch_size: int,
            fused: bool, out_dtype: torch.dtype) -> torch.Tensor:
    _check(t, s)
    B, H, W, C = t.shape
    out = torch.empty((B, H, W, patch_size * patch_size), dtype=out_dtype,
                      device=t.device)
    if out.numel() == 0:
        return out
    fn = _lib()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        # read through the strides: the warped source arrives as the NHWC
        # view of grid_sample's NCHW output
        err = fn(t.data_ptr(), s.data_ptr(), out.data_ptr(),
                 int(t.dtype == torch.bfloat16), B, H, W, C, patch_size,
                 *t.stride(), *s.stride(), int(fused),
                 int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"local_correlation kernel launch failed: CUDA "
                           f"error {err}")
    local_correlation.launches += 1
    return out


def local_correlation_backward(t: torch.Tensor, s: torch.Tensor,
                               g: torch.Tensor, patch_size: int = 9,
                               fused: bool = False, need_t: bool = True,
                               need_s: bool = True
                               ) -> Tuple[Optional[torch.Tensor],
                                          Optional[torch.Tensor]]:
    """(gt, gs) of the raw volume (``fused`` False; g is its fp32
    gradient) or of its ReLU + L2 (``fused``; g is the gradient of that
    output, fp32 or bf16), through one launch of the backward kernel
    (``launches`` counts each).  CUDA only; t, s and g are read through
    their strides; each gradient comes back NHWC-contiguous in t's dtype,
    or None where ``need_t`` / ``need_s`` is False."""
    _check_patch(patch_size)
    _check(t, s)
    B, H, W, C = t.shape
    PP = patch_size * patch_size
    if tuple(g.shape) != (B, H, W, PP) or g.device != t.device:
        raise ValueError(f"g must be ({B},{H},{W},{PP}) on {t.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"g must be fp32 or bf16, got {g.dtype}")
    gt = torch.empty(t.shape, dtype=t.dtype, device=t.device) \
        if need_t else None
    gs = torch.empty(t.shape, dtype=t.dtype, device=t.device) \
        if need_s else None
    if t.numel() == 0 or not (need_t or need_s):
        return gt, gs
    graw = (torch.empty((B, H, W, PP), dtype=torch.float32, device=t.device)
            if fused else None)
    fn = _bwd_lib()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = fn(t.data_ptr(), s.data_ptr(), g.data_ptr(),
                 None if graw is None else graw.data_ptr(),
                 None if gt is None else gt.data_ptr(),
                 None if gs is None else gs.data_ptr(),
                 int(t.dtype == torch.bfloat16),
                 int(g.dtype == torch.bfloat16), B, H, W, C, patch_size,
                 *t.stride(), *s.stride(), *g.stride(), int(fused), stream)
    if err != 0:
        raise RuntimeError(f"local_correlation backward kernel launch "
                           f"failed: CUDA error {err}")
    local_correlation_backward.launches += 1
    return gt, gs


local_correlation_backward.launches = 0


class _LocalCorrelation(torch.autograd.Function):
    """K3 forward (raw or fused) and its backward kernel, for CUDA inputs
    that require grad (the JAX ``_local_correlation_fused`` custom_vjp,
    and the ReLU + L2 after it in the fused mode)."""

    @staticmethod
    def forward(ctx, t, s, patch_size, fused, out_dtype):
        ctx.save_for_backward(t, s)
        ctx.patch_size, ctx.fused = patch_size, fused
        return _launch(t, s, patch_size, fused, out_dtype)

    @staticmethod
    def backward(ctx, g):
        t, s = ctx.saved_tensors
        need_t, need_s = ctx.needs_input_grad[:2]
        gt, gs = local_correlation_backward(t, s, g, ctx.patch_size,
                                            ctx.fused, need_t, need_s)
        return gt, gs, None, None, None


def _apply(t: torch.Tensor, s: torch.Tensor, patch_size: int, fused: bool,
           out_dtype: torch.dtype) -> torch.Tensor:
    if torch.is_grad_enabled() and (t.requires_grad or s.requires_grad):
        return _LocalCorrelation.apply(t, s, patch_size, fused, out_dtype)
    return _launch(t, s, patch_size, fused, out_dtype)


def local_correlation(t: torch.Tensor, s: torch.Tensor,
                      patch_size: int = 9) -> torch.Tensor:
    """(B,H,W,C) target x (B,H,W,C) source -> (B,H,W,P*P) fp32 volume.
    CUDA tensors launch the kernel (``launches`` counts each launch of
    either mode), and its backward kernel where t or s requires grad; CPU
    tensors take the plain version."""
    _check_patch(patch_size)
    if t.device.type == "cpu":
        return local_correlation_reference(t, s, patch_size)
    return _apply(t, s, patch_size, False, torch.float32)


local_correlation.launches = 0


class _ReluL2Norm(torch.autograd.Function):
    """ReLU + L2 over the last axis with JAX's gradient at its two
    non-smooth points (see the module docstring)."""

    @staticmethod
    def forward(ctx, corr):
        r = corr.clamp_min(0.0)
        ss = r.square().sum(-1, keepdim=True)
        den = ss.clamp_min(1e-24).sqrt()
        ctx.save_for_backward(corr, ss, den)
        return r / den

    @staticmethod
    def backward(ctx, g):
        corr, ss, den = ctx.saved_tensors
        g = g.float()
        n = corr.clamp_min(0.0) / den
        dot = (g * n).sum(-1, keepdim=True)
        d = torch.where(ss < 1e-24, g / den, (g - n * dot) / den)
        slope = torch.where(corr > 0, 1.0,
                            torch.where(corr == 0, 0.5, 0.0))
        return (slope * d).to(corr.dtype)


def relu_l2norm(corr: torch.Tensor) -> torch.Tensor:
    """ReLU, then L2 over the last axis with the ``max(ss, 1e-24)`` clamp
    (torch ``F.normalize``'s eps 1e-12 on the norm); differentiable as the
    JAX ``jnp.maximum`` form."""
    return _ReluL2Norm.apply(corr)


def _out_dtype(out_dtype) -> torch.dtype:
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be fp32 or bf16, got {out_dtype}")
    return out_dtype


def local_correlation_relu_l2norm_reference(
        t: torch.Tensor, s: torch.Tensor, patch_size: int = 9,
        out_dtype=None) -> torch.Tensor:
    """Plain version of the fused mode: the fp32 volume, ReLU + L2, then one
    rounding to ``out_dtype`` (fp32 when None)."""
    return relu_l2norm(local_correlation_reference(t, s, patch_size)).to(
        _out_dtype(out_dtype))


def local_correlation_relu_l2norm(t: torch.Tensor, s: torch.Tensor,
                                  patch_size: int = 9,
                                  out_dtype=None) -> torch.Tensor:
    """ReLU + L2-normalised local correlation
    (``refign_tpu/ops/correlation.py:174-184``), computed in fp32 and
    written in ``out_dtype`` (fp32 or bf16; fp32 when None).  CUDA tensors
    launch the kernel's fused mode once, and the backward kernel where t
    or s requires grad; CPU tensors take the plain version."""
    _check_patch(patch_size)
    out_dtype = _out_dtype(out_dtype)
    if t.device.type == "cpu":
        return local_correlation_relu_l2norm_reference(t, s, patch_size,
                                                       out_dtype)
    return _apply(t, s, patch_size, True, out_dtype)


def global_correlation(source: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """(B,Hs,Ws,C) source, (B,Ht,Wt,C) target -> (B,Ht,Wt,Hs*Ws) fp32; the
    last axis is the source position, H first."""
    B, Ht, Wt, C = target.shape
    Hs, Ws = source.shape[1:3]
    corr = torch.bmm(target.float().reshape(B, Ht * Wt, C),
                     source.float().reshape(B, Hs * Ws, C).transpose(1, 2))
    return corr.reshape(B, Ht, Wt, Hs * Ws)


def mutual_matching(corr: torch.Tensor) -> torch.Tensor:
    """Cyclic-consistency reweighting of a (B,Ht,Wt,Hs*Ws) volume:
    corr * (corr / max over source) * (corr / max over target)."""
    eps = 1e-5
    max_src = corr.amax(dim=-1, keepdim=True)
    max_trg = corr.amax(dim=(1, 2), keepdim=True)
    return corr * ((corr / (max_src + eps)) * (corr / (max_trg + eps)))


def global_correlation_relu_l2norm(source: torch.Tensor,
                                   target: torch.Tensor,
                                   cyclic_consistency: bool = True
                                   ) -> torch.Tensor:
    """GlobalFeatureCorrelationLayer (``refign_tpu/ops/correlation.py:
    220-229``), fp32."""
    corr = global_correlation(source, target)
    if cyclic_consistency:
        corr = mutual_matching(corr)
    return relu_l2norm(corr)
