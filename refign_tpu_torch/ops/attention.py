"""Spatial-reduction attention: kernel K1 and its plain version.

Counterpart of ``refign_tpu/ops/attention.py``.  ``sra_attention(q, k, v,
scale)`` keeps the JAX signature: q (B, N, H, D), k/v (B, M, H, D) ->
(B, N, H, D) in q's dtype.  On a CUDA tensor it launches the hand-written
kernel ``csrc/sra_attention.cu``, and where q, k or v requires grad it does
so inside a ``torch.autograd.Function`` whose backward launches the
hand-written ``csrc/sra_attention_backward.cu`` (dq, dk, dv; counted by
``sra_attention_backward.launches``); on a CPU tensor it runs
:func:`sra_attention_reference`, whose autograd is the plain backward.

Numerics follow the TPU kernel (``_make_kernel``): fp32 logits with the
true row max, fp32 softmax and products.  The JAX package's default bf16
path (``_attn_einsum_bf16``: bf16 logits, static shift 20) is deliberately
not reproduced.  The JAX wrapper also pre-scales q in q's dtype; the port
scales the fp32 logits instead.  On bf16 tensors the kernel runs both
products on the tensor cores, the fp32 probabilities entering P V as a
bf16 hi + lo pair (~16 bits); ``tests/test_torch_attention_numerics.py``
emulates that arithmetic and holds it to the bf16 limit.

The backward (the JAX ``_attn_fused_bwd``: the VJP of the fp32 einsum)
keeps the softmax, P and dS in fp32 and rounds dq, dk and dv once to the
input dtype, as autograd of the plain version does.  On bf16 tensors the
forward, in grad mode only, also returns its fp32 output and the base-2
log-sum-exp of each row (:func:`sra_attention_forward` with
``stats=True``), and the backward kernel reads them instead of
recomputing the softmax; P and dS enter its tensor-core products as bf16
hi + lo pairs (``tests/test_torch_attention_bwd_numerics.py`` emulates it).
On fp32 tensors the backward recomputes the statistics.  k and v may be
the two halves of one kv projection: the backward returns dk and dv as
separate tensors and autograd adds them into the kv gradient.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = ["sra_attention", "sra_attention_forward",
           "sra_attention_backward", "sra_attention_reference", "MAX_KV",
           "HEAD_DIM"]

HEAD_DIM = 64
# the JAX kernel's gate (refign_tpu/ops/attention.py:40); the CUDA kernel
# streams K/V and has no such limit, but keeps the gate: above it, a CUDA
# call raises
MAX_KV = 4096


def sra_attention_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version: fp32 einsum, softmax, einsum (the JAX
    ``_attn_einsum_fp32``), on the fp32 values of the inputs."""
    attn = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    attn = attn.softmax(dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v.float())
    return out.to(q.dtype)


def _lib():
    lib = _build.load("sra_attention")
    fn = lib.sra_attention_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = _build.load("sra_attention_backward")
    fn = lib.sra_attention_backward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 21
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> bool:
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:-1]))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sra_attention kernel takes fp32 or bf16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    if not (k.device == q.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f", v {tuple(v.shape)}")
    B, N, H, D = q.shape
    M = k.shape[1]
    if D != HEAD_DIM or k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError(f"sra_attention kernel needs head dim {HEAD_DIM} "
                         f"and matching q/k/v; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if N < 1 or M < 1:
        raise ValueError("sra_attention needs N >= 1 and M >= 1")
    if M > MAX_KV:
        raise ValueError(f"sra_attention kernel takes M <= {MAX_KV}, got {M}")


def sra_attention_forward(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, scale: float, stats: bool = False
                          ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One launch of the forward kernel on CUDA tensors (``launches``
    counts it): the output, and with ``stats`` on bf16 tensors the
    statistics the backward kernel reads, the fp32 output (B, N, H, D) and
    the base-2 log-sum-exp of each row of ``scale * log2(e) * q k^T``,
    (B, H, N) fp32; otherwise no statistics."""
    _check(q, k, v)
    B, N, H, D = q.shape
    M = k.shape[1]
    # the kernel reads 16-byte vectors along the head dim
    q, k, v = (t if _aligned(t) else t.contiguous().clone()
               for t in (q, k, v))
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    saved: Tuple[torch.Tensor, ...] = ()
    if stats and q.dtype == torch.bfloat16:
        saved = (torch.empty(o.shape, dtype=torch.float32, device=q.device),
                 torch.empty((B, H, N), dtype=torch.float32,
                             device=q.device))
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 *((t.data_ptr() for t in saved) if saved else (None, None)),
                 int(q.dtype == torch.bfloat16), B, N, M, H,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], float(scale), stream)
    if err != 0:
        raise RuntimeError(f"sra_attention kernel launch failed: CUDA error "
                           f"{err}")
    sra_attention.launches += 1
    return o, saved


def dkdv_splits(B: int, N: int, M: int, H: int,
                device: torch.device) -> int:
    """Query splits of the backward's dk/dv kernel: N is split until the
    card has two waves of blocks at two blocks an SM, into splits of equal
    whole 64-query tiles, none of them empty."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ntiles, mtiles = -(-N // 64), -(-M // 64)
    per = -(-ntiles // max(1, min(ntiles, -(-4 * sms // (mtiles * H * B)))))
    return -(-ntiles // per)


def sra_attention_backward(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor, scale: float,
                           stats: Tuple[torch.Tensor, ...] = ()
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """dq, dk, dv of ``sra_attention(q, k, v, scale)`` for the output
    gradient ``do`` (B, N, H, D), through the backward kernel
    (``launches`` counts each call that launches it).  CUDA only; the
    inputs go through their strides.  ``stats``: on bf16 tensors, the
    statistics of ``sra_attention_forward(q, k, v, scale, stats=True)``
    (required); on fp32, none."""
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must match q: {tuple(do.shape)} {do.dtype}")
    B, N, H, D = q.shape
    M = k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        if (len(stats) != 2 or stats[0].shape != (B, N, H, D)
                or stats[1].shape != (B, H, N)
                or any(t.dtype != torch.float32 or t.device != q.device
                       or not t.is_contiguous() for t in stats)):
            raise ValueError("bf16 sra_attention_backward needs the fp32 "
                             "output and log-sum-exp of sra_attention_forward"
                             "(..., stats=True)")
    elif stats:
        raise ValueError("fp32 sra_attention_backward takes no statistics")
    # the bf16 kernels read 16-byte vectors along the head dim
    q, k, v, do = (t if _aligned(t) else t.contiguous().clone()
                   for t in (q, k, v, do))
    dq = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, M, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    nsplit = dkdv_splits(B, N, M, H, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    # Delta for the bf16 kernels; row max, 1/row sum and Delta for fp32
    scratch = torch.empty((1 if bf16 else 3) * B * H * N, **f32)
    part = torch.empty(2 * nsplit * B * H * M * D, **f32)
    fn = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 *((t.data_ptr() for t in stats) if bf16 else (None, None)),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 scratch.data_ptr(), part.data_ptr(), int(bf16),
                 B, N, M, H, nsplit,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *do.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
                 *dv.stride()[:3], float(scale), stream)
    if err != 0:
        raise RuntimeError(f"sra_attention backward kernel launch failed: "
                           f"CUDA error {err}")
    sra_attention_backward.launches += 1
    return dq, dk, dv


sra_attention_backward.launches = 0


class _SRAttention(torch.autograd.Function):
    """K1 forward and its backward kernel, for CUDA inputs that require
    grad (the JAX ``_attn_fused`` custom_vjp).  The forward's statistics
    go through ``save_for_backward``, so a non-reentrant checkpoint drops
    them with the block and recomputes them."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, stats = sra_attention_forward(q, k, v, scale, stats=True)
        ctx.save_for_backward(q, k, v, *stats)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, *stats = ctx.saved_tensors
        dq, dk, dv = sra_attention_backward(q, k, v, do.contiguous(),
                                            ctx.scale, tuple(stats))
        return dq, dk, dv, None


def sra_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Multi-head SRA attention: q (B, N, H, D), k/v (B, M, H, D) ->
    (B, N, H, D).  CUDA tensors launch the kernel (``launches`` counts
    each launch), and its backward kernel where an input requires grad;
    CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return sra_attention_reference(q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _SRAttention.apply(q, k, v, scale)
    return sra_attention_forward(q, k, v, scale)[0]


sra_attention.launches = 0
