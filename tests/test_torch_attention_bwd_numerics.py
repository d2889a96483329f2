"""The arithmetic of K1's bf16 backward body, emulated on the CPU.

``refign_tpu_torch/csrc/sra_attention_backward.cu`` takes bf16 q, k, v and
dO, and from K1's grad-mode forward the fp32 output O and the base-2
log-sum-exp of each row's scaled logits.  Both of its kernels recompute
the fp32 logits S on the tensor cores (bf16 products, fp32 sums) and
P = exp2(S * scale * log2 e - lse), and form dP = dO V^T and
dS = P * (dP - Delta) with Delta = rowsum(dO * O) in fp32.  The dQ kernel
sums dS K over 64-key chunks; the dK/dV kernel sums P^T dO and dS^T Q over
64-query tiles into one fp32 partial per query split, and the partials
are added in split order.  P and dS enter those products as bf16 hi + lo
pairs (two products each); dq, dk and dv are rounded once to bf16.  With
a single key (M = 1) dS is 0 exactly.

:func:`emulate_backward` repeats those steps in plain PyTorch.  It is held
against ``jax.vjp`` of the JAX op with the Pallas kernel in interpret mode
and against autograd of the port's plain version, within the limit that
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the card's bf16
gradients to: 3e-5 * max|ref| + 2^-8 * |ref|.  The cheaper variants break
that limit, each shown by a test: one bf16 P, one bf16 dS, and Delta from
the bf16 output the forward returns.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.ops.attention import sra_attention as jax_sra_attention
from refign_tpu_torch.ops.attention import sra_attention_reference

GRAD_REL = 3e-5     # of each gradient's largest |ref|
BF16_REL = 2.0 ** -8
SCALE = 64 ** -0.5
CHUNK = 64          # keys per chunk in the forward and the dQ kernel
QTILE = 64          # queries per tile in the dK/dV kernel
NSPLIT = 3          # query splits of the dK/dV kernel (the card's SM count
                    # sets it; the order of the sum is what is emulated)


def _inputs(B, N, M, H, seed):
    """Seeded randn q, dO (B,N,H,64) and k, v (B,M,H,64), rounded to bf16
    and held as fp32 (the values the kernels read)."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, n, H, 64).astype(np.float32))
            .bfloat16().float() for n in (N, M, M, N)]


def _bf16(t):
    return t.bfloat16().float()


def _parts(x, split):
    """x as the bf16 operands of its products: hi + lo, or one bf16."""
    hi = _bf16(x)
    return [hi, _bf16(x - hi)] if split else [hi]


def emulate_forward(q, k, v, scale):
    """K1's grad-mode forward: the bf16 output, the fp32 output and the
    base-2 log-sum-exp of each row of the scaled logits, (B, H, N)."""
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, *, D)
    s2 = torch.matmul(qh, kh.transpose(-1, -2)) * (scale * math.log2(math.e))
    m = torch.full(s2.shape[:-1], -math.inf)
    l = torch.zeros(s2.shape[:-1])
    o = torch.zeros(qh.shape)
    for c0 in range(0, s2.shape[-1], CHUNK):
        s = s2[..., c0:c0 + CHUNK]
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        vc = vh[..., c0:c0 + CHUNK, :]
        o = o * alpha[..., None] + sum(part @ vc for part in _parts(p, True))
        m = m_new
    o32 = o / l[..., None]
    return _bf16(o32), o32, m + torch.log2(l)


def emulate_backward(q, k, v, do, scale, split_p=True, split_ds=True,
                     delta="fp32_o"):
    """dq, dk, dv (bf16 values as fp32) of the bf16 backward body.  Delta
    from the forward's fp32 O ("fp32_o", the kernel's choice), from its
    bf16 O ("bf16_o") or as rowsum(P * dP) over all keys ("p_dp")."""
    o_bf16, o32, lse = emulate_forward(q, k, v, scale)
    qh, kh, vh, doh = (t.permute(0, 2, 1, 3) for t in (q, k, v, do))
    N, M = q.shape[1], k.shape[1]
    p = torch.exp2(torch.matmul(qh, kh.transpose(-1, -2))
                   * (scale * math.log2(math.e)) - lse[..., None])
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    if delta == "fp32_o":
        dlt = (doh * o32).sum(-1)
    elif delta == "bf16_o":
        dlt = (doh * o_bf16).sum(-1)
    else:
        dlt = (p * dp).sum(-1)
    # one key: the softmax is the constant 1 and dS is 0 exactly; the
    # kernels set it so, where dP - Delta would leave its rounding (the
    # limit is 0 there, as every exact gradient of q and k is)
    ds = p * (dp - dlt[..., None]) if M > 1 else torch.zeros_like(p)
    # dQ kernel: 64-key chunks in order
    dq = torch.zeros(qh.shape)
    for c0 in range(0, M, CHUNK):
        for part in _parts(ds[..., c0:c0 + CHUNK], split_ds):
            dq = dq + part @ kh[..., c0:c0 + CHUNK, :]
    # dK/dV kernel: query tiles in order within a split, splits in order
    ntiles = -(-N // QTILE)
    per = -(-ntiles // NSPLIT)
    dk = torch.zeros(kh.shape)
    dv = torch.zeros(kh.shape)
    for split in range(NSPLIT):
        pk = torch.zeros(kh.shape)
        pv = torch.zeros(kh.shape)
        for t in range(split * per, min(ntiles, (split + 1) * per)):
            r = slice(t * QTILE, (t + 1) * QTILE)
            for part in _parts(p[..., r, :], split_p):
                pv = pv + part.transpose(-1, -2) @ doh[..., r, :]
            for part in _parts(ds[..., r, :], split_ds):
                pk = pk + part.transpose(-1, -2) @ qh[..., r, :]
        dk = dk + pk
        dv = dv + pv
    return [_bf16(t).permute(0, 2, 1, 3)
            for t in (scale * dq, scale * dk, dv)]


def _plain_grads(q, k, v, do, scale):
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(sra_attention_reference(*ins, scale), ins, do)


def _jax_grads(q, k, v, do, scale):
    def f(q, k, v):
        return jax_sra_attention(q, k, v, scale, use_pallas=True,
                                 interpret=True)

    # one compiled program per case: eager interpret mode dispatches the
    # Pallas forward's grid steps one by one
    grads = jax.jit(lambda q, k, v, g: jax.vjp(f, q, k, v)[1](g))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, do)))
    return [torch.from_numpy(np.array(g)) for g in grads]


def _n_beyond(got, ref):
    """Elements of the three gradients beyond the limit."""
    n = 0
    for g, r in zip(got, ref):
        lim = GRAD_REL * r.abs().max() + BF16_REL * r.abs()
        n += int(((g - r).abs() > lim).sum())
    return n


CASES = [(N, M, H) for N in (1, 63, 130) for M in (1, 17, 65, 256, 289)
         for H in (1, 2)]


@pytest.mark.parametrize("N,M,H", CASES)
def test_emulated_backward_matches_jax_pallas_vjp(N, M, H):
    q, k, v, do = _inputs(2, N, M, H, seed=N * 1000 + M * 10 + H)
    got = emulate_backward(q, k, v, do, SCALE)
    want = _jax_grads(q, k, v, do, SCALE)
    assert _n_beyond(got, want) == 0, [(g - w).abs().max()
                                       for g, w in zip(got, want)]


@pytest.mark.parametrize("N,M,H", CASES)
def test_emulated_backward_matches_plain_version(N, M, H):
    q, k, v, do = _inputs(2, N, M, H, seed=N * 1000 + M * 10 + H + 7)
    got = emulate_backward(q, k, v, do, SCALE)
    want = _plain_grads(q, k, v, do, SCALE)
    assert _n_beyond(got, want) == 0, [(g - w).abs().max()
                                       for g, w in zip(got, want)]


@pytest.mark.parametrize("variant", [dict(split_p=False),
                                     dict(split_ds=False),
                                     dict(delta="bf16_o")],
                         ids=["single_bf16_p", "single_bf16_ds",
                              "delta_from_bf16_o"])
def test_cheaper_variant_breaks_the_limit(variant):
    """At N = 130, M = 289, H = 2 each cheaper variant puts hundreds of
    gradient elements beyond the limit; the kernel's choice puts none."""
    q, k, v, do = _inputs(2, 130, 289, 2, seed=11)
    want = _plain_grads(q, k, v, do, SCALE)
    cheap = _n_beyond(emulate_backward(q, k, v, do, SCALE, **variant), want)
    chosen = _n_beyond(emulate_backward(q, k, v, do, SCALE), want)
    assert cheap > 300 and chosen == 0, (cheap, chosen)


def test_delta_from_all_keys_equals_the_fp32_output_choice():
    """Delta as rowsum(P * dP) over all keys (an extra pass of S and dP)
    holds the limit as the fp32 O does; the kernel takes the fp32 O, which
    costs a write and a read of (B, N, H, 64) fp32 instead."""
    q, k, v, do = _inputs(2, 130, 289, 2, seed=12)
    want = _plain_grads(q, k, v, do, SCALE)
    assert _n_beyond(emulate_backward(q, k, v, do, SCALE, delta="p_dp"),
                     want) == 0
