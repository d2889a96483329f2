"""The arithmetic of K1's bf16 tensor-core body, emulated on the CPU.

``refign_tpu_torch/csrc/sra_attention.cu`` multiplies bf16 q and k on the
tensor cores with fp32 sums, scales the fp32 logits, runs an online
softmax over 64-key chunks and multiplies the fp32 probabilities by bf16 v
as two bf16 products, P = P_hi + P_lo.  :func:`emulate` repeats those
steps in plain PyTorch; it is held against the JAX Pallas kernel
(interpret mode) and the port's plain version within the limit that
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the card's bf16
output to: 2^-8*|ref| + 1e-4.  One case shows that a single bf16 P does
not meet that limit, which is why the kernel splits P.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.ops.attention import fused_small_kv_attention
from refign_tpu_torch.ops.attention import sra_attention_reference

BF16_REL = 2.0 ** -8
BF16_ABS = 1e-4
SCALE = 64 ** -0.5  # a power of two: pre-scaling q (the Pallas kernel) is exact
CHUNK = 64          # keys per chunk in the kernel


def _inputs(B, N, M, H, seed):
    """Seeded randn q (B,N,H,64), k/v (B,M,H,64), rounded to bf16 and held
    as fp32 (the values the kernel reads)."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, n, H, 64).astype(np.float32))
            .bfloat16().float() for n in (N, M, M)]


def _bf16(t):
    return t.bfloat16().float()


def emulate(q, k, v, scale, split_p=True):
    """K1's bf16 body in plain PyTorch: fp32 logits, scale folded into
    exp2 with log2 e, online softmax over 64-key chunks, P V as bf16 P_hi
    and P_lo products summed in fp32 (or one bf16 P when not split_p),
    output rounded to bf16."""
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, *, D)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * (scale * math.log2(math.e))
    m = torch.full(logits.shape[:-1], -math.inf)
    l = torch.zeros(logits.shape[:-1])
    o = torch.zeros(qh.shape)
    for c0 in range(0, logits.shape[-1], CHUNK):
        s = logits[..., c0:c0 + CHUNK]
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        vc = vh[..., c0:c0 + CHUNK, :]
        if split_p:
            p_hi = _bf16(p)
            pv = torch.matmul(p_hi, vc) + torch.matmul(_bf16(p - p_hi), vc)
        else:
            pv = torch.matmul(_bf16(p), vc)
        o = o * alpha[..., None] + pv
        m = m_new
    return _bf16(o / l[..., None]).permute(0, 2, 1, 3)


def _pallas(q, k, v, scale):
    B, N, H, D = q.shape
    M = k.shape[1]

    def heads(t, n):
        return jnp.asarray(t.numpy()).transpose(0, 2, 1, 3).reshape(B * H, n, D)

    out = fused_small_kv_attention(heads(q * scale, N), heads(k, M),
                                   heads(v, M), interpret=True)
    return torch.from_numpy(np.array(
        out.reshape(B, H, N, D).transpose(0, 2, 1, 3)))


def _n_beyond(got, ref):
    return int(((got - ref).abs() > BF16_REL * ref.abs() + BF16_ABS).sum())


CASES = [(N, M, H) for N in (1, 63, 130) for M in (1, 17, 65, 289)
         for H in (1, 2)]


@pytest.mark.parametrize("N,M,H", CASES)
def test_emulated_kernel_matches_pallas_interpret(N, M, H):
    q, k, v = _inputs(2, N, M, H, seed=N * 1000 + M * 10 + H)
    got = emulate(q, k, v, SCALE)
    want = _pallas(q, k, v, SCALE)
    assert _n_beyond(got, want) == 0, (got - want).abs().max()


@pytest.mark.parametrize("N,M,H", CASES)
def test_emulated_kernel_matches_plain_version(N, M, H):
    q, k, v = _inputs(2, N, M, H, seed=N * 1000 + M * 10 + H + 7)
    got = emulate(q, k, v, SCALE)
    want = sra_attention_reference(q, k, v, SCALE)
    assert _n_beyond(got, want) == 0, (got - want).abs().max()


def test_single_bf16_p_breaks_the_limit():
    """At M = 289, N = 130, H = 2 one bf16 P puts many outputs beyond the
    limit; the hi + lo split puts none."""
    q, k, v = _inputs(2, 130, 289, 2, seed=11)
    want = sra_attention_reference(q, k, v, SCALE)
    single = _n_beyond(emulate(q, k, v, SCALE, split_p=False), want)
    split = _n_beyond(emulate(q, k, v, SCALE), want)
    assert single > 1000 and split == 0, (single, split)
