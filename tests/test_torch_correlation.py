"""The port's correlation ops (refign_tpu_torch/ops/correlation.py) against
the JAX package, fp32 at atol 1e-5.

K3's plain version is held against the Pallas kernel in interpret mode,
against the JAX shift loop and against the native C++ oracle, at P = 9 and
P = 5 with ragged C, H and W.  The CUDA kernel itself is checked against
the same plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.native import correlation_forward
from refign_tpu.ops import correlation as jc
from refign_tpu_torch.ops import correlation as tc

TOL = dict(rtol=0, atol=1e-5)

CASES = [  # B, H, W, C, P
    (2, 9, 11, 16, 9),
    (1, 7, 12, 13, 5),
    (1, 10, 13, 40, 9),
    (2, 5, 6, 7, 5),
]


def _pair(B, H, W, C, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, W, C).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("B,H,W,C,P", CASES)
def test_plain_matches_pallas_interpret(B, H, W, C, P):
    t, s = _pair(B, H, W, C, seed=C + P)
    want = np.asarray(jc._local_correlation_pallas(
        jnp.asarray(t), jnp.asarray(s), patch_size=P, interpret=True))
    got = tc.local_correlation_reference(torch.from_numpy(t),
                                         torch.from_numpy(s), P)
    assert got.dtype == torch.float32 and got.shape == (B, H, W, P * P)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("B,H,W,C,P", CASES)
def test_plain_matches_xla_shift_loop_and_native(B, H, W, C, P):
    t, s = _pair(B, H, W, C, seed=3 * C + P)
    got = tc.local_correlation_reference(torch.from_numpy(t),
                                         torch.from_numpy(s), P).numpy()
    want = np.asarray(jc._local_correlation_xla(jnp.asarray(t),
                                                jnp.asarray(s), P))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, correlation_forward(t, s, P), **TOL)


def test_plain_reads_strided_and_bf16_inputs():
    """The NHWC view of an NCHW source gives the same volume; bf16 inputs
    give the fp32 volume of their fp32 values."""
    t, s = _pair(1, 6, 9, 12, seed=5)
    tt = torch.from_numpy(t)
    s_view = torch.from_numpy(s).permute(0, 3, 1, 2).contiguous() \
        .permute(0, 2, 3, 1)
    assert not s_view.is_contiguous()
    want = tc.local_correlation_reference(tt, torch.from_numpy(s), 9)
    torch.testing.assert_close(tc.local_correlation(tt, s_view, 9), want,
                               rtol=0, atol=1e-6)
    tb, sb = tt.bfloat16(), torch.from_numpy(s).bfloat16()
    got = tc.local_correlation(tb, sb, 9)
    assert got.dtype == torch.float32
    torch.testing.assert_close(
        got, tc.local_correlation_reference(tb.float(), sb.float(), 9),
        rtol=0, atol=0)


def test_cpu_wrapper_takes_plain_version():
    t, s = map(torch.from_numpy, _pair(1, 5, 7, 8, seed=6))
    before = tc.local_correlation.launches
    got = tc.local_correlation(t, s, 5)
    assert tc.local_correlation.launches == before
    torch.testing.assert_close(got, tc.local_correlation_reference(t, s, 5),
                               rtol=0, atol=0)


def _meta(*shape, dtype=torch.float32, requires_grad=False):
    return torch.empty(shape, device="meta", dtype=dtype,
                       requires_grad=requires_grad)


def test_off_cpu_launches_or_raises():
    """Off the CPU the wrapper never takes the plain version: inputs the
    kernel does not take raise before any build."""
    t = _meta(1, 4, 5, 6)
    with pytest.raises(TypeError):
        tc.local_correlation(t.half(), t.half(), 9)
    with pytest.raises(TypeError):
        tc.local_correlation(t, _meta(1, 4, 5, 6, dtype=torch.bfloat16), 9)
    with pytest.raises(ValueError, match="one shape"):
        tc.local_correlation(t, _meta(1, 4, 5, 7), 9)
    for P in (4, 11):
        with pytest.raises(ValueError, match="odd"):
            tc.local_correlation(t, t, P)


def test_off_cpu_grad_goes_through_both_kernels(monkeypatch):
    """Off the CPU an input that requires grad goes through the
    autograd.Function: the forward launches the forward kernel and the
    backward the backward kernel, asked only for the gradients needed
    (the launches are recorded here in place of the kernels)."""
    calls = []

    def fake_launch(t, s, P, fused, out_dtype):
        calls.append(("forward", P, fused, out_dtype))
        return torch.empty(t.shape[:3] + (P * P,), dtype=out_dtype,
                           device=t.device)

    def fake_backward(t, s, g, P, fused, need_t, need_s):
        calls.append(("backward", P, fused, need_t, need_s))
        return (torch.empty_like(t) if need_t else None,
                torch.empty_like(s) if need_s else None)

    monkeypatch.setattr(tc, "_launch", fake_launch)
    monkeypatch.setattr(tc, "local_correlation_backward", fake_backward)
    t = _meta(1, 4, 5, 6)
    s = _meta(1, 4, 5, 6, requires_grad=True)
    out = tc.local_correlation(t, s, 9)
    assert out.grad_fn is not None
    out = tc.local_correlation_relu_l2norm(t, s, 9, torch.bfloat16)
    (gs,) = torch.autograd.grad(out.float().sum(), s)
    assert calls == [("forward", 9, False, torch.float32),
                     ("forward", 9, True, torch.bfloat16),
                     ("backward", 9, True, False, True)]
    assert gs.shape == (1, 4, 5, 6)


@pytest.mark.parametrize("P", [9, 5])
def test_relu_l2norm_matches_jax(P):
    t, s = _pair(2, 8, 10, 24, seed=P)
    want = np.asarray(jc.local_correlation_relu_l2norm(
        jnp.asarray(t), jnp.asarray(s), P))
    got = tc.local_correlation_relu_l2norm(torch.from_numpy(t),
                                           torch.from_numpy(s), P)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _unit(x):
    """Unit-norm features over channels, as the UAWarpC head passes them."""
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_global_correlation_and_mutual_matching_match_jax():
    rng = np.random.RandomState(7)
    src, trg = (_unit(rng.randn(*shape).astype(np.float32))
                for shape in ((2, 5, 6, 32), (2, 4, 7, 32)))
    js, jt = jnp.asarray(src), jnp.asarray(trg)
    ts, tt = torch.from_numpy(src), torch.from_numpy(trg)
    corr = tc.global_correlation(ts, tt)
    assert corr.shape == (2, 4, 7, 30)
    np.testing.assert_allclose(corr.numpy(),
                               np.asarray(jc.global_correlation(js, jt)),
                               **TOL)
    # mutual matching on one volume, so only its own arithmetic is compared
    vol = np.abs(rng.randn(2, 4, 7, 30)).astype(np.float32)
    np.testing.assert_allclose(
        tc.mutual_matching(torch.from_numpy(vol)).numpy(),
        np.asarray(jc.mutual_matching(jnp.asarray(vol))), **TOL)


@pytest.mark.parametrize("cyclic", [True, False])
def test_global_correlation_relu_l2norm_matches_jax(cyclic):
    rng = np.random.RandomState(8)
    src, trg = (_unit(rng.randn(1, 16, 16, 64).astype(np.float32))
                for _ in range(2))
    want = np.asarray(jc.global_correlation_relu_l2norm(
        jnp.asarray(src), jnp.asarray(trg), cyclic))
    got = tc.global_correlation_relu_l2norm(torch.from_numpy(src),
                                            torch.from_numpy(trg), cyclic)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
