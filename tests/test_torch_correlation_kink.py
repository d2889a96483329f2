"""K3-bwd's check at the ReLU's kink, witnessed on the CPU.

``chip_smoke.corr_grad_limit`` holds K3's backward to
``GRAD_REL*scale + jump + BF16_REL*(|ref| + jump)`` in bf16, with the
bounds of ``chip_smoke.corr_grad_scale``: ``jump`` grants the whole term
of every tap whose raw sum lies within fp32 noise of 0, where the kernel's
summation order may take the other ReLU slope than the plain version's.
A kernel that does so rounds a value near ``|ref| + jump`` to bf16, so the
bf16 allowance is on ``|ref| + jump``; the earlier limit had it on
``|ref|`` alone.

The witness is a tap whose raw sum has opposite signs in two summation
orders: the plain shift loop (the port's plain version; JAX's fp32 loop
agrees with it) and the band order of the bf16 body, emulated by
``tests/test_torch_correlation_bwd_tiling.py`` (one 16-channel k-step of
the banded product at a time).  The target pixel holds four nonzero
channels, 1, e, -1 and -0.75e, each in its own 16-channel chunk, against
ones at the source pixel: the band adds the chunks in order and loses e
beside 1, the plain and JAX sums keep it.  One gradient element is built
to need the bf16 allowance on jump: its only other term nearly cancels the
kink tap's, so the true value is near 0 while the band's value, without
the tap, is near the tap's whole term.

The plain version's fp32 sum can also land on 0 exactly where the exact
sum does not (1 + 2^-26 - 1 in that order): the plain version then takes
JAX's slope 0.5, the kernel's sum the exact side's slope.  K3-bwd met one
such tap at the folded UAWarpC step's level (18 x 130 x 130 x 128 on an
H100; the kernel's gradient equalled the float64 one there, the plain
version's was 0.04 off), so ``jump`` covers a tap whose sum is 0 while
some product is not; a tap whose every product is 0 (zero features, the
padding) is an exact zero, where both sides take 0.5, and gets none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.ops import correlation as jc
from refign_tpu_torch.ops import correlation as tc
from test_torch_correlation_bwd_tiling import (_jax_grads, _plain_grads,
                                               emulate_backward, graw_fused)
from test_torch_correlation_tiling import emulate_tc_kernel

B, H, W, C, P = 1, 9, 12, 64, 9
R = (P - 1) // 2
# the kink tap: target pixel P0, tap K0 (dy = +2, dx = -2), source pixel Q0;
# the target's four nonzero channels, one per 16-channel chunk, and their
# values (bf16): the exact sum is 0.375 * 2^-26 > 0
CHANNELS = (24, 26, 1, 61)
TERMS = (1.0, 1.5 * 2.0 ** -26, -1.0, -1.125 * 2.0 ** -26)
P0, Q0, K0 = (0, 4, 4), (0, 6, 2), 6 * P + 2
# the witness element gt[P0, CW]: channel CW is zero at P0's target, so it
# adds nothing to P0's raw sums; of P0's window only Q0 (1) and Q2 (tap K2,
# dy = -1, dx = +1; the value chosen below) hold it
CW, Q2, K2 = 40, (0, 3, 5), 3 * P + 5
# how many bf16 values of Q2's channel CW, around the value that cancels the
# kink tap's term, the witness tries
TRIES = 8


def _base():
    """Unit-norm target and source features and a gradient, rounded to
    bf16 (seeded), with the kink tap and the witness channel built in."""
    rng = np.random.RandomState(0)
    t = rng.randn(B, H, W, C).astype(np.float32)
    s = rng.randn(B, H, W, C).astype(np.float32)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    t[P0] = 0
    s[Q0] = 0
    for c, v in zip(CHANNELS, TERMS):
        t[P0 + (c,)] = v
        s[Q0 + (c,)] = 1.0
    s[Q0 + (CW,)] = 1.0
    for dy in range(P):
        for dx in range(P):
            q = (0, P0[1] + dy - R, P0[2] + dx - R)
            if q != Q0 and 0 <= q[1] < H and 0 <= q[2] < W:
                s[q + (CW,)] = 0.0
    g = rng.randn(B, H, W, P * P).astype(np.float32)
    return [torch.from_numpy(x).bfloat16().float() for x in (t, s, g)]


def _plain_graw(t, s, g):
    raw = tc.local_correlation_reference(t, s, P).requires_grad_()
    return torch.autograd.grad(tc.relu_l2norm(raw), raw, g)[0]


@pytest.fixture(scope="module")
def kink():
    t, s, g = _base()
    graw = _plain_graw(t, s, g)
    cancel = -graw[P0 + (K0,)] / graw[P0 + (K2,)]
    # the bf16 values of Q2's channel CW nearest the cancelling one,
    # nearest first
    steps = sorted(range(-TRIES // 2, TRIES // 2 + 1), key=abs)
    values = []
    for j in steps:
        v = float((cancel * (1 + j * 2.0 ** -6)).bfloat16())
        if v not in values:
            values.append(v)
    cases = []
    for v in values:
        sv = s.clone()
        sv[Q2 + (CW,)] = v
        cases.append(sv)
    return t, cases, g


def test_tap_signs_differ_between_orders(kink):
    """At the tap the band's raw sum is negative (slope 0), the plain
    version's, JAX's and the exact one positive (slope 1); all lie within
    the fp32 noise band where ``corr_grad_scale`` grants the whole term."""
    t, cases, _ = kink
    s = cases[0]
    band = float(emulate_tc_kernel(t, s, P)[P0 + (K0,)])
    plain = float(tc.local_correlation_reference(t, s, P)[P0 + (K0,)])
    jax_raw = float(jc._local_correlation_xla(
        jnp.asarray(t.numpy()), jnp.asarray(s.numpy()), P)[P0 + (K0,)])
    prod = t[P0].double() * s[Q0].double()
    exact, mag = float(prod.sum()), float(prod.abs().sum())
    assert band < 0 < exact and plain > 0 and jax_raw > 0
    for raw in (band, plain, jax_raw, exact):
        assert abs(raw) <= 1e-5 * mag


def test_jax_vjp_takes_the_plain_slope(kink):
    """JAX's ``local_correlation_relu_l2norm`` VJP equals the plain
    version's gradient within the fp32 limit with no allowance at the kink
    (slope 1 at the tap), and differs from the band's at the witness
    element by about the tap's whole term (slope 0 there)."""
    t, cases, g = kink
    s = cases[0]
    want = _plain_grads(t, s, g, P, True)
    got = _jax_grads(t, s, g, P, True)
    scales, jumps = chip_smoke.corr_grad_scale(t, s, g, P, True)
    assert float(jumps[0][P0 + (CW,)]) > 0.1
    for x, r, sc in zip(got, want, scales):
        chip_smoke.check_corr_grad("JAX vs plain", x, r, sc,
                                   torch.zeros_like(sc), torch.float32)
    band_gt = emulate_backward(t, s, g, P, True)[0]
    tap = float(_plain_graw(t, s, g)[P0 + (K0,)])
    assert float(graw_fused(t, s, g, P)[P0 + (K0,)]) == 0.0
    np.testing.assert_allclose(
        float(got[0][P0 + (CW,)] - band_gt[P0 + (CW,)]), tap, rtol=1e-2)


def test_band_gradient_fails_the_old_limit_and_passes_the_new(kink):
    """The band's bf16 gradients (gt and gs) pass the limit at every value
    tried; at one at least an element passes only by the bf16 allowance on
    jump (the old limit fails), and every such element has jump > 0."""
    t, cases, g = kink
    only = []
    for s in cases:
        got = emulate_backward(t, s, g, P, True)
        refs = _plain_grads(t, s, g, P, True)
        scales, jumps = chip_smoke.corr_grad_scale(t, s, g, P, True)
        n = 0
        for i, (x, r, sc, jp) in enumerate(zip(got, refs, scales, jumps)):
            _, k = chip_smoke.check_corr_grad(f"band d{i}", x.bfloat16(), r,
                                              sc, jp, torch.bfloat16)
            err = (x.bfloat16().float() - r).abs()
            _, old = chip_smoke.corr_grad_limit(r, sc, jp, torch.bfloat16)
            assert k == int((err > old).sum())
            n += k
        only.append(n)
    assert any(only), only


def test_limits_agree_without_a_kink():
    """Where jump is 0 the new limit is the old one, element for element;
    in fp32 neither has a bf16 allowance."""
    gen = torch.Generator().manual_seed(0)
    ref, scale = torch.randn(50, generator=gen), torch.rand(50, generator=gen)
    jump = torch.where(torch.rand(50, generator=gen) < 0.5,
                       torch.rand(50, generator=gen), torch.zeros(50))
    lim, old = chip_smoke.corr_grad_limit(ref, scale, jump, torch.bfloat16)
    assert torch.equal(lim[jump == 0], old[jump == 0])
    assert (lim[jump > 0] > old[jump > 0]).all()
    torch.testing.assert_close(
        old, chip_smoke.GRAD_REL * scale + jump
        + chip_smoke.BF16_REL * ref.abs(), rtol=0, atol=0)
    lim, old = chip_smoke.corr_grad_limit(ref, scale, jump, torch.float32)
    assert torch.equal(lim, old)


def test_gradient_wrong_by_one_tap_fails_the_new_limit(kink):
    """A gradient that drops one tap far from the kink (raw sum above 0.05;
    the one of largest |graw|) at the kink's target pixel is beyond the new
    limit."""
    t, cases, g = kink
    s = cases[0]
    raw = tc.local_correlation_reference(t, s, P)
    graw = graw_fused(t, s, g, P)
    far = max((k for k in range(P * P) if float(raw[P0 + (k,)]) > 0.05),
              key=lambda k: abs(float(graw[P0 + (k,)])))
    graw[P0 + (far,)] = 0
    ta, sa = t.clone().requires_grad_(), s.clone().requires_grad_()
    wrong = torch.autograd.grad(tc.local_correlation_reference(ta, sa, P),
                                (ta, sa), graw)
    refs = _plain_grads(t, s, g, P, True)
    scales, jumps = chip_smoke.corr_grad_scale(t, s, g, P, True)
    with pytest.raises(AssertionError, match="beyond the limit"):
        chip_smoke.check_corr_grad("one tap dropped", wrong[0].bfloat16(),
                                   refs[0], scales[0], jumps[0],
                                   torch.bfloat16)


def _rounded_zero_case():
    """A 5x5 map of 3-channel bf16 features whose tap (dy, dx) = (+1, 0)
    at the centre sums three products 1, 2^-26 and -1: the channel order
    in which the plain version's fp32 sum is exactly 0 (the exact sum is
    2^-26), a target pixel of zeros, a seeded gradient."""
    rng = np.random.RandomState(3)
    base_t = rng.randn(1, 5, 5, 3).astype(np.float32)
    base_s = rng.randn(1, 5, 5, 3).astype(np.float32)
    g = torch.from_numpy(rng.randn(1, 5, 5, 9).astype(np.float32))
    g = g.bfloat16().float()
    import itertools
    for order in itertools.permutations((1.0, 2.0 ** -26, -1.0)):
        t, sv = base_t.copy(), base_s.copy()
        t[0, 2, 2] = order
        sv[0, 3, 2] = 1.0
        t[0, 0, 4] = 0.0  # a target pixel of zeros: exact zeros only
        t, sv = (torch.from_numpy(x).bfloat16().float() for x in (t, sv))
        raw = tc.local_correlation_reference(t, sv, 3)
        if float(raw[0, 2, 2, 7]) == 0.0:
            return t, sv, g
    pytest.fail("no channel order rounds the tap's sum onto 0")


def _exact_grads(t, s, g):
    """The fused mode's gradients from float64 sums (the exact slopes; JAX's
    0.5 where a sum is exactly 0)."""
    import torch.nn.functional as F
    a = t.double().requires_grad_()
    b = s.double().requires_grad_()
    sp = F.pad(b, (0, 0, 1, 1, 1, 1))
    raw = torch.stack([(a * sp[:, dy:dy + 5, dx:dx + 5]).sum(-1)
                       for dy in range(3) for dx in range(3)], -1)
    return [x.float() for x in torch.autograd.grad(
        tc.relu_l2norm(raw), (a, b), g.double())]


def test_a_sum_rounded_onto_zero_gets_the_kink_allowance():
    """The exact gradient (what the kernel computed at such a tap on the
    card) passes the limit only by ``jump`` at the tap; the target pixel
    of zeros gets no allowance, so a gradient with the other slope there
    fails."""
    t, s, g = _rounded_zero_case()
    refs = _plain_grads(t, s, g, 3, True)
    exact = _exact_grads(t, s, g)
    scales, jumps = chip_smoke.corr_grad_scale(t, s, g, 3, True)
    # gt at the tap's target pixel, gs at its source pixel
    assert float(jumps[0][0, 2, 2].abs().max()) > 0
    assert float(jumps[1][0, 3, 2].abs().max()) > 0
    for i, (x, r, sc, jp) in enumerate(zip(exact, refs, scales, jumps)):
        chip_smoke.check_corr_grad(f"exact d{i}", x.bfloat16(), r, sc, jp,
                                   torch.bfloat16)
    with pytest.raises(AssertionError, match="beyond the limit"):
        chip_smoke.check_corr_grad("exact d0 without jump",
                                   exact[0].bfloat16(), refs[0], scales[0],
                                   torch.zeros_like(jumps[0]),
                                   torch.bfloat16)
    # the zero pixel's taps are exact zeros: no allowance, and slope 1 in
    # place of 0.5 doubles its gt
    assert float(jumps[0][0, 0, 4].abs().max()) == 0.0
    wrong = refs[0].clone()
    wrong[0, 0, 4] *= 2
    with pytest.raises(AssertionError, match="beyond the limit"):
        chip_smoke.check_corr_grad("slope 1 at an exact zero",
                                   wrong.bfloat16(), refs[0], scales[0],
                                   jumps[0], torch.bfloat16)
