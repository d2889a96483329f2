"""The arithmetic of K3's bf16 backward body, emulated on the CPU.

``refign_tpu_torch/csrc/local_correlation_backward.cu`` takes bf16 t and s
and the gradient g of the volume (raw mode, fp32) or of its ReLU + L2
(fused mode, bf16 or fp32), and forms gt and gs as banded products on the
tensor cores:

* fused mode, kernel A: the raw sums with the forward's banded tile
  (emulated by ``test_torch_correlation_tiling.emulate_tc_kernel``, whose
  constants are read from the shared tile header), then per pixel graw with
  JAX's rule (ReLU slope 0.5 at an exact 0, g / 1e-12 where the sum of
  squares is clamped) in fp32, written to an fp32 scratch map.  Raw mode:
  graw is g.
* kernel B: graw enters the products as a bf16 hi + lo pair (two
  products).  For gt, each of the P + 1 source rows a pair of target rows
  sees, ascending, adds the band of graw (16 pixels x the 16-column window
  from x - 4) times the source window, the hi product then the lo product,
  in fp32; for gs the same over the P + 1 target rows that a pair of source
  rows gathers from, ascending (dy descending), with the band of graw
  gathered from the target pixels and the target window.  Each product
  sums its window columns in ascending order.  The outputs are rounded
  once to bf16.

:func:`emulate_backward` repeats those steps in plain PyTorch.  It is held
against ``jax.vjp`` of the JAX package's functions and against autograd of
the port's plain version within the limit that ``chip_smoke.py`` holds
the card's gradients to (``check_corr_grad``, scales from
``corr_grad_scale``: 3e-5 of each element's sum of term magnitudes, the
whole term where a raw sum is within fp32 noise of the ReLU's kink, plus
2^-8 |ref| in bf16), on the inputs of ``chip_smoke.corr_grad_case`` (a
zero target pixel, a zero source block that whole 9x9 windows lie in).
The cheaper ways to carry graw into the products, one bf16 and one TF32
(``mma`` m16n8k8, where bf16 t and s convert exactly), break that limit,
each shown by a test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.ops import correlation as jc
from refign_tpu_torch.ops import correlation as tc
from test_torch_correlation_tiling import _tc_constants, emulate_tc_kernel

def _bf16(x):
    return x.bfloat16().float()


def _tf32(x):
    """Round fp32 to TF32 (10 mantissa bits), to nearest, ties away
    (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _parts(graw, variant):
    """graw as the A operands of its products."""
    if variant == "hi+lo":
        hi = _bf16(graw)
        return [hi, _bf16(graw - hi)]
    if variant == "bf16":
        return [_bf16(graw)]
    if variant == "tf32":
        return [_tf32(graw)]
    raise ValueError(variant)


def graw_fused(t, s, g, P):
    """Kernel A: the forward's raw sums, then graw with JAX's rule in
    fp32."""
    raw = emulate_tc_kernel(t, s, P)
    r = raw.clamp_min(0.0)
    ss = r.square().sum(-1, keepdim=True)
    den = ss.clamp_min(1e-24).sqrt()
    n = r / den
    g = g.float()
    dot = (g * n).sum(-1, keepdim=True)
    d = torch.where(ss < 1e-24, g / den, (g - n * dot) / den)
    slope = torch.where(raw > 0, 1.0, torch.where(raw == 0, 0.5, 0.0))
    return slope * d


def emulate_backward(t, s, g, P, fused, need_t=True, need_s=True,
                     variant="hi+lo"):
    """(gt, gs) of the bf16 body on (B,H,W,C) t, s holding bf16 values and
    g (B,H,W,P*P); None where not wanted."""
    _, halo, win, _ = _tc_constants()  # the band window from x - halo
    R = (P - 1) // 2
    assert R <= halo and win == 16  # one k-step of window
    B, H, W, C = t.shape
    graw = graw_fused(t, s, g, P) if fused else g.float()
    parts = [p.reshape(B, H, W, P, P) for p in _parts(graw, variant)]
    t32, s32 = t.float(), s.float()
    gt = gs = None
    if need_t:
        # gt[y, x] = sum over source rows y + dy - R, ascending
        s_pad = torch.nn.functional.pad(s32, (0, 0, R, R, R, R))
        acc = torch.zeros(B, H, W, C)
        for dy in range(P):
            for a in parts:
                prod = torch.zeros(B, H, W, C)
                for dx in range(P):  # window column x + dx - R, ascending
                    prod = prod + a[..., dy, dx, None] * \
                        s_pad[:, dy:dy + H, dx:dx + W]
                acc = acc + prod
        gt = _bf16(acc)
    if need_s:
        # gs[q] = sum over target rows q_y - (dy - R), ascending: dy
        # descending; the target pixel q - d_k holds tap k
        t_pad = torch.nn.functional.pad(t32, (0, 0, R, R, R, R))
        a_pad = [torch.nn.functional.pad(a, (0, 0, 0, 0, R, R, R, R, 0, 0))
                 for a in parts]
        acc = torch.zeros(B, H, W, C)
        for dy in reversed(range(P)):
            oy = 2 * R - dy  # padded row of q_y - (dy - R)
            for a in a_pad:
                prod = torch.zeros(B, H, W, C)
                for dx in reversed(range(P)):  # window column ascending
                    ox = 2 * R - dx
                    prod = prod + a[:, oy:oy + H, ox:ox + W, dy, dx, None] \
                        * t_pad[:, oy:oy + H, ox:ox + W]
                acc = acc + prod
        gs = _bf16(acc)
    return gt, gs


def _case(B, H, W, C, P, fused, seed):
    """``chip_smoke.corr_grad_case`` with numpy: unit-norm target (NHWC)
    and source features rounded to bf16, a target pixel of zeros, a source
    block of zeros, g in the output's dtype (bf16 fused, fp32 raw)."""
    rng = np.random.RandomState(seed)
    t = rng.randn(B, H, W, C).astype(np.float32)
    s = rng.randn(B, H, W, C).astype(np.float32)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    t[0, H // 2, W // 3] = 0
    s[:, :min(H, 12), :min(W, 14)] = 0
    g = rng.randn(B, H, W, P * P).astype(np.float32)
    t, s = _bf16(torch.from_numpy(t)), _bf16(torch.from_numpy(s))
    g = torch.from_numpy(g)
    return t, s, (_bf16(g) if fused else g)


def _jax_grads(t, s, g, P, fused):
    fn = (jc.local_correlation_relu_l2norm if fused
          else lambda a, b, p: jc.local_correlation(a, b, p,
                                                    use_pallas=False))
    _, vjp = jax.vjp(lambda a, b: fn(a, b, P), jnp.asarray(t.numpy()),
                     jnp.asarray(s.numpy()))
    return [torch.from_numpy(np.array(x)) for x in vjp(jnp.asarray(
        g.numpy()))]


def _plain_grads(t, s, g, P, fused):
    plain = (tc.local_correlation_relu_l2norm_reference if fused
             else tc.local_correlation_reference)
    a, b = t.clone().requires_grad_(), s.clone().requires_grad_()
    return torch.autograd.grad(plain(a, b, P), (a, b), g.float())


def _check(got, refs, scales, jumps, what):
    for i, (x, ref, sc, jp) in enumerate(zip(got, refs, scales, jumps)):
        if x is not None:
            chip_smoke.check_corr_grad(f"{what} d{i}", x.bfloat16(), ref,
                                       sc, jp, torch.bfloat16)


CASES = [(2, 9, 33, 13, 9), (1, 11, 65, 40, 9), (2, 7, 70, 13, 3),
         (1, 9, 70, 40, 9)]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("B,H,W,C,P", CASES)
def test_emulation_holds_the_limit(B, H, W, C, P, fused):
    """Both gradients against the JAX VJP and the plain version."""
    t, s, g = _case(B, H, W, C, P, fused, seed=7 * W + C + P)
    got = emulate_backward(t, s, g, P, fused)
    assert all(torch.isfinite(x).all() for x in got)
    scales, jumps = chip_smoke.corr_grad_scale(t, s, g, P, fused)
    _check(got, _jax_grads(t, s, g, P, fused), scales, jumps, "vs JAX")
    _check(got, _plain_grads(t, s, g, P, fused), scales, jumps, "vs plain")


@pytest.mark.parametrize("fused", [True, False])
def test_emulation_gs_alone(fused):
    """The path's call (a frozen target): gs alone is the same as with
    both, and holds the limit."""
    B, H, W, C, P = 2, 9, 65, 40, 9
    t, s, g = _case(B, H, W, C, P, fused, seed=5)
    none_t, gs = emulate_backward(t, s, g, P, fused, need_t=False)
    assert none_t is None
    assert torch.equal(gs, emulate_backward(t, s, g, P, fused)[1])
    scales, jumps = chip_smoke.corr_grad_scale(t, s, g, P, fused)
    refs = _jax_grads(t, s, g, P, fused)
    _check((None, gs), refs, scales, jumps, "gs alone")


def test_emulation_has_clamped_pixels():
    """The case's zero target pixel (5, 21) and a pixel (5, 5) whose whole
    window lies in the zero source block are clamped: graw ~1e12 there."""
    t, s, g = _case(1, 11, 65, 40, 9, True, seed=1)
    graw = graw_fused(t, s, g, 9)
    for y, x in ((5, 21), (5, 5)):
        assert graw[0, y, x].abs().amax() > 1e11


@pytest.mark.parametrize("variant", ["bf16", "tf32"])
def test_cheaper_graw_breaks_the_limit(variant):
    """One bf16 or one TF32 graw: the rounding of graw (2^-9, 2^-11)
    exceeds 3e-5 of the term magnitudes where terms cancel."""
    B, H, W, C, P = 1, 11, 65, 40, 9
    t, s, g = _case(B, H, W, C, P, True, seed=3)
    got = emulate_backward(t, s, g, P, True, variant=variant)
    scales, jumps = chip_smoke.corr_grad_scale(t, s, g, P, True)
    with pytest.raises(AssertionError, match="beyond the limit"):
        _check(got, _plain_grads(t, s, g, P, True), scales, jumps, variant)


# A tap near the ReLU's kink: on kernel_ab.py's stage-1 inputs (the 65^2
# level, C = 256), target pixel (2, 17, 42), tap 73 (dy = 4, dx = -3) with
# source pixel (2, 21, 39); t and s as bf16 bit patterns.  The H100's
# banded product (the forward's raw sum, which kernel A forms bit for bit)
# gave KINK_KERNEL_RAW there (kernel_ab.py's report, NVIDIA H100 80GB
# HBM3, 700 W): slope 0, where the plain version takes slope 1.
KINK_T = (
    "3c2e3d1bbde93d3d3d2c3ce13cff3c0b3c2bbd363de3bd20bc923e00bd1fbd2b"
    "bd50bdeb3d28bd003bedbd2dbde93d743c5cbcd1bcc33d19bcd93cd2bcc63bdd"
    "bb49bd8f3cf23c55bcfbbd3c3d33bcd23dc1bdbdbdb4bda63d693aadbc613dd6"
    "3d68bd8cbd4c3d36bdb43df4bc53bb29bd94bc613c02bd0abdf73d6a3d773d05"
    "bdc1baf0bc22bd32bc193dcbbd8c3cdd3d073dc8bcca3c82bc38bbd0bc813d92"
    "3ce2bc95bd8dbe0fbd973d63bd963be83e113ce2bdb03d0c3befbe083c67bcd0"
    "3d28bbcc3d733c8d3d22bcfabe1dbdddbdf53c6fbdf2be02bd3abe223cfa3cf9"
    "bd2abbafbd3dbd1a3dc1bd88bbcdbdc8bdf43adebc57bd9cbd033c873daabd06"
    "bd11bd983d123d503dc13e15bd313d17be283ccd3c913d093d7f3bcebd83bd73"
    "3d853bd7bd28bc263d95bdbabd623a823d203ca23c9abd34bd2bbdcf3c54bd88"
    "bd09bdb03d8b3d2f3d433c673d013d5bbcd53dd5bccfbd4c39e93e19bd033d82"
    "bb1c3da03d93bd323c973da3bd79bd0fbda3bc4a3d4dbb263c1c3d48bd18bc3d"
    "bc27bc903c1a3d97bd883d903db2bdef3d073d253d7fbbd7bdb0bc7d3d673d8a"
    "3d803a97bd78bd86bde93d133c933d893c1bbd0fbba63ceebdb93c49bcbdbd60"
    "bda93d133d5a3dbc3d0e3e0d3e1cbd663c883d373d593d843d17bc9f3cb2bc23"
    "bc9d3d16ba8d3e143d50bd713c663d2e3d45bd76bc8ebd54be24bbb7bd2a3d13")
KINK_S = (
    "bcc8bc16bdd23aa83c903d79bd113d87bba8bd0b3a1b3d183c17be0ebd933d2d"
    "bd87bd9d3e20bd9abd8fbd57bc363befbd613c483d5bbd63bd37bd86bda73dd8"
    "bd72bd68bc983c8cbc8b3b38bc81bd17bc26bd07bd503bbebd373db13d9c3cf6"
    "bd5f3e12bc9fbc8c3d903cbe3d39bd643c0b3cedbb73bd7fbdeabd7a3d37bcac"
    "3d823dcd3d5cbe07bd30bd0fbd793dc2bd8ebcd6bd8abc50bc3ebc473ce4bda6"
    "3c68bd213b8e3c733c91bd163dd9bd54bb2cbce33d66bc003cd53dc4bda0bc22"
    "3d363d433d13bc863d24bbbb3b33be17be07bdc83dafbda13d773ba5bcf8bd90"
    "bd4dbd1abd72bde13cf9bbb83d7cbd2f3d463e113d43bd27bb7c3ddebd033c83"
    "3cd1be08bdb8bd15bda93d4fbd3fbd80bd2d3ce0bb83be0dbc0f3cae3d613db6"
    "bce9bdc13bd1bcf53db83d2fbd4fbdde3d71bc8fbd563ca63de4bd0e3cc6bd2b"
    "bcc93c833d1c3e093ba0bd6b3d373dc23d803cf6bd203cde3c1a3dd23d1cbc92"
    "3d3dbcccbd6739f73bcdbdbcbd773d77bca6bdc5bd9a3d8a3c3bbd34bd7ebdff"
    "bc153d033bb2bd363d4ebd79bd053bbabd003e00bd9ebdd43d643bbc3d5e3ceb"
    "3cee3b0b3d413e8439e1bd223cb33c4a3d3bbdef3c09bd5ebd6dbd64bc96be13"
    "3d8c3d96bd3c3de2bcefbd2cbccd3da8bc22399d3d86bb42bcd53d89bd2e3d8c"
    "bd8dbe3e3c5bbd453d063d063d013c303c80bc4c3dc63d28bb9f39ec3d8abc95")
KINK_TAP, KINK_KERNEL_RAW = 73, -4.656612873077393e-10


def _bf16_bits(hexstr):
    """fp32 values of bf16 bit patterns, four hex digits each."""
    bits = np.array([int(hexstr[i:i + 4], 16)
                     for i in range(0, len(hexstr), 4)], np.uint32)
    return (bits << 16).view(np.float32)


def test_kink_tap_signs():
    """The tap's exact sum (fp64, where the bf16 products and their sum are
    exact) is positive; JAX's fp32 shift loop and the plain version agree
    on a positive sum (slope 1), the H100's banded product gave a negative
    one (slope 0).  All three lie within the fp32 noise band (1e-5 of the
    sum of |t||s|) where ``corr_grad_scale`` grants the tap's whole term."""
    t, s = _bf16_bits(KINK_T), _bf16_bits(KINK_S)
    prod = t.astype(np.float64) * s.astype(np.float64)
    exact, mag = prod.sum(), np.abs(prod).sum()
    P, R = 9, 4
    dy, dx = divmod(KINK_TAP, P)
    tt = np.zeros((1, P, P, t.size), np.float32)
    ss = np.zeros_like(tt)
    tt[0, R, R] = t
    ss[0, dy, dx] = s  # source pixel (R + dy - R, R + dx - R)
    jax_raw = float(jc._local_correlation_xla(
        jnp.asarray(tt), jnp.asarray(ss), P)[0, R, R, KINK_TAP])
    plain = tc.local_correlation_reference(torch.from_numpy(tt),
                                           torch.from_numpy(ss), P)
    plain_raw = float(plain[0, R, R, KINK_TAP])
    assert exact > 0 and jax_raw > 0 and plain_raw > 0 > KINK_KERNEL_RAW
    for raw in (exact, jax_raw, plain_raw, KINK_KERNEL_RAW):
        assert abs(raw) <= 1e-5 * mag
