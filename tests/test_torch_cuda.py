"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA device.  On a machine
with one (the H100):

    python -m pytest tests/test_torch_cuda.py -q

Covers what ``chip_smoke.py``'s main-path shapes do not: ragged N and M
around K1's 16-row warp tiles, 64-query blocks and 64-key chunks, M = 1,
1 to 8 heads, head-strided and misaligned inputs, K2's halo tiles with H,
W and C ragged around the tile and the 64-channel slice, both weight
layouts, the scalar K2 path (C not a multiple of 8), K3's raw and fused
modes for both input and both output dtypes over both of its tile shapes,
the NCHW-strided source and misaligned inputs, the launch counters, the
absence of per-call copies and the wrappers' refusals; and the K1 and K2
backward kernels through autograd (inputs that require grad on CUDA launch
them) against autograd of the fp32 plain versions, over ragged shapes,
strided k/v, head-strided and misaligned q and dO, both weight layouts and
misaligned maps, within 3e-5 of each gradient's largest |ref| (fp32 sums
over many terms in another order), plus 2^-8*|ref| in bf16; K1's
grad-mode statistics (its log-sum-exp against torch.logsumexp within
1e-5 relative), the inference launch without them, identical bits from
two backward calls, and no fp32 g' map on K2's bf16 backward.  K4 (the
dilated depthwise conv) at the slide and UDA shapes of the ASPP against
the plain version and cuDNN's fp32 conv, over ragged class grids, channel
slices and the direct loop; its BatchNorm + ReLU epilogue bit for bit
against the conv + TorchBatchNorm + F.relu; its backward (aten's
convolution_backward) against F.conv2d's; its launch counts in one slide
frame (3 fused) and one UDA head forward (3 unfused).  Tolerances: a bf16
kernel output within 2^-8*|ref| + 1e-4 of the fp32 plain version on the
same inputs (one bf16 rounding plus summation order); fp32 within 1e-5;
K3 (fp32 sums of unit-norm features) within 1e-5, and its fused bf16
output within 2^-8*|ref| + 1e-5 of the fp32 fused plain version.
"""
import math

import pytest
import torch
import torch.nn.functional as F

from refign_tpu_torch import full_fp32_precision
from refign_tpu_torch.ops import _build
from refign_tpu_torch.ops.attention import (sra_attention,
                                            sra_attention_backward,
                                            sra_attention_forward,
                                            sra_attention_reference)
from refign_tpu_torch.ops.correlation import (
    local_correlation, local_correlation_backward, local_correlation_reference,
    local_correlation_relu_l2norm, local_correlation_relu_l2norm_reference)
from refign_tpu_torch.ops.dwconv import (dwconv3x3_gelu,
                                         dwconv3x3_gelu_backward,
                                         dwconv3x3_gelu_reference)
from refign_tpu_torch.ops.dilated_dwconv import (
    dilated_dwconv3x3, dilated_dwconv3x3_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: python -m pytest "
                    "tests/test_torch_cuda.py)")
    full_fp32_precision()
    # build and load every kernel before any test profiles: with a library
    # loaded after a profiling session had begun in the process, a later
    # session's trace now and then held no device events at all
    _build.build_all()
    for name in _build.kernel_names():
        _build.load(name)
    return torch.Generator(device="cuda").manual_seed(0)


def _device_kernels(fn):
    """Names of the kernels that one call of ``fn`` ran on the card, from
    the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _close(got, ref, dtype):
    assert got.dtype == dtype and got.shape == ref.shape
    err = (got.float() - ref).abs()
    if dtype == torch.bfloat16:
        assert (err <= 2.0 ** -8 * ref.abs() + 1e-4).all(), err.max()
    else:
        assert err.max().item() <= 1e-5, err.max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,M,H", [(1, 1, 1), (63, 17, 2), (64, 64, 1),
                                   (130, 65, 3), (200, 300, 2)])
def test_attention_kernel_matches_plain(gen, dtype, N, M, H):
    q = torch.randn(2, N, H, 64, generator=gen, device="cuda").to(dtype)
    kv = torch.randn(2, M, 2, H, 64, generator=gen, device="cuda").to(dtype)
    k, v = kv[:, :, 0], kv[:, :, 1]
    before = sra_attention.launches
    got = sra_attention(q, k, v, 0.125)
    assert sra_attention.launches == before + 1
    ref = sra_attention_reference(q.float(), k.float(), v.float(), 0.125)
    _close(got, ref, dtype)


def _attention_check(gen, B, N, M, H, dtype, scale=0.125):
    """k and v as the two halves of one kv projection, as the MiT block
    passes them."""
    q = torch.randn(B, N, H, 64, generator=gen, device="cuda").to(dtype)
    kv = torch.randn(B, M, 2, H, 64, generator=gen, device="cuda").to(dtype)
    k, v = kv[:, :, 0], kv[:, :, 1]
    got = sra_attention(q, k, v, scale)
    _close(got, sra_attention_reference(q.float(), k.float(), v.float(),
                                        scale), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 16, 17, 255, 256, 257, 289])
@pytest.mark.parametrize("N", [15, 17, 63, 65, 1155])
def test_attention_kernel_ragged_tiles(gen, dtype, N, M):
    _attention_check(gen, 2, N, M, (N + M) % 8 + 1, dtype)


@pytest.mark.parametrize("H", range(1, 9))
def test_attention_kernel_heads(gen, H):
    _attention_check(gen, 2, 130, 289, H, torch.bfloat16)


def test_attention_kernel_largest_stage(gen):
    """The 135^2-token MiT-B5 stage at one crop: N = 18225, M = 256."""
    _attention_check(gen, 1, 18225, 256, 1, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_misaligned_inputs(gen, dtype):
    base = torch.randn(1, 77, 2, 65, generator=gen, device="cuda").to(dtype)
    q = base[..., 1:]  # head-dim stride 1, start off a 16-byte boundary
    k = torch.randn(1, 9, 2, 64, generator=gen, device="cuda").to(dtype)
    v = torch.randn(1, 9, 2, 64, generator=gen, device="cuda").to(dtype)
    _close(sra_attention(q, k, v, 0.2),
           sra_attention_reference(q.float(), k.float(), v.float(), 0.2),
           dtype)


def test_attention_kernel_refusals(gen):
    q = torch.randn(1, 8, 1, 64, device="cuda", requires_grad=True)
    k = torch.randn(1, 4, 1, 64, device="cuda")
    with pytest.raises(TypeError):  # the grad path takes the same checks
        sra_attention(q.half(), k.half(), k.half(), 1.0)
    with pytest.raises(ValueError):
        big = torch.zeros(1, 4097, 1, 64, device="cuda")
        sra_attention(q.detach(), big, big, 1.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,C", [(1, 1, 8), (2, 7, 13), (2, 33, 40),
                                   (1, 9, 256)])
def test_dwconv_kernel_matches_plain(gen, dtype, B, S, C):
    x = torch.randn(B, S, S + 2, C, generator=gen, device="cuda").to(dtype)
    w = (0.3 * torch.randn(3, 3, 1, C, generator=gen, device="cuda")
         ).to(dtype)
    b = (0.1 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
    before = dwconv3x3_gelu.launches
    got = dwconv3x3_gelu(x, w, b)
    got_oihw = dwconv3x3_gelu(x, w.permute(3, 2, 0, 1), b)
    assert dwconv3x3_gelu.launches == before + 2
    ref = dwconv3x3_gelu_reference(x.float(), w.float(), b.float())
    _close(got, ref, dtype)
    assert torch.equal(got, got_oihw)


def _dwconv_check(gen, B, H, W, C, dtype):
    """Both weight layouts: the HWIO (3,3,1,C) tensor and the OIHW
    (C,1,3,3) one the MiT block holds, read in place."""
    x = torch.randn(B, H, W, C, generator=gen, device="cuda").to(dtype)
    w = (0.3 * torch.randn(3, 3, 1, C, generator=gen, device="cuda")
         ).to(dtype)
    b = (0.1 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
    got = dwconv3x3_gelu(x, w, b)
    got_oihw = dwconv3x3_gelu(x, w.permute(3, 2, 0, 1).contiguous(), b)
    _close(got, dwconv3x3_gelu_reference(x.float(), w.float(), b.float()),
           dtype)
    assert torch.equal(got, got_oihw)


@pytest.mark.parametrize("H,W", [(1, 1), (7, 8), (8, 9), (9, 31), (31, 33),
                                 (33, 7), (1, 135), (135, 1), (135, 135)])
def test_dwconv_kernel_ragged_tiles(gen, H, W):
    _dwconv_check(gen, 2, H, W, 64, torch.bfloat16)


@pytest.mark.parametrize("C", [8, 40, 72, 264])
def test_dwconv_kernel_ragged_channel_slice(gen, C):
    _dwconv_check(gen, 2, 17, 34, C, torch.bfloat16)


def test_dwconv_kernel_launches_once_without_copies(gen):
    """One call is one launch of the kernel and nothing else on the card:
    no weight transpose, no contiguous copy."""
    x = torch.randn(2, 34, 34, 128, generator=gen, device="cuda").bfloat16()
    w = torch.randn(128, 1, 3, 3, generator=gen, device="cuda").bfloat16()
    b = torch.randn(128, generator=gen, device="cuda").bfloat16()
    dwconv3x3_gelu(x, w, b)  # build and load outside the window
    torch.cuda.synchronize()
    before = dwconv3x3_gelu.launches
    names = _device_kernels(lambda: dwconv3x3_gelu(x, w, b))
    assert dwconv3x3_gelu.launches == before + 1
    assert len(names) == 1 and "dwconv3x3_gelu_kernel" in names[0], names


def test_dwconv_kernel_refusals(gen):
    x = torch.randn(1, 4, 5, 6, device="cuda")
    w = torch.randn(3, 3, 1, 4, device="cuda")
    b = torch.randn(4, device="cuda")
    with pytest.raises(ValueError):
        dwconv3x3_gelu(x.permute(0, 2, 3, 1), w, b)  # not NHWC-contiguous
    with pytest.raises(ValueError):  # the grad path takes the same checks
        dwconv3x3_gelu(x[..., :4].contiguous().requires_grad_(), w[..., :2],
                       b[:2])


def _unit_features(gen, B, H, W, C, dtype):
    x = torch.randn(B, H, W, C, generator=gen, device="cuda")
    return (x / x.norm(dim=-1, keepdim=True)).to(dtype)


# on an H100 (132 SMs) the last two give the launcher's 8-row tiles (at
# least one block per SM), the others its 2-row tiles
CORR_CASES = [(1, 1, 1, 1, 9), (2, 9, 33, 40, 9), (1, 17, 31, 13, 5),
              (2, 8, 32, 128, 9), (1, 12, 70, 24, 3), (1, 5, 6, 7, 7),
              (1, 4, 40, 8, 1), (2, 130, 130, 40, 9), (3, 112, 100, 32, 7)]


def _corr_close(got, t, s, P, fused, out_dtype):
    """Raw: within 1e-5 of the plain volume.  Fused: within 1e-5 (fp32
    out) or 2^-8*|ref| + 1e-5 (bf16 out) of the fp32 fused plain version."""
    if fused:
        ref = local_correlation_relu_l2norm_reference(t, s, P)
    else:
        ref = local_correlation_reference(t, s, P)
    assert got.dtype == out_dtype and got.shape == ref.shape
    err = (got.float() - ref).abs()
    rel = 2.0 ** -8 if out_dtype == torch.bfloat16 else 0.0
    assert (err <= rel * ref.abs() + 1e-5).all(), err.max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W,C,P", CORR_CASES)
def test_local_correlation_kernel_matches_plain(gen, dtype, B, H, W, C, P):
    t = _unit_features(gen, B, H, W, C, dtype)
    s = _unit_features(gen, B, H, W, C, dtype)
    before = local_correlation.launches
    got = local_correlation(t, s, P)
    assert local_correlation.launches == before + 1
    _corr_close(got, t, s, P, False, torch.float32)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W,C,P", CORR_CASES)
def test_local_correlation_fused_matches_plain(gen, dtype, out_dtype, B, H,
                                              W, C, P):
    t = _unit_features(gen, B, H, W, C, dtype)
    s = _unit_features(gen, B, H, W, C, dtype)
    before = local_correlation.launches
    got = local_correlation_relu_l2norm(t, s, P, out_dtype=out_dtype)
    assert local_correlation.launches == before + 1
    _corr_close(got, t, s, P, True, out_dtype)


def test_local_correlation_kernel_strided_source(gen):
    """The source as the NHWC view of an NCHW tensor (grid_sample's
    output), and a channel-sliced target."""
    t = _unit_features(gen, 2, 19, 45, 48, torch.bfloat16)[..., :40]
    s = _unit_features(gen, 2, 40, 19, 45, torch.bfloat16).permute(0, 2, 3, 1)
    got = local_correlation(t, s, 9)
    ref = local_correlation_reference(t.contiguous(), s.contiguous(), 9)
    assert (got - ref).abs().max().item() <= 1e-5


def _layout(gen, kind, B, H, W, C, dtype):
    """(B,H,W,C) unit-norm features in one of the layouts the kernel
    stages: NHWC, the NHWC view of NCHW, or either shifted by one element
    so that no vector load is aligned."""
    if kind == "nhwc":
        return _unit_features(gen, B, H, W, C, dtype)
    if kind == "nhwc_shifted":
        return _unit_features(gen, B, H, W, C + 1, dtype)[..., 1:]
    x = torch.randn(B, C, H, W + (kind == "nchw_shifted"), generator=gen,
                    device="cuda")
    x = (x / x.norm(dim=1, keepdim=True)).to(dtype)
    if kind == "nchw_shifted":
        x = x[..., 1:]
    return x.permute(0, 2, 3, 1)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t_kind,s_kind", [
    ("nhwc", "nchw"), ("nhwc_shifted", "nchw_shifted"),
    ("nchw", "nhwc"), ("nhwc", "nhwc_shifted")])
@pytest.mark.parametrize("B,H,W,C", [(2, 11, 36, 40), (2, 128, 144, 32)])
def test_local_correlation_kernel_layouts(gen, t_kind, s_kind, dtype, fused,
                                          B, H, W, C):
    t = _layout(gen, t_kind, B, H, W, C, dtype)
    s = _layout(gen, s_kind, B, H, W, C, dtype)
    out_dtype = torch.bfloat16 if fused else torch.float32
    got = (local_correlation_relu_l2norm(t, s, 9, out_dtype=out_dtype)
           if fused else local_correlation(t, s, 9))
    _corr_close(got, t.contiguous(), s.contiguous(), 9, fused, out_dtype)


def test_local_correlation_fused_launches_once(gen):
    """A fused call is one launch of the kernel and nothing else on the
    card: no copy of the strided source, no separate ReLU, norm or cast."""
    t = _unit_features(gen, 4, 32, 32, 256, torch.bfloat16)
    s = _layout(gen, "nchw", 4, 32, 32, 256, torch.bfloat16)
    local_correlation_relu_l2norm(t, s, 9, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()  # build and load outside the window
    before = local_correlation.launches
    names = _device_kernels(lambda: local_correlation_relu_l2norm(
        t, s, 9, out_dtype=torch.bfloat16))
    assert local_correlation.launches == before + 1
    assert len(names) == 1 and "local_correlation" in names[0], names


def test_kernels_launch_on_every_device(gen):
    """K1 and K3 need more than 48 KB of dynamic shared memory, an
    attribute set per device: after a launch on cuda:0 each kernel must
    still launch, and agree, on every other card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    q = torch.randn(1, 70, 2, 64, generator=gen, device="cuda")
    k = torch.randn(1, 33, 2, 64, generator=gen, device="cuda")
    t = _unit_features(gen, 1, 9, 33, 40, torch.float32)
    s = _unit_features(gen, 1, 9, 33, 40, torch.float32)
    x = torch.randn(1, 7, 9, 16, generator=gen, device="cuda")
    w = torch.randn(3, 3, 1, 16, generator=gen, device="cuda")
    b = torch.randn(16, generator=gen, device="cuda")
    for dev in range(torch.cuda.device_count()):
        qd, kd, td, sd, xd, wd, bd = (a.to(f"cuda:{dev}")
                                      for a in (q, k, t, s, x, w, b))
        got = sra_attention(qd, kd, kd, 0.125)
        assert got.device == qd.device
        _close(got, sra_attention_reference(qd, kd, kd, 0.125), torch.float32)
        got = local_correlation(td, sd, 9)
        assert (got - local_correlation_reference(td, sd, 9)
                ).abs().max().item() <= 1e-5
        _close(dwconv3x3_gelu(xd, wd, bd),
               dwconv3x3_gelu_reference(xd, wd, bd), torch.float32)


def test_local_correlation_kernel_refusals(gen):
    t = torch.randn(1, 4, 5, 6, device="cuda")
    with pytest.raises(TypeError):
        local_correlation(t, t.bfloat16(), 9)
    with pytest.raises(ValueError):
        local_correlation(t, t, 11)
    with pytest.raises(ValueError):
        local_correlation_backward(t, t, torch.zeros(1, 4, 5, 80,
                                                     device="cuda"), 9)
    with pytest.raises(TypeError):
        local_correlation_relu_l2norm(t, t, 9, out_dtype=torch.float16)


def _grad_close(got, ref, dtype):
    """A backward kernel's gradient against the fp32 plain one."""
    assert got.dtype == dtype and got.shape == ref.shape
    err = (got.float() - ref).abs()
    lim = 3e-5 * ref.abs().max() + (2.0 ** -8 * ref.abs()
                                    if dtype == torch.bfloat16 else 0.0)
    assert (err <= lim).all(), err.max()


def _ref_grads(fn, inputs, g):
    ref_in = [t.detach().float().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*ref_in), ref_in, g.float())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,M,H", [(1, 1, 1), (63, 17, 2), (64, 64, 1),
                                   (130, 65, 3), (1000, 256, 5),
                                   (4100, 256, 1), (200, 300, 2),
                                   (4100, 300, 2), (1, 300, 1),
                                   (65, 129, 3)])
def test_attention_backward_through_autograd(gen, dtype, N, M, H):
    """q and one kv tensor require grad; the backward kernel fills both
    (dk and dv land in the two halves of the kv gradient)."""
    q = torch.randn(2, N, H, 64, generator=gen, device="cuda").to(dtype)
    kv = torch.randn(2, M, 2, H, 64, generator=gen, device="cuda").to(dtype)
    g = torch.randn(2, N, H, 64, generator=gen, device="cuda").to(dtype)
    q.requires_grad_()
    kv.requires_grad_()
    fwd, bwd = sra_attention.launches, sra_attention_backward.launches
    out = sra_attention(q, kv[:, :, 0], kv[:, :, 1], 0.125)
    out.backward(g)
    assert sra_attention.launches == fwd + 1
    assert sra_attention_backward.launches == bwd + 1
    want = _ref_grads(lambda a, b, c: sra_attention_reference(a, b, c, 0.125),
                      (q, kv[:, :, 0], kv[:, :, 1]), g)
    _grad_close(q.grad, want[0], dtype)
    _grad_close(kv.grad[:, :, 0], want[1], dtype)
    _grad_close(kv.grad[:, :, 1], want[2], dtype)


@pytest.mark.parametrize("layout", ["misaligned", "head_strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_strided_inputs(gen, dtype, layout):
    """q and dO off a 16-byte boundary (copied by the wrapper) or strided
    over heads (read in place), k and v from separate tensors, called
    directly."""
    if layout == "misaligned":
        base = torch.randn(1, 77, 2, 65, generator=gen, device="cuda")
        q = base.to(dtype)[..., 1:]
        gb = torch.randn(1, 77, 2, 66, generator=gen, device="cuda")
        g = gb.to(dtype)[..., 2:]
    else:
        base = torch.randn(1, 77, 2, 3, 64, generator=gen, device="cuda")
        q = base.to(dtype)[:, :, :, 1]
        g = torch.randn(1, 77, 2, 2, 64, generator=gen, device="cuda"
                        ).to(dtype)[:, :, :, 0]
    k = torch.randn(1, 9, 2, 64, generator=gen, device="cuda").to(dtype)
    v = torch.randn(1, 9, 2, 64, generator=gen, device="cuda").to(dtype)
    _, stats = sra_attention_forward(q, k, v, 0.2, stats=True)
    got = sra_attention_backward(q, k, v, g, 0.2, stats)
    want = _ref_grads(lambda a, b, c: sra_attention_reference(a, b, c, 0.2),
                      (q, k, v), g)
    for a, b in zip(got, want):
        _grad_close(a, b, dtype)


def test_attention_grad_forward_statistics(gen):
    """K1's grad-mode forward on bf16: the output is its fp32 output
    rounded once, and its base-2 log-sum-exp times ln 2 is torch.logsumexp
    of the fp32 scaled logits within 1e-5 relative (1e-5 absolute below
    1)."""
    q = torch.randn(2, 300, 3, 64, generator=gen, device="cuda").bfloat16()
    kv = torch.randn(2, 289, 2, 3, 64, generator=gen, device="cuda"
                     ).bfloat16()
    k, v = kv[:, :, 0], kv[:, :, 1]
    o, (o32, lse) = sra_attention_forward(q, k, v, 0.125, stats=True)
    assert o32.dtype == lse.dtype == torch.float32
    assert lse.shape == (2, 3, 300)
    assert torch.equal(o, o32.bfloat16())
    want = torch.logsumexp(
        torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * 0.125, -1)
    err = (lse * math.log(2.0) - want).abs()
    assert (err <= 1e-5 * want.abs().clamp(min=1.0)).all(), err.max()
    # fp32 inputs: the backward recomputes the statistics, none are written
    assert sra_attention_forward(q.float(), k.float(), v.float(), 0.125,
                                 stats=True)[1] == ()


def test_attention_inference_forward_takes_no_statistics(gen):
    """Without grad the forward launches the kernel without statistics: it
    allocates the output alone, and its output has the bits of the
    grad-mode launch."""
    q = torch.randn(2, 1000, 2, 64, generator=gen, device="cuda").bfloat16()
    k = torch.randn(2, 289, 2, 64, generator=gen, device="cuda").bfloat16()
    o_grad, stats = sra_attention_forward(q, k, k, 0.125, stats=True)
    snapshot = [t.clone() for t in stats]
    q.requires_grad_()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        o = sra_attention(q, k, k, 0.125)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before == o.nbytes
    assert torch.equal(o, o_grad)
    assert all(torch.equal(a, b) for a, b in zip(stats, snapshot))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernels_are_deterministic(gen, dtype):
    """Two calls on the same inputs give the same bits (no atomics)."""
    q = torch.randn(2, 4100, 2, 64, generator=gen, device="cuda").to(dtype)
    kv = torch.randn(2, 300, 2, 2, 64, generator=gen, device="cuda"
                     ).to(dtype)
    g = torch.randn(2, 4100, 2, 64, generator=gen, device="cuda").to(dtype)
    k, v = kv[:, :, 0], kv[:, :, 1]
    _, stats = sra_attention_forward(q, k, v, 0.125, stats=True)
    first = sra_attention_backward(q, k, v, g, 0.125, stats)
    second = sra_attention_backward(q, k, v, g, 0.125, stats)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    x = torch.randn(2, 40, 43, 264, generator=gen, device="cuda").to(dtype)
    w = (0.3 * torch.randn(264, 1, 3, 3, generator=gen, device="cuda")
         ).to(dtype)
    bias = (0.1 * torch.randn(264, generator=gen, device="cuda")).to(dtype)
    gx = torch.randn(2, 40, 43, 264, generator=gen, device="cuda").to(dtype)
    first = dwconv3x3_gelu_backward(x, w, bias, gx)
    second = dwconv3x3_gelu_backward(x, w, bias, gx)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_attention_without_grad_launches_no_backward(gen):
    q = torch.randn(1, 70, 1, 64, generator=gen, device="cuda",
                    requires_grad=True)
    k = torch.randn(1, 17, 1, 64, generator=gen, device="cuda")
    bwd = sra_attention_backward.launches
    with torch.no_grad():
        out = sra_attention(q, k, k, 0.125)
    assert not out.requires_grad
    assert sra_attention_backward.launches == bwd


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["oihw", "hwio"])
@pytest.mark.parametrize("B,S,C", [(1, 1, 8), (2, 7, 13), (2, 33, 40),
                                   (2, 17, 264), (3, 128, 32), (2, 40, 48),
                                   (1, 5, 72)])
def test_dwconv_backward_through_autograd(gen, dtype, layout, B, S, C):
    """x, the weight (in either layout, its gradient in the same) and the
    bias require grad; the backward kernels fill all three."""
    x = torch.randn(B, S, S + 3, C, generator=gen, device="cuda").to(dtype)
    w = (0.3 * torch.randn(C, 1, 3, 3, generator=gen, device="cuda")
         ).to(dtype)
    if layout == "hwio":
        w = w.permute(2, 3, 1, 0)
    b = (0.1 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
    g = torch.randn(B, S, S + 3, C, generator=gen, device="cuda").to(dtype)
    want = _ref_grads(dwconv3x3_gelu_reference, (x, w, b), g)
    for t in (x, w, b):
        t.requires_grad_()
    fwd, bwd = dwconv3x3_gelu.launches, dwconv3x3_gelu_backward.launches
    dwconv3x3_gelu(x, w, b).backward(g)
    assert dwconv3x3_gelu.launches == fwd + 1
    assert dwconv3x3_gelu_backward.launches == bwd + 1
    assert w.grad.shape == w.shape and w.grad.stride() == w.stride()
    for t, r in zip((x, w, b), want):
        _grad_close(t.grad, r, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dwconv_backward_misaligned_inputs(gen, dtype):
    """x and g off a 16-byte boundary (contiguous views at an odd element
    offset) take the three-kernel body."""
    n = 2 * 9 * 11 * 40
    x = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)[1:] \
        .view(2, 9, 11, 40)
    g = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)[1:] \
        .view(2, 9, 11, 40)
    w = (0.3 * torch.randn(3, 3, 1, 40, generator=gen, device="cuda")
         ).to(dtype)
    b = (0.1 * torch.randn(40, generator=gen, device="cuda")).to(dtype)
    got = dwconv3x3_gelu_backward(x, w, b, g)
    want = _ref_grads(dwconv3x3_gelu_reference, (x, w, b), g)
    for t, r in zip(got, want):
        _grad_close(t, r, dtype)


def test_dwconv_backward_keeps_gprime_on_chip(gen):
    """K2's bf16 backward at the 32^2 x 1280 train-step shape allocates dx,
    dw, db and its partials, and no fp32 g' map (42 MB here)."""
    x = torch.randn(8, 32, 32, 1280, generator=gen, device="cuda").bfloat16()
    w = (0.3 * torch.randn(1280, 1, 3, 3, generator=gen, device="cuda")
         ).bfloat16()
    b = (0.1 * torch.randn(1280, generator=gen, device="cuda")).bfloat16()
    g = torch.randn(8, 32, 32, 1280, generator=gen, device="cuda").bfloat16()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dwconv3x3_gelu_backward(x, w, b, g)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < x.numel() * 4


def _corr_grad_inputs(gen, B, H, W, C, dtype):
    """Unit-norm target and source as the head passes them (the source a
    strided view), with a target pixel of zeros and a source block of
    zeros wide enough that some pixels' whole 9x9 window left the image:
    the exact zeros where the ReLU's gradient is 0.5 and the clamp's
    where the sum of squares is 0."""
    t = _unit_features(gen, B, H, W, C, torch.float32)
    s = torch.randn(B, C, H, W, generator=gen, device="cuda")
    s = (s / s.norm(dim=1, keepdim=True)).permute(0, 2, 3, 1)
    t[0, H // 2, W // 3] = 0
    s[:, :min(H, 12), :min(W, 14)] = 0
    return t.to(dtype), s.to(dtype)


def _corr_grad_scale(t, s, g, P, fused):
    """Per gradient element, two bounds from the plain version, as (gt's,
    gs's) pairs: the sum of the magnitudes of the fp32 terms it sums (the
    volume's gradient bounded without cancellation), the scale of its
    summation error, which clamped pixels (graw ~1e12) leave far above an
    element where their terms cancel; and, in the fused mode, the sum over
    the taps whose raw sum lies within fp32 summation noise of 0 (1e-5 of
    the sum of |t||s|, that sum not 0; a plain sum that rounding puts on 0
    exactly included) of their whole term: the ReLU's slope there may
    differ between the kernel's sums and the plain version's."""
    g = g.float()
    gmag, jump = g.abs(), torch.zeros_like(g)
    if fused:
        raw = local_correlation_reference(t.float(), s.float(), P)
        absraw = local_correlation_reference(t.float().abs(),
                                             s.float().abs(), P)
        r = raw.clamp_min(0)
        den = r.square().sum(-1, keepdim=True).clamp_min(1e-24).sqrt()
        n = r / den
        slope = torch.where(raw > 0, 1.0, torch.where(raw == 0, 0.5, 0.0))
        whole = (g.abs() + n * (g * n).sum(-1, keepdim=True).abs()) / den
        gmag = slope * whole
        # a raw sum that fp32 rounding puts exactly on 0 is near the kink
        # too (the exact sum is not 0 where some product is not): only
        # where every product is 0 is the zero exact, both sides slope 0.5
        jump = torch.where((absraw > 0) & (raw.abs() <= 1e-5 * absraw),
                           whole, 0.0)
    ta = t.detach().float().abs().requires_grad_()
    sa = s.detach().float().abs().requires_grad_()
    out = local_correlation_reference(ta, sa, P)
    return (torch.autograd.grad(out, (ta, sa), gmag, retain_graph=True),
            torch.autograd.grad(out, (ta, sa), jump))


def _corr_grad_close(got, ref, scale, jump, dtype):
    """|got - ref| <= 3e-5 * scale + jump (+ 2^-8 (|ref| + jump) in bf16:
    a kernel that takes the other ReLU slope at a tap within fp32 noise of
    the kink rounds a value near |ref| + jump), finite; every element
    within the limit only by the bf16 allowance on jump has jump > 0."""
    assert got.dtype == dtype and got.shape == ref.shape
    assert torch.isfinite(got).all()
    err = (got.float() - ref).abs()
    lim = 3e-5 * scale + jump
    old = lim
    if dtype == torch.bfloat16:
        old = lim + 2.0 ** -8 * ref.abs()
        lim = old + 2.0 ** -8 * jump
    assert (err <= lim).all(), (err - lim).max()
    assert (jump[(err > old) & (err <= lim)] > 0).all()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W,C,P", [(1, 1, 1, 8, 3), (2, 13, 21, 40, 5),
                                       (2, 33, 70, 40, 9),
                                       (1, 32, 32, 256, 9),
                                       (1, 65, 65, 256, 9),
                                       (1, 130, 130, 128, 9)])
def test_local_correlation_backward_through_autograd(gen, fused, dtype, B, H,
                                                     W, C, P):
    """Both inputs require grad; one forward and one backward launch; the
    gradients against autograd of the fp32 plain version (finite where the
    clamp makes graw ~1e12)."""
    t, s = _corr_grad_inputs(gen, B, H, W, C, dtype)
    t.requires_grad_()
    s.requires_grad_()
    out_dtype = dtype if fused else torch.float32
    g = torch.randn(B, H, W, P * P, generator=gen, device="cuda").to(out_dtype)
    fwd, bwd = local_correlation.launches, local_correlation_backward.launches
    out = (local_correlation_relu_l2norm(t, s, P, out_dtype) if fused
           else local_correlation(t, s, P))
    out.backward(g)
    assert local_correlation.launches == fwd + 1
    assert local_correlation_backward.launches == bwd + 1
    plain = (local_correlation_relu_l2norm_reference if fused
             else local_correlation_reference)
    want = _ref_grads(lambda a, b: plain(a, b, P), (t, s), g)
    scales, jumps = _corr_grad_scale(t, s, g, P, fused)
    for got, ref, scale, jump in zip((t.grad, s.grad), want, scales, jumps):
        _corr_grad_close(got, ref, scale, jump, dtype)


def test_local_correlation_backward_forms_only_needed_grads(gen):
    """A frozen target: the backward forms the source gradient alone."""
    t, s = _corr_grad_inputs(gen, 2, 20, 24, 32, torch.bfloat16)
    s.requires_grad_()
    g = torch.randn(2, 20, 24, 81, generator=gen, device="cuda").bfloat16()
    out = local_correlation_relu_l2norm(t, s, 9, torch.bfloat16)
    (gs,) = torch.autograd.grad(out, s, g)
    want = _ref_grads(lambda a, b: local_correlation_relu_l2norm_reference(
        a, b, 9), (t, s), g)[1]
    scales, jumps = _corr_grad_scale(t, s, g, 9, True)
    _corr_grad_close(gs, want, scales[1], jumps[1], torch.bfloat16)
    none_t, only_s = local_correlation_backward(t, s, g, 9, True,
                                                need_t=False)
    assert none_t is None and torch.equal(only_s, gs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_local_correlation_backward_is_deterministic(gen, dtype):
    t, s = _corr_grad_inputs(gen, 2, 65, 65, 256, dtype)
    g = torch.randn(2, 65, 65, 81, generator=gen, device="cuda").to(dtype)
    for fused in (False, True):
        gg = g if fused else g.float()
        first = local_correlation_backward(t, s, gg, 9, fused)
        second = local_correlation_backward(t, s, gg, 9, fused)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def _corr_source_layout(s, layout):
    """The source as the head passes it (``nchw``: the NHWC view of an NCHW
    map), NHWC contiguous, or the NHWC view of an NCHW map whose rows start
    one element past a word (``offset``: a column sliced off)."""
    if layout == "nhwc":
        return s.contiguous()
    if layout == "offset":
        B, H, W, C = s.shape
        wide = torch.zeros(B, C, H, W + 1, device=s.device, dtype=s.dtype)
        wide[..., 1:] = s.permute(0, 3, 1, 2)
        return wide[..., 1:].permute(0, 2, 3, 1)
    return s


@pytest.mark.parametrize("layout", ["nchw", "nhwc", "offset"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("B,H,W,C,P", [(1, 65, 65, 64, 9),
                                       (1, 130, 130, 32, 9),
                                       (2, 17, 45, 40, 9), (1, 20, 30, 13, 5)])
def test_local_correlation_backward_bf16_body(gen, layout, fused, B, H, W, C,
                                              P):
    """The bf16 body at the stage-1 widths (W = 130: 4-byte source words;
    W = 65: landed rows of every phase) and ragged shapes, each source
    layout, g a slice of a wider tensor (the gradient of the decoder's
    concatenation): gs alone equals gs of both, both hold the limit, and a
    repeat gives the same bits."""
    t, s = _corr_grad_inputs(gen, B, H, W, C, torch.bfloat16)
    s = _corr_source_layout(s, layout)
    PP = P * P
    wide = torch.randn(B, H, W, PP + 19, generator=gen, device="cuda").to(
        torch.bfloat16 if fused else torch.float32)
    g = wide[..., 7:7 + PP]
    both = local_correlation_backward(t, s, g, P, fused)
    none_t, gs = local_correlation_backward(t, s, g, P, fused, need_t=False)
    assert none_t is None and torch.equal(gs, both[1])
    again = local_correlation_backward(t, s, g, P, fused)
    assert all(torch.equal(a, b) for a, b in zip(both, again))
    plain = (local_correlation_relu_l2norm_reference if fused
             else local_correlation_reference)
    want = _ref_grads(lambda a, b: plain(a, b, P), (t, s), g)
    scales, jumps = _corr_grad_scale(t, s, g, P, fused)
    for got, ref, scale, jump in zip(both, want, scales, jumps):
        _corr_grad_close(got, ref, scale, jump, torch.bfloat16)


def test_deeplabv2_bf16_forward_matches_fp32(gen):
    """DeepLabV2 inference (no hand-written kernel on its path): the bf16
    network against the fp32 one on the same seeded weights (BatchNorm
    scales and biases drawn, statistics calibrated), within
    ``chip_smoke.py``'s limits; no kernel launches."""
    import chip_smoke
    from refign_tpu_torch.entry import build_deeplabv2, deeplabv2_forward
    models = [build_deeplabv2("resnet50_v1c", dtype=dt, device="cuda",
                              seed=0)
              for dt in (torch.bfloat16, torch.float32)]
    chip_smoke.randomize_bn(models[1], 1)
    chip_smoke.calibrate_bn(models[1], torch.randn(
        2, 128, 128, 3, generator=gen, device="cuda"))
    models[0].load_state_dict(models[1].state_dict())
    x = torch.randn(1, 129, 193, 3, generator=gen, device="cuda")
    counters = (sra_attention, dwconv3x3_gelu, local_correlation)
    for f in counters:
        f.launches = 0
    got = deeplabv2_forward(models[0], x.bfloat16())
    ref = deeplabv2_forward(models[1], x)
    assert all(f.launches == 0 for f in counters)
    assert got.shape == (1, 129, 193, 19) and got.dtype == torch.bfloat16
    diff = (got.float() - ref).abs()
    assert diff.max() <= chip_smoke.DL_BF16_MAX_REL * ref.abs().max()
    assert diff.mean() <= chip_smoke.DL_BF16_MEAN_REL * ref.abs().mean()
    agree = (got.float().argmax(-1) == ref.argmax(-1)).float().mean()
    assert agree >= chip_smoke.DL_ARGMAX_AGREE


def test_deeplabv2_uda_step_launches_k3_three_times(gen):
    """One Refign-branch step of the DeepLabV2 trainer (resnet18_v1c,
    B=2 256^2, bf16): K3 launches once per UAWarpC level and no other
    kernel runs (the alignment network is frozen: no K3 backward)."""
    import chip_smoke
    from refign_tpu_torch.entry import DEEPLABV2, build_uda_trainer
    from refign_tpu_torch.uda.trainer import draw_step, train_step
    trainer = build_uda_trainer("resnet18_v1c", device="cuda", seed=0,
                                config=DEEPLABV2)
    batch = chip_smoke.uda_batch(2, 256, 0, "cuda")
    draws = draw_step(trainer.cfg, batch, torch.Generator().manual_seed(0))
    draws.use_ref_as_target = False
    counters = (sra_attention, sra_attention_backward, dwconv3x3_gelu,
                dwconv3x3_gelu_backward, local_correlation,
                local_correlation_backward)
    for f in counters:
        f.launches = 0
    logs = train_step(trainer, batch, draws)
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == [0, 0, 0, 0, 3, 0]
    assert all(torch.isfinite(v) for v in logs.values())


# --------------------------------------------------------------------- K4

def _k4_inputs(gen, B, H, W, C, dtype):
    x = torch.randn(B, H, W, C, generator=gen, device="cuda").to(dtype)
    w = (0.3 * torch.randn(C, 1, 3, 3, generator=gen, device="cuda")
         ).to(dtype)
    return x, w


def _k4_bn(gen, C):
    """An eval TorchBatchNorm on the card with drawn parameters and
    statistics (bf16 parameters, fp32 statistics, as the HRDA* model)."""
    from refign_tpu_torch.nn.layers import TorchBatchNorm
    bn = TorchBatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn(C, generator=gen,
                                              device="cuda"))
        bn.bias.copy_(0.2 * torch.randn(C, generator=gen, device="cuda"))
        bn.running_mean.copy_(0.3 * torch.randn(C, generator=gen,
                                                device="cuda"))
        bn.running_var.copy_(0.5 + torch.rand(C, generator=gen,
                                              device="cuda"))
    bn = bn.cuda().eval().requires_grad_(False)
    bn.weight.data = bn.weight.data.bfloat16()
    bn.bias.data = bn.bias.data.bfloat16()
    return bn


@pytest.mark.parametrize("d", [6, 12, 18])
@pytest.mark.parametrize("B,H,W", [(30, 135, 135), (4, 128, 128)])
def test_dilated_dwconv_kernel_main_path(gen, B, H, W, d):
    """The slide frame's and the UDA head's ASPP convs (1024 channels):
    one launch, within one bf16 rounding of cuDNN's fp32 conv (TF32 off),
    and of the plain version (cuDNN fp32, cast to bf16) within two."""
    x, w = _k4_inputs(gen, B, H, W, 1024, torch.bfloat16)
    before = dilated_dwconv3x3.launches
    got = dilated_dwconv3x3(x, w, d)
    assert dilated_dwconv3x3.launches == before + 1
    ref = dilated_dwconv3x3_reference(x.float(), w.float(), d)
    _close(got, ref, torch.bfloat16)
    plain = dilated_dwconv3x3_reference(x, w, d)
    err = (got.float() - plain.float()).abs()
    assert (err <= 2.0 ** -7 * ref.abs() + 1e-4).all(), err.max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W,C,d", [
    (1, 1, 1, 8, 6), (2, 17, 17, 64, 1), (2, 34, 21, 40, 6),
    (2, 40, 40, 72, 12), (1, 7, 30, 13, 18), (2, 33, 65, 64, 25),
    (1, 135, 135, 128, 18), (1, 9, 300, 16, 2)])
def test_dilated_dwconv_kernel_matches_plain(gen, dtype, B, H, W, C, d):
    """Ragged class grids, channel counts ragged around the 64-channel
    slice, C not a multiple of 8 (the direct loop), d beyond the map."""
    x, w = _k4_inputs(gen, B, H, W, C, dtype)
    got = dilated_dwconv3x3(x, w, d)
    _close(got, dilated_dwconv3x3_reference(x.float(), w.float(), d), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dilated_dwconv_kernel_misaligned_and_strided_weight(gen, dtype):
    """x one element past a 16-byte boundary (the direct loop) and a
    weight read through its strides (a transposed copy's view)."""
    B, H, W, C = 2, 30, 31, 64
    buf = torch.randn(B * H * W * C + 1, generator=gen,
                      device="cuda").to(dtype)
    x = buf[1:].view(B, H, W, C)
    w = (0.3 * torch.randn(3, 3, 1, C, generator=gen, device="cuda")
         ).to(dtype).permute(3, 2, 0, 1)
    assert not w.is_contiguous()
    got = dilated_dwconv3x3(x, w, 6)
    _close(got, dilated_dwconv3x3_reference(x.float(), w.float(), 6), dtype)
    assert torch.equal(got, dilated_dwconv3x3(x.clone(), w.contiguous(), 6))


@pytest.mark.parametrize("B,H,W,C,d", [(30, 135, 135, 1024, 12),
                                       (2, 34, 21, 40, 6), (1, 7, 30, 13, 1)])
def test_dilated_dwconv_fused_is_conv_bn_relu(gen, B, H, W, C, d):
    """Mode (b) equals mode (a) + TorchBatchNorm (eval, bf16) + F.relu
    bit for bit: the tile (the first two shapes) and the direct loop."""
    dtype = torch.bfloat16
    x, w = _k4_inputs(gen, B, H, W, C, dtype)
    bn = _k4_bn(gen, C)
    a, c = bn.eval_fold()
    before = (dilated_dwconv3x3.launches, dilated_dwconv3x3.fused)
    got = dilated_dwconv3x3(x, w, d, (a, c))
    assert (dilated_dwconv3x3.launches, dilated_dwconv3x3.fused) == (
        before[0] + 1, before[1] + 1)
    want = F.relu(bn(dilated_dwconv3x3(x, w, d)))
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_dilated_dwconv_launches_once_without_copies(gen, fused):
    """One call is one launch of K4 and nothing else on the card, under a
    name no benchmark kernel pattern matches."""
    x, w = _k4_inputs(gen, 4, 64, 64, 256, torch.bfloat16)
    affine = _k4_bn(gen, 256).eval_fold() if fused else None
    dilated_dwconv3x3(x, w, 6, affine)  # build and load outside the window
    torch.cuda.synchronize()
    names = _device_kernels(lambda: dilated_dwconv3x3(x, w, 6, affine))
    assert len(names) == 1 and "dilated_dwconv_fwd_kernel" in names[0], names
    for pattern in ("dwconv3x3_gelu_kernel", "dwconv_bwd_", "::grad_kernel<",
                    "::graw_kernel<", "::raw_grad_kernel<",
                    "::input_grad_kernel<", "sra_attention_kernel",
                    "attn_bwd_", "local_correlation"):
        assert pattern not in names[0]


def test_dilated_dwconv_backward_is_conv2d_backward(gen):
    """Inputs that require grad: K4 forward, aten's convolution_backward,
    the gradients of F.conv2d's autograd for the same output gradient."""
    x, w = _k4_inputs(gen, 4, 64, 64, 256, torch.bfloat16)
    x.requires_grad_()
    w.requires_grad_()
    g = torch.randn(4, 64, 64, 256, generator=gen, device="cuda").bfloat16()
    before = dilated_dwconv3x3.launches
    y = dilated_dwconv3x3(x, w, 12)
    assert dilated_dwconv3x3.launches == before + 1
    dx, dw = torch.autograd.grad(y, (x, w), g)
    yr = F.conv2d(x.permute(0, 3, 1, 2), w, None, 1, 12, 12, 256)
    rx, rw = torch.autograd.grad(yr.permute(0, 2, 3, 1), (x, w), g)
    assert dx.dtype == x.dtype and dx.shape == x.shape
    assert dw.dtype == w.dtype and dw.shape == w.shape
    for got, ref in ((dx, rx), (dw, rw)):
        err = (got.float() - ref.float()).abs()
        assert (err <= 2.0 ** -7 * ref.float().abs() + 1e-3).all(), err.max()


def test_dilated_dwconv_refusals(gen):
    x, w = _k4_inputs(gen, 1, 8, 9, 16, torch.float16)
    with pytest.raises(TypeError):
        dilated_dwconv3x3(x, w, 2)  # fp16
    x, w = _k4_inputs(gen, 1, 8, 9, 16, torch.bfloat16)
    with pytest.raises(ValueError):  # not NHWC-contiguous
        dilated_dwconv3x3(x.permute(0, 2, 1, 3), w, 2)
    with pytest.raises(ValueError):  # the grad path takes the same checks
        dilated_dwconv3x3(x[:, :, ::2].requires_grad_(), w, 2)
    with pytest.raises(TypeError):
        dilated_dwconv3x3(x, w.float(), 2)
    a = torch.ones(16, device="cuda")
    with pytest.raises(ValueError):  # the epilogue takes bf16 alone
        dilated_dwconv3x3(x.float(), w.float(), 2, (a, a))


def test_dilated_dwconv_counts_slide_frame_and_uda_head(gen):
    """One 1080x1920 HRDA* slide frame (eval BatchNorm, bf16, inference):
    3 launches, all fused.  One UDA head forward (train-mode BatchNorm,
    bf16 parameters that require grad): 3 launches, none fused, and its
    backward runs."""
    from refign_tpu_torch.entry import build_hrda_star, hrda_slide_forward
    from refign_tpu_torch.models.heads.daformer import DAFormerHead
    from refign_tpu_torch.parallel.mesh import cast_floating
    model = build_hrda_star("mit_b1", device="cuda")  # K1: head dim 64
    img = torch.rand(1, 1080, 1920, 3, generator=gen,
                     device="cuda").bfloat16()
    hrda_slide_forward(model, img)  # build outside the count
    before = (dilated_dwconv3x3.launches, dilated_dwconv3x3.fused)
    out = hrda_slide_forward(model, img)
    assert torch.isfinite(out).all()
    assert (dilated_dwconv3x3.launches - before[0],
            dilated_dwconv3x3.fused - before[1]) == (3, 3)

    dims = (64, 128, 320, 512)
    head = DAFormerHead(19, in_channels=dims, channels=256, embed_dims=256)
    head.init_weights(torch.Generator().manual_seed(0))
    head = cast_floating(head.cuda().train(), torch.bfloat16)
    feats = [torch.randn(8, 128 // s, 128 // s, c, generator=gen,
                         device="cuda").bfloat16().requires_grad_()
             for s, c in zip((1, 2, 4, 8), dims)]
    before = (dilated_dwconv3x3.launches, dilated_dwconv3x3.fused)
    seg = head(feats, gen)  # train-mode dropout draws from the generator
    assert (dilated_dwconv3x3.launches - before[0],
            dilated_dwconv3x3.fused - before[1]) == (3, 0)
    seg.float().square().mean().backward()
    assert all(torch.isfinite(f.grad).all() for f in feats)
