"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA device.  On a machine
with one (the H100):

    python -m pytest tests/test_torch_cuda.py -q

Covers what ``chip_smoke.py``'s main-path shapes do not: ragged N and M
around the 64-wide tiles, M = 1, head-strided and misaligned inputs, the
scalar K2 path (C not a multiple of 8), the launch counters and the
wrappers' refusals.  Tolerances: a bf16 kernel output within
2^-8*|ref| + 1e-4 of the fp32 plain version on the same inputs (one bf16
rounding plus summation order); fp32 within 1e-5.
"""
import pytest
import torch

from refign_tpu_torch import full_fp32_precision
from refign_tpu_torch.ops.attention import (sra_attention,
                                            sra_attention_reference)
from refign_tpu_torch.ops.dwconv import (dwconv3x3_gelu,
                                         dwconv3x3_gelu_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: python -m pytest "
                    "tests/test_torch_cuda.py)")
    full_fp32_precision()
    return torch.Generator(device="cuda").manual_seed(0)


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


def test_attention_kernel_misaligned_inputs(gen):
    base = torch.randn(1, 77, 2, 65, generator=gen, device="cuda")
    q = base[..., 1:]  # head-dim stride 1, start off a 16-byte boundary
    k = torch.randn(1, 9, 2, 64, generator=gen, device="cuda")
    v = torch.randn(1, 9, 2, 64, generator=gen, device="cuda")
    _close(sra_attention(q, k, v, 0.2), sra_attention_reference(q, k, v, 0.2),
           torch.float32)


def test_attention_kernel_refusals(gen):
    q = torch.randn(1, 8, 1, 64, device="cuda", requires_grad=True)
    k = torch.randn(1, 4, 1, 64, device="cuda")
    with pytest.raises(NotImplementedError):
        sra_attention(q, k, k, 1.0)
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


def test_dwconv_kernel_refusals(gen):
    x = torch.randn(1, 4, 5, 6, device="cuda")
    w = torch.randn(3, 3, 1, 4, device="cuda")
    b = torch.randn(4, device="cuda")
    with pytest.raises(ValueError):
        dwconv3x3_gelu(x.permute(0, 2, 3, 1), w, b)  # not NHWC-contiguous
    with pytest.raises(NotImplementedError):
        dwconv3x3_gelu(x[..., :4].contiguous().requires_grad_(), w, b)
