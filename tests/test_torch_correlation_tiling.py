"""K3's bf16 tensor-core tiling (refign_tpu_torch/csrc/local_correlation.cu,
its banded product in csrc/local_correlation_tile.cuh) emulated in PyTorch
on the CPU, and the fused ReLU + L2 mode's plain version, against the JAX
package.

The emulation repeats the kernel's arithmetic with the tile constants read
from the source: per pair of target rows (y, y+1) and 8-pixel segment, the
16 x 16 product of the segment's two rows with each of the P + 1 source
rows they see, over the 16-column window from x - 4, over channels
zero-padded to the 32-channel chunk, summed in fp32 one 16-channel k-step
at a time from bf16 operands; then the band (row y takes source row k as
dy index k, row y+1 as k - 1; pixel g, window column n is dx = n - g - 4).
It is held at 1e-5 against the Pallas kernel in interpret mode and against
the plain version, for every odd P up to 9, with ragged H (odd), W (not a
multiple of 16) and C (13, 40).  The kernel itself is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.ops import correlation as jc
from refign_tpu_torch.ops import correlation as tc

TOL = dict(rtol=0, atol=1e-5)
CU = os.path.join(os.path.dirname(tc.__file__), os.pardir, "csrc",
                  "local_correlation_tile.cuh")


def _tc_constants():
    """SEG, HALO, WIN and KC of the kernel's tensor-core body."""
    with open(CU) as f:
        src = f.read()
    body = src[src.index("namespace lcorr {"):src.index("}  // namespace lcorr")]
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", body))
    seg, halo, kc = int(consts["SEG"]), int(consts["HALO"]), int(consts["KC"])
    assert consts["WIN"].replace(" ", "") == "SEG+2*HALO"
    return seg, halo, seg + 2 * halo, kc


def emulate_tc_kernel(t: torch.Tensor, s: torch.Tensor, P: int) -> torch.Tensor:
    """The bf16 body's banded products on (B,H,W,C) inputs holding bf16
    values; (B,H,W,P*P) fp32."""
    SEG, HALO, WIN, KC = _tc_constants()
    B, H, W, C = t.shape
    R = (P - 1) // 2
    Kp = -(-C // KC) * KC
    Hp = H + H % 2
    nseg = -(-W // SEG)
    # zero fill: target pixels past H and W, channels past C; source
    # outside the image (R rows above, the windows' HALO columns)
    tp = torch.zeros(B, Hp, nseg * SEG, Kp)
    tp[:, :H, :W, :C] = t.float()
    sp = torch.zeros(B, Hp + 2 * R, nseg * SEG + 2 * HALO, Kp)
    sp[:, R:R + H, HALO:HALO + W, :C] = s.float()
    # mma rows: 8 pixels of row y over the same pixels of row y + 1
    a = tp.reshape(B, Hp // 2, 2, nseg, SEG, Kp).permute(0, 1, 3, 2, 4, 5) \
        .reshape(B, Hp // 2, nseg, 2 * SEG, Kp)
    g = torch.arange(SEG)[:, None]
    n = g + torch.arange(P)[None, :] + HALO - R  # window column of (g, dx)
    assert n.min() >= 0 and n.max() < WIN
    out = torch.zeros(B, Hp // 2, 2, nseg, SEG, P * P)
    for k in range(P + 1):  # source row y - R + k
        win = sp[:, k:k + Hp:2].unfold(2, WIN, SEG)  # (B, Hp/2, nseg, Kp, WIN)
        prod = torch.zeros(B, Hp // 2, nseg, 2 * SEG, WIN)
        for k0 in range(0, Kp, 16):
            prod += a[..., k0:k0 + 16] @ win[..., k0:k0 + 16, :]
        if k < P:
            out[:, :, 0, :, :, k * P:(k + 1) * P] = prod[..., g, n]
        if k >= 1:
            out[:, :, 1, :, :, (k - 1) * P:k * P] = prod[..., SEG + g, n]
    out = out.reshape(B, Hp, nseg * SEG, P * P)
    return out[:, :H, :W]


def _bf16_pair(B, H, W, C, seed):
    """Unit-norm features rounded to bf16, returned as fp32 numpy arrays
    (the values the kernel's operands hold)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        x = rng.randn(B, H, W, C).astype(np.float32)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        out.append(torch.from_numpy(x).bfloat16().float().numpy())
    return out


@pytest.mark.parametrize("P", [1, 3, 5, 7, 9])
@pytest.mark.parametrize("B,H,W,C", [(1, 5, 33, 13), (2, 7, 20, 40)])
def test_tiling_emulation_matches_pallas_and_plain(B, H, W, C, P):
    t, s = _bf16_pair(B, H, W, C, seed=11 * P + C)
    got = emulate_tc_kernel(torch.from_numpy(t), torch.from_numpy(s), P)
    assert got.shape == (B, H, W, P * P)
    want = np.asarray(jc._local_correlation_pallas(
        jnp.asarray(t), jnp.asarray(s), patch_size=P, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = tc.local_correlation_reference(torch.from_numpy(t),
                                           torch.from_numpy(s), P)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_tiling_emulation_main_path_width():
    """Whole tiles with more than one 32-channel chunk, as at the UAWarpC
    levels (H even, W a multiple of 16, C a multiple of 32)."""
    t, s = _bf16_pair(1, 6, 32, 64, seed=3)
    got = emulate_tc_kernel(torch.from_numpy(t), torch.from_numpy(s), 9)
    plain = tc.local_correlation_reference(torch.from_numpy(t),
                                           torch.from_numpy(s), 9)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def _pair(B, H, W, C, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, W, C).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("P", [9, 5])
@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16])
def test_fused_plain_version_matches_jax(P, out_dtype):
    t, s = _pair(2, 8, 10, 24, seed=P + 1)
    want = jc.local_correlation_relu_l2norm(jnp.asarray(t), jnp.asarray(s), P)
    got = tc.local_correlation_relu_l2norm(torch.from_numpy(t),
                                           torch.from_numpy(s), P,
                                           out_dtype=out_dtype)
    if out_dtype == torch.bfloat16:
        assert got.dtype == torch.bfloat16
        ref = np.asarray(want.astype(jnp.bfloat16)).astype(np.float32)
        err = np.abs(got.float().numpy() - ref)
        assert (err <= 2.0 ** -8 * np.abs(ref) + 1e-5).all(), err.max()
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_cpu_wrapper_is_its_plain_version():
    t, s = map(torch.from_numpy, _pair(1, 5, 7, 8, seed=2))
    before = tc.local_correlation.launches
    for dt in (torch.float32, torch.bfloat16):
        got = tc.local_correlation_relu_l2norm(t.bfloat16(), s.bfloat16(), 5,
                                               out_dtype=dt)
        want = tc.relu_l2norm(tc.local_correlation_reference(
            t.bfloat16(), s.bfloat16(), 5)).to(dt)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(
            tc.local_correlation_relu_l2norm_reference(
                t.bfloat16(), s.bfloat16(), 5, dt), want, rtol=0, atol=0)
    assert tc.local_correlation.launches == before


def test_fused_refusals():
    t, s = map(torch.from_numpy, _pair(1, 4, 5, 6, seed=4))
    with pytest.raises(TypeError, match="out_dtype"):
        tc.local_correlation_relu_l2norm(t, s, 9, out_dtype=torch.float16)
    meta = torch.empty((1, 4, 5, 6), device="meta")
    with pytest.raises(TypeError, match="out_dtype"):
        tc.local_correlation_relu_l2norm(meta, meta, 9,
                                         out_dtype=torch.float16)
    with pytest.raises(TypeError, match="share a dtype"):
        tc.local_correlation_relu_l2norm(meta.bfloat16(), meta, 9,
                                         out_dtype=torch.bfloat16)
