"""K4, the dilated depthwise 3x3 conv with an eval BatchNorm + ReLU
epilogue (refign_tpu_torch/csrc/dilated_dwconv.cu), on the CPU.

* The wrapper's plain version against ``F.conv2d`` (fp32, groups = C).
* The kernel's bf16 sub-lattice halo tile emulated in numpy, with the tile
  constants and the tile-size rule read from the source: the d * d residue
  classes, near-equal tiles of the largest class grid, the (TH+2) x (TW+2)
  halo staged with zero fill outside the image, each output's taps in the
  order i outer, j inner, as fp32 adds of exact bf16 products (what fmaf
  gives on bf16 inputs).  It equals the direct loop, which skips the taps
  outside the image, bit for bit; the slide and UDA shapes tile fully
  within the launch limits.
* The fused epilogue's plain path against the conv alone + TorchBatchNorm
  (eval) + F.relu, bit for bit.
* ``ConvBNReLU``'s route: the ASPP gives the parent's composite output and,
  through the autograd path, ``F.conv2d``'s gradients; which calls fuse.

The kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py).
"""
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from refign_tpu_torch.models.heads.daformer import DepthwiseSeparableASPP
from refign_tpu_torch.nn import layers
from refign_tpu_torch.nn.layers import ConvBNReLU, TorchBatchNorm
from refign_tpu_torch.ops import dilated_dwconv as k4
from refign_tpu_torch.ops.dilated_dwconv import dilated_dwconv3x3

CSRC = os.path.join(os.path.dirname(k4.__file__), os.pardir, "csrc")
CU = os.path.join(CSRC, "dilated_dwconv.cu")
TILE = os.path.join(CSRC, "dwconv_tile.cuh")  # the tile shared with K2

DILATIONS = [1, 6, 12, 18]
MAPS = [(17, 17), (34, 21), (40, 40)]
# (B, H, W, C, dilations): one 1080x1920 slide frame's 30 rows of 540^2
# crops, and the UDA step's 512^2 HRDA crops, at 1/4 of their size
MAIN_PATH = [(30, 135, 135, 1024, (6, 12, 18)),
             (4, 128, 128, 1024, (6, 12, 18))]


def _bf16_values(g, *shape, scale=1.0):
    """fp32 tensor of bf16-representable values."""
    return (scale * torch.randn(*shape, generator=g)).bfloat16().float()


# ------------------------------------------------------------ plain version


@pytest.mark.parametrize("H,W", MAPS)
@pytest.mark.parametrize("d", DILATIONS)
def test_plain_matches_conv2d(d, H, W):
    g = torch.Generator().manual_seed(d * 100 + H)
    x = torch.randn(2, H, W, 64, generator=g)
    w = 0.3 * torch.randn(64, 1, 3, 3, generator=g)
    got = dilated_dwconv3x3(x, w, d)
    ref = F.conv2d(x.permute(0, 3, 1, 2).contiguous(), w, padding=d,
                   dilation=d, groups=64).permute(0, 2, 3, 1)
    assert got.shape == x.shape and got.dtype == x.dtype
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


# ----------------------------------------------------- the kernel's tiling


def _source(path=CU):
    with open(path) as f:
        return f.read()


def _constants():
    """SLICE, MAX_TH, MAX_TW of the shared tile, PARAM_BYTES of K4's."""
    src = _source(TILE)
    body = src[src.index("namespace dwtile {"):
               src.index("}  // namespace dwtile")]
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", body))
    tw_th = re.search(r"constexpr int MAX_TW = (\d+), MAX_TH = (\d+);", body)
    src = _source()
    body = src[src.index("namespace tile {"):src.index("}  // namespace tile")]
    param = re.search(r"constexpr int PARAM_BYTES = ([^;]+);", body).group(1)
    assert param.replace(" ", "") == "11*SLICE*4"
    slice_ = int(consts["SLICE"])
    return slice_, int(tw_th.group(2)), int(tw_th.group(1)), 11 * slice_ * 4


def tile_size(n: int, max_t: int) -> int:
    """Near-equal tiles of at most max_t (the source's tile_size)."""
    tiles = -(-n // max_t)
    return -(-n // tiles)


def plan(H, W, d):
    """The launcher's tile plan: TH, TW, tiles_h, tiles_w of the largest
    class grid, (0, 0)."""
    _, MAX_TH, MAX_TW, _ = _constants()
    Hc, Wc = -(-H // d), -(-W // d)
    TH = tile_size(Hc, MAX_TH)
    TW = (tile_size(Wc, MAX_TW) + 3) & ~3
    return TH, TW, -(-Hc // TH), -(-Wc // TW)


def test_launcher_rule_is_the_plan():
    """The constants and the launcher's tile arithmetic the emulation
    repeats are the source's."""
    src = _source()
    launcher = src[src.index('extern "C" int dilated_dwconv_forward'):]
    for line in ["const int Hc = (H + d - 1) / d, Wc = (W + d - 1) / d;",
                 "const int TH = tile_size(Hc, tile::MAX_TH), "
                 "TW = (tile_size(Wc, tile::MAX_TW) + 3) & ~3;",
                 "const int tiles_h = (Hc + TH - 1) / TH, "
                 "tiles_w = (Wc + TW - 1) / TW;"]:
        assert line in launcher, line
    assert "const int Hc = (H - ry + d - 1) / d, Wc = (W - rx + d - 1) / d;" \
        in src
    assert _constants()[:3] == (64, 16, 32)


def emulate_tile(x, w, d):
    """The bf16 halo-tile body in numpy: x (B,H,W,C) and w (C,1,3,3) fp32
    of bf16 values; returns the fp32 sums (before the final rounding) and
    how often each output was written."""
    B, H, W, C = x.shape
    TH, TW, tiles_h, tiles_w = plan(H, W, d)
    wk = np.transpose(w[:, 0], (1, 2, 0))  # (3, 3, C)
    out = np.zeros((B, H, W, C), np.float32)
    written = np.zeros((B, H, W), np.int64)
    for img in range(B):
        for cls in range(d * d):
            ry, rx = divmod(cls, d)
            Hc, Wc = -(-(H - ry) // d), -(-(W - rx) // d)
            for t in range(tiles_h * tiles_w):
                ty, tx = divmod(t, tiles_w)
                ky0, kx0 = ty * TH, tx * TW
                if ky0 >= Hc or kx0 >= Wc:
                    continue  # an empty tile of a smaller class
                # stage: halo pixel (r, s) is image pixel
                # (ry + d*(ky0-1+r), rx + d*(kx0-1+s)), zero outside
                gy = ry + d * (ky0 - 1 + np.arange(TH + 2))
                gx = rx + d * (kx0 - 1 + np.arange(TW + 2))
                oky = (gy >= 0) & (gy < H)
                okx = (gx >= 0) & (gx < W)
                halo = np.zeros((TH + 2, TW + 2, C), np.float32)
                halo[np.ix_(oky, okx)] = x[img][np.ix_(gy[oky], gx[okx])]
                acc = np.zeros((TH, TW, C), np.float32)
                for i in range(3):
                    for j in range(3):
                        acc = acc + halo[i:i + TH, j:j + TW] * wk[i, j]
                rows = min(TH, Hc - ky0)
                cols = min(TW, Wc - kx0)
                oy = ry + d * (ky0 + np.arange(rows))
                ox = rx + d * (kx0 + np.arange(cols))
                out[img][np.ix_(oy, ox)] = acc[:rows, :cols]
                written[img][np.ix_(oy, ox)] += 1
    return out, written


def direct_loop(x, w, d):
    """The direct loop: each output's taps in order, i outer, j inner,
    skipping those outside the image."""
    B, H, W, C = x.shape
    wk = np.transpose(w[:, 0], (1, 2, 0))
    acc = np.zeros((B, H, W, C), np.float32)
    py, px = np.arange(H), np.arange(W)
    for i in range(3):
        yy = py + (i - 1) * d
        for j in range(3):
            xx = px + (j - 1) * d
            ok = (((yy >= 0) & (yy < H))[:, None]
                  & ((xx >= 0) & (xx < W))[None, :])
            src = x[:, np.clip(yy, 0, H - 1)][:, :, np.clip(xx, 0, W - 1)]
            acc = np.where(ok[None, :, :, None], acc + src * wk[i, j], acc)
    return acc


@pytest.mark.parametrize("H,W", MAPS + [(7, 30)])
@pytest.mark.parametrize("d", DILATIONS + [2, 25])
def test_tile_emulation_matches_direct_loop(d, H, W):
    g = torch.Generator().manual_seed(7 * d + W)
    x = _bf16_values(g, 2, H, W, 8).numpy()
    w = _bf16_values(g, 8, 1, 3, 3, scale=0.3).numpy()
    got, written = emulate_tile(x, w, d)
    assert (written == 1).all()
    ref = direct_loop(x, w, d)
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    # the direct loop is the conv
    conv = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(w), padding=d, dilation=d, groups=8)
    np.testing.assert_allclose(ref, conv.permute(0, 2, 3, 1).numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,H,W,C,dilations", MAIN_PATH)
def test_main_path_shapes_tile_fully(B, H, W, C, dilations):
    """Every output of the slide and UDA shapes lies in exactly one tile,
    the grid and shared memory fit the launch limits, and the tiled body
    (not the direct loop) takes them."""
    SLICE, MAX_TH, MAX_TW, PARAM_BYTES = _constants()
    for d in dilations:
        TH, TW, tiles_h, tiles_w = plan(H, W, d)
        assert TH <= MAX_TH and TW <= MAX_TW and TW % 4 == 0
        assert d * d * tiles_h * tiles_w <= 65535 and B <= 65535
        assert (H + 2 * d) * W * C < 2 ** 31 and C % 8 == 0
        smem = PARAM_BYTES + (TH + 2) * (TW + 2) * SLICE * 2
        assert smem <= PARAM_BYTES + (MAX_TH + 2) * (MAX_TW + 2) * SLICE * 2
        hits = np.zeros((H, W), np.int64)
        for cls in range(d * d):
            ry, rx = divmod(cls, d)
            Hc, Wc = -(-(H - ry) // d), -(-(W - rx) // d)
            for ty in range(tiles_h):
                for tx in range(tiles_w):
                    ky0, kx0 = ty * TH, tx * TW
                    if ky0 >= Hc or kx0 >= Wc:
                        continue
                    rows, cols = min(TH, Hc - ky0), min(TW, Wc - kx0)
                    hits[np.ix_(ry + d * (ky0 + np.arange(rows)),
                                rx + d * (kx0 + np.arange(cols)))] += 1
        assert (hits == 1).all(), d


# ------------------------------------------------------------- the epilogue


def _bn(C, g, dtype):
    bn = TorchBatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn(C, generator=g))
        bn.bias.copy_(0.2 * torch.randn(C, generator=g))
        bn.running_mean.copy_(0.3 * torch.randn(C, generator=g))
        bn.running_var.copy_(torch.rand(C, generator=g) + 0.5)
    return bn.to(dtype).eval().requires_grad_(False)


@pytest.mark.parametrize("d", DILATIONS)
def test_fused_plain_path_is_conv_bn_relu(d):
    """The fused call equals the conv alone + TorchBatchNorm (eval, bf16)
    + F.relu bit for bit."""
    g = torch.Generator().manual_seed(d)
    C = 32
    dtype = torch.bfloat16
    x = torch.randn(2, 34, 21, C, generator=g).to(dtype)
    w = (0.3 * torch.randn(C, 1, 3, 3, generator=g)).to(dtype)
    bn = _bn(C, g, dtype)
    a, c = bn.eval_fold()
    assert a.dtype == c.dtype == torch.float32
    got = dilated_dwconv3x3(x, w, d, (a, c))
    ref = F.relu(bn(dilated_dwconv3x3(x, w, d)))
    assert got.dtype == dtype
    assert torch.equal(got, ref)
    assert (got >= 0).all() and (got == 0).any() and (got > 0).any()


def test_eval_fold_is_the_bf16_arm():
    """TorchBatchNorm's bf16 eval output is x*a + c with its eval_fold."""
    g = torch.Generator().manual_seed(3)
    bn = _bn(16, g, torch.bfloat16)
    x = torch.randn(2, 5, 6, 16, generator=g).bfloat16()
    a, c = bn.eval_fold()
    assert torch.equal(bn(x), (x.float() * a + c).bfloat16())


# -------------------------------------------------------------- the route


def _aspp(g, dtype=torch.float32):
    m = DepthwiseSeparableASPP(64, 16)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
        for bn in m.modules():
            if isinstance(bn, TorchBatchNorm):
                bn.running_mean.copy_(0.1 * torch.randn(bn.running_mean.shape,
                                                        generator=g))
                bn.running_var.copy_(torch.rand(bn.running_var.shape,
                                                generator=g) + 0.5)
    return m.to(dtype)


def _parent_route(m, on):
    """The parent's composite (TorchConv + BatchNorm + activation) for
    every depthwise ConvBNReLU of ``m`` while ``on``."""
    for cbr in m.modules():
        if isinstance(cbr, ConvBNReLU) and not cbr.depthwise_separable:
            if on:
                cbr._k4, cbr.dilated_dw = cbr.dilated_dw, False
            else:
                cbr.dilated_dw = cbr._k4


def test_aspp_builds_three_k4_layers():
    m = _aspp(torch.Generator().manual_seed(0))
    routed = [cbr.conv.dilation[0] for cbr in m.modules()
              if isinstance(cbr, ConvBNReLU) and not cbr.depthwise_separable
              and cbr.dilated_dw]
    assert routed == [6, 12, 18]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aspp_route_matches_parent_composite(dtype, train):
    g = torch.Generator().manual_seed(11)
    m = _aspp(g, dtype).train(train)
    x = torch.randn(2, 40, 40, 64, generator=g).to(dtype)
    with torch.no_grad():
        got = m(x)
        _parent_route(m, True)
        ref = m(x)
        _parent_route(m, False)
    if dtype == torch.float32:
        assert torch.equal(got, ref)
    else:  # CPU bf16 conv vs the plain version's fp32 conv: one rounding
        torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -7,
                                   atol=1e-2)


@pytest.mark.parametrize("train", [False, True])
def test_aspp_route_gradients_match_conv2d(train):
    """fp32 with grad: K4's autograd path (the plain forward, aten's
    convolution_backward) gives F.conv2d's output and gradients."""
    g = torch.Generator().manual_seed(5)
    m = _aspp(g).train(train)
    x0 = torch.randn(2, 34, 21, 64, generator=g)
    gy = torch.randn(2, 34, 21, 16, generator=g)

    def grads():
        x = x0.clone().requires_grad_()
        m.zero_grad()
        (m(x) * gy).sum().backward()
        return [x.grad] + [p.grad.clone() for p in m.parameters()]

    got = grads()
    _parent_route(m, True)
    ref = grads()
    _parent_route(m, False)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["eval_no_grad", "eval_grad", "train"])
def test_route_fuses_only_eval_bf16_without_grad(monkeypatch, mode, dtype):
    """Each depthwise layer calls the wrapper once; with the epilogue only
    where its BatchNorm is in eval mode on bf16 and no gradient flows."""
    calls = []

    def spy(x, w, d, affine=None):
        calls.append((d, affine is not None))
        return k4.dilated_dwconv3x3(x, w, d, affine)

    monkeypatch.setattr(layers, "dilated_dwconv3x3", spy)
    m = _aspp(torch.Generator().manual_seed(2), dtype)
    m.train(mode == "train").requires_grad_(mode == "eval_grad")
    x = torch.randn(1, 20, 20, 64).to(dtype)
    with torch.set_grad_enabled(mode == "eval_grad"):
        m(x)
    fused = mode == "eval_no_grad" and dtype == torch.bfloat16
    assert calls == [(6, fused), (12, fused), (18, fused)]


def test_other_convs_keep_their_route():
    """Dense, strided, padded-otherwise and biased convs go to TorchConv."""
    assert not ConvBNReLU(8, 8, 3, groups=1).dilated_dw
    assert not ConvBNReLU(8, 8, 3, stride=2, groups=8).dilated_dw
    assert not ConvBNReLU(8, 8, 3, dilation=2, padding=1, groups=8).dilated_dw
    assert not ConvBNReLU(8, 8, 3, groups=8, use_norm=False).dilated_dw
    assert not ConvBNReLU(8, 16, 1).dilated_dw
    assert ConvBNReLU(8, 8, 3, dilation=3, groups=8).dilated_dw


# --------------------------------------------------------------- refusals


def test_wrapper_refusals():
    x = torch.randn(1, 6, 7, 8)
    w = torch.randn(8, 1, 3, 3)
    with pytest.raises(ValueError):
        dilated_dwconv3x3(x, w[:4], 2)               # weight of other C
    with pytest.raises(ValueError):
        dilated_dwconv3x3(x, w.reshape(8, 3, 3), 2)  # not (C,1,3,3)
    with pytest.raises(ValueError):
        dilated_dwconv3x3(x, w, 0)
    with pytest.raises(TypeError):
        dilated_dwconv3x3(x, w.double(), 2)
    a = torch.ones(8)
    with pytest.raises(ValueError):                  # the epilogue: bf16 x
        dilated_dwconv3x3(x, w, 2, (a, a))
    x, w = x.bfloat16(), w.bfloat16()
    dilated_dwconv3x3(x, w, 2, (a, a))
    with pytest.raises(ValueError):
        dilated_dwconv3x3(x, w, 2, (a.bfloat16(), a))  # fp32 fold only
    with pytest.raises(ValueError):
        dilated_dwconv3x3(x, w, 2, (a[:4], a[:4]))
    with pytest.raises(ValueError):                  # the epilogue: no grad
        dilated_dwconv3x3(x.requires_grad_(), w, 2, (a, a))


def test_cpu_calls_are_not_counted():
    """The counters count launches on the card only."""
    before = (dilated_dwconv3x3.launches, dilated_dwconv3x3.fused)
    x = torch.randn(1, 6, 7, 8).bfloat16()
    dilated_dwconv3x3(x, torch.randn(8, 1, 3, 3).bfloat16(), 2,
                      (torch.ones(8), torch.zeros(8)))
    assert (dilated_dwconv3x3.launches, dilated_dwconv3x3.fused) == before
