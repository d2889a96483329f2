"""K2's bf16 backward halo tile (refign_tpu_torch/csrc/
dwconv3x3_gelu_backward.cu) emulated in PyTorch on the CPU.

The emulation repeats the tile body's arithmetic with the tile constants
read from the source: near-equal tiles of at most MAX_T rows and columns;
per (tile, image), x staged with a 2-pixel halo and g with a 1-pixel ring,
both zero outside the image; z over the tile and its ring in the forward's
tap order (i outer, j inner, then the bias), g' = g * GELU'(z) in fp32 (0
outside the image, where g is 0); dx over the tile from g''s flipped taps;
one partial per tile of x * g' (9 taps) and g' over the tile's pixels in
the image; and the partials added in the reduce kernel's order (RG groups
of consecutive partials in tile order, then the groups in order).  It is
held at 1e-5 against the JAX package's VJP (``_fused_bwd``: the VJP of the
fp32 shift-and-add formulation) on maps narrower than a tile and ragged
around it, and channel counts ragged around the CS-channel slice.  The
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.ops.dwconv import dwconv3x3_gelu as jax_dwconv3x3_gelu
from refign_tpu_torch.ops import dwconv as tdw

CU = os.path.join(os.path.dirname(tdw.__file__), os.pardir, "csrc",
                  "dwconv3x3_gelu_backward.cu")
TOL = 1e-5
SMEM_PER_SM = 233472  # shared memory of an H100 SM, in bytes (228 KB)


def _constants():
    """CS, MAX_T and NT of the tile body, RG of the reduce."""
    with open(CU) as f:
        src = f.read()
    body = src[src.index("namespace tile {"):src.index("}  // namespace tile")]
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", body))
    rg = int(re.search(r"constexpr int RG = (\d+);", src).group(1))
    assert consts["LV"].replace(" ", "") == "CS/8"
    return int(consts["CS"]), int(consts["MAX_T"]), int(consts["NT"]), rg


def tile_size(n: int, max_t: int) -> int:
    """Near-equal tiles of at most max_t (the source's tile_size)."""
    tiles = -(-n // max_t)
    return -(-n // tiles)


def _gelu_grad(z):
    return (0.5 * (1.0 + torch.erf(z * 0.70710678118654752))
            + z * 0.39894228040143268 * torch.exp(-0.5 * z * z))


def emulate_tile_backward(x, w, b, g):
    """dx, dw (3,3,1,C) and db of the halo-tile body, in fp32 before the
    final rounding; x, g (B,H,W,C), w HWIO (3,3,1,C), b (C,)."""
    CS, MAX_T, _, RG = _constants()
    B, H, W, C = x.shape
    TH, TW = tile_size(H, MAX_T), tile_size(W, MAX_T)
    th, tw = -(-H // TH), -(-W // TW)
    wk = w[:, :, 0]  # (3, 3, C)
    # zero fill: x 2 pixels and g 1 pixel around the image, and past the
    # last (ragged) tile
    xp = torch.zeros(B, th * TH + 4, tw * TW + 4, C)
    xp[:, 2:2 + H, 2:2 + W] = x
    gp = torch.zeros(B, th * TH + 2, tw * TW + 2, C)
    gp[:, 1:1 + H, 1:1 + W] = g
    dx = torch.zeros(B, th * TH, tw * TW, C)
    partials = []
    for img in range(B):
        for ty in range(th):          # tile order: rows of tiles, then columns
            for tx in range(tw):
                y0, x0 = ty * TH, tx * TW
                xs = xp[img, y0:y0 + TH + 4, x0:x0 + TW + 4]
                # z over the tile and its ring, ring pixel (r, c) at image
                # (y0-1+r, x0-1+c), x at (r+i, c+j) of the staged halo
                z = torch.zeros(TH + 2, TW + 2, C)
                for i in range(3):
                    for j in range(3):
                        z = z + xs[i:i + TH + 2, j:j + TW + 2] * wk[i, j]
                gprime = gp[img, y0:y0 + TH + 2, x0:x0 + TW + 2] \
                    * _gelu_grad(z + b)
                # dx at (t, u): g' of ring pixel (t+2-i, u+2-j) times w[i, j]
                d = torch.zeros(TH, TW, C)
                for i in range(3):
                    for j in range(3):
                        d = d + gprime[2 - i:2 - i + TH, 2 - j:2 - j + TW] \
                            * wk[i, j]
                dx[img, y0:y0 + TH, x0:x0 + TW] = d
                # the tile's pixels in the image; x at (t+i+1, u+j+1)
                inside = torch.zeros(TH, TW, 1)
                inside[:min(TH, H - y0), :min(TW, W - x0)] = 1.0
                gin = gprime[1:1 + TH, 1:1 + TW] * inside
                part = torch.stack(
                    [(xs[i + 1:i + 1 + TH, j + 1:j + 1 + TW] * gin).sum((0, 1))
                     for i in range(3) for j in range(3)] + [gin.sum((0, 1))])
                partials.append(part)  # (10, C)
    # the reduce: RG groups of consecutive partials, then the groups
    R = len(partials)
    per = -(-R // RG)
    total = torch.zeros(10, C)
    for grp in range(RG):
        s = torch.zeros(10, C)
        for r in range(grp * per, min(R, (grp + 1) * per)):
            s = s + partials[r]
        total = total + s
    return dx[:, :H, :W], total[:9].reshape(3, 3, 1, C), total[9]


def _inputs(B, H, W, C, seed):
    """Seeded x, g (B,H,W,C), HWIO w and b, rounded to bf16 (the values the
    kernel reads) and held as fp32."""
    rng = np.random.RandomState(seed)
    arrs = (rng.randn(B, H, W, C), 0.3 * rng.randn(3, 3, 1, C),
            0.1 * rng.randn(C), rng.randn(B, H, W, C))
    return [torch.from_numpy(a.astype(np.float32)).bfloat16().float()
            for a in arrs]


def _jax_vjp(x, w, b, g):
    def f(x, w, b):
        return jax_dwconv3x3_gelu(x, w, b, use_pallas=True, interpret=True)

    grads = jax.jit(lambda x, w, b, g: jax.vjp(f, x, w, b)[1](g))(
        *(jnp.asarray(t.numpy()) for t in (x, w, b, g)))
    return [torch.from_numpy(np.array(t)) for t in grads]


SHAPES = [(1, 1), (5, 7), (17, 33), (40, 23)]


@pytest.mark.parametrize("C", [8, 40, 264])
@pytest.mark.parametrize("H,W", SHAPES)
def test_emulated_tile_matches_jax_vjp(H, W, C):
    x, w, b, g = _inputs(2, H, W, C, seed=H * 1000 + W * 10 + C)
    got = emulate_tile_backward(x, w, b, g)
    want = _jax_vjp(x, w, b, g)
    for name, a, r in zip(("dx", "dw", "db"), got, want):
        assert a.shape == r.shape, name
        err = (a - r).abs().max().item()
        # dw and db sum over B*H*W products: 1e-5 of their largest |ref|
        lim = TOL * max(1.0, r.abs().max().item())
        assert err <= lim, (name, err, lim)


def test_train_step_maps_take_whole_tiles_and_three_blocks_fit():
    """The train step's maps (128, 64, 32, 16 pixels a side) take MAX_T x
    MAX_T tiles with no ragged edge, and three blocks of the largest tile
    fit in an SM's shared memory (weights + max(x halo, the block's partial
    sums) + the fp32 g' tile of both channel halves, and the 1 KB the card
    keeps per block)."""
    CS, MAX_T, NT, _ = _constants()
    assert MAX_T == 16
    for side in (128, 64, 32, 16):
        assert tile_size(side, MAX_T) == MAX_T
    LV = CS // 8
    red = (NT // 32) * 10 * CS * 4
    smem = (10 * CS * 4 + max((MAX_T + 4) ** 2 * LV * 16, red)
            + 2 * (MAX_T + 2) ** 2 * LV * 16)
    assert 3 * (smem + 1024) <= SMEM_PER_SM, smem
    # the ring's share of the erff and expf work at the largest tile
    assert math.isclose((MAX_T + 2) ** 2 / MAX_T ** 2, 1.265625)
