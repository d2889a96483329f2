"""K5, the fused bf16 LayerNorm (refign_tpu_torch/csrc/layer_norm.cu), and
``TorchLayerNorm``'s route to it.

On the CPU:

* ``layer_norm_reference``, the composite moved out of ``TorchLayerNorm``,
  equals the composite as ``TorchLayerNorm`` ran it before K5 (copied below)
  bit for bit, at the MiT-B5 widths and both eps, and so does the module
  through its route.
* The route: bf16 x without a gradient goes to ``layer_norm``; fp32 x, and
  bf16 where x or the affine requires grad under grad mode, take the
  composite and never call it.
* K5's order of the fp32 row sums (a tree over each 16-byte chunk, the
  chunk sums in turn, a butterfly over the row's 8 lanes), emulated in fp32
  torch ops, meets
  the card's agreement rule against the composite.

On the card (marked ``cuda``, skipped without a CUDA device; run with
``python -m pytest tests/test_torch_layer_norm.py -q`` on the H100):

* K5 against the composite on the card at the four widths, 1 to 30 x 18225
  rows, bf16 or fp32 affine, by ``chip_smoke.layer_norm_agreement``: at
  least 99.9 % equal, the rest within one bf16 ulp, or, where the output
  cancels to near zero, within 2^-16 of |x*s| + |b| + |m*r*w| (the
  magnitudes of its terms; the fp32 row sums are
  taken in another order than torch's reduction, so m and r may differ by
  an fp32 rounding; nothing else differs).
* The refusals: rows not stored densely, widths the kernel does not take,
  fp32 x, inputs that require grad.
* An inference forward of bf16 ``mit_b1`` (MiT-B5's widths at depth 2;
  ``mit_b0``'s 32-wide heads are not K1's) launches K5 once for every
  ``TorchLayerNorm`` call, and none takes the composite.
"""
import pytest
import torch

import chip_smoke
from refign_tpu_torch.models.mix_transformer import MixVisionTransformer
from refign_tpu_torch.nn import layers
from refign_tpu_torch.nn.layers import TorchLayerNorm
from refign_tpu_torch.ops import _build
from refign_tpu_torch.ops.layer_norm import layer_norm, layer_norm_reference
from refign_tpu_torch.parallel.mesh import cast_floating

WIDTHS = [64, 128, 320, 512]  # MiT-B5's stages
EPS = [1e-5, 1e-6]  # the spatial-reduction and patch norms, the others


def parent_bf16_layer_norm(x, weight, bias, eps):
    """``TorchLayerNorm.forward``'s bf16 arm as it was before K5."""
    x32 = x.float()
    w = weight.float()
    b = bias.float()
    m = x32.mean(-1, keepdim=True)
    m2 = x32.square().mean(-1, keepdim=True)
    r = torch.rsqrt(torch.clamp(m2 - m.square(), min=0.0) + eps)
    s = r * w
    t = b - m * r * w
    return (x32 * s + t).to(x.dtype)


def _inputs(gen, rows, C, w_dtype, device="cpu"):
    """bf16 rows off zero (the variance's cancellation is exercised) and a
    drawn affine."""
    x = (1.5 + 2.0 * torch.randn(rows, C, generator=gen, device=device)
         ).bfloat16()
    w = (1 + 0.3 * torch.randn(C, generator=gen, device=device)).to(w_dtype)
    b = (0.2 * torch.randn(C, generator=gen, device=device)).to(w_dtype)
    return x, w, b


def _module(w, b, eps):
    ln = TorchLayerNorm(w.shape[0], eps=eps).to(w.device)
    ln.weight.data = w.clone()
    ln.bias.data = b.clone()
    return ln


@pytest.fixture
def kernel_calls(monkeypatch):
    """Calls of ``layer_norm`` from ``TorchLayerNorm``."""
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return layer_norm(*args)

    monkeypatch.setattr(layers, "layer_norm", spy)
    return calls


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("C", WIDTHS)
def test_reference_is_the_parent_composite(C, eps, kernel_calls):
    gen = torch.Generator().manual_seed(C)
    for w_dtype in (torch.bfloat16, torch.float32):
        x, w, b = _inputs(gen, 37, C, w_dtype)
        x = x.view(1, 37, 1, C)
        want = parent_bf16_layer_norm(x, w, b, eps)
        assert want.dtype == torch.bfloat16
        assert torch.equal(layer_norm_reference(x, w, b, eps), want)
        with torch.no_grad():  # the route: layer_norm's plain path
            assert torch.equal(_module(w, b, eps)(x), want)
        assert torch.equal(layer_norm(x, w, b, eps), want)
    assert len(kernel_calls) == 2


@pytest.mark.parametrize("case", ["fp32", "x_grad", "affine_grad",
                                  "no_grad_mode", "frozen"])
def test_route(case, kernel_calls):
    """fp32 and bf16 with a gradient keep the composite (autograd through
    it); bf16 without one, under no_grad or with nothing that requires
    grad (the frozen teacher's forward), calls ``layer_norm``."""
    gen = torch.Generator().manual_seed(1)
    x, w, b = _inputs(gen, 6, 64, torch.bfloat16)
    ln = _module(w, b, 1e-6)
    if case == "fp32":
        x, ln = x.float(), ln.float()
    ln.requires_grad_(case in ("affine_grad", "no_grad_mode"))
    x.requires_grad_(case == "x_grad")
    with torch.set_grad_enabled(case != "no_grad_mode"):
        y = ln(x)
    want_kernel = case in ("no_grad_mode", "frozen")
    assert len(kernel_calls) == int(want_kernel)
    if case != "fp32":
        assert torch.equal(y, parent_bf16_layer_norm(x, w, b, 1e-6))
    if case in ("x_grad", "affine_grad"):
        y.float().square().sum().backward()
        grads = [x.grad] if case == "x_grad" else [ln.weight.grad,
                                                   ln.bias.grad]
        assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_refusals_on_cpu():
    gen = torch.Generator().manual_seed(2)
    x, w, b = _inputs(gen, 4, 64, torch.float32)
    with pytest.raises(TypeError):
        layer_norm(x.float(), w, b, 1e-6)  # fp32 x
    with pytest.raises(ValueError):
        layer_norm(x, w[:32], b, 1e-6)  # affine of another width
    with pytest.raises(TypeError):
        layer_norm(x, w, b.bfloat16(), 1e-6)  # mixed affine dtypes
    with pytest.raises(ValueError):
        layer_norm(x, w, b, 0.0)
    with pytest.raises(ValueError):  # no backward
        layer_norm(x.requires_grad_(), w, b, 1e-6)


def _kernel_order_emulated(x, w, b, eps):
    """K5's arithmetic on the CPU: lane l of a row's 8 holds its 16-byte
    chunks l, l + 8, ..., sums each chunk's 8 values as a tree and the
    chunk sums in turn, then the 8 lane sums meet in a butterfly (xor 4, 2,
    1); the rest as the composite."""
    R, C = x.shape
    K = -(-C // 64)
    x32 = torch.zeros(R, K * 64)
    x32[:, :C] = x.float()
    lanes = x32.view(R, K, 8, 8).transpose(1, 2)  # (row, lane, chunk, value)
    sums = []
    for v in (lanes, lanes * lanes):
        while v.shape[-1] > 1:  # ((v0 + v1) + (v2 + v3)) + ...
            v = v[..., 0::2] + v[..., 1::2]
        acc = torch.zeros(R, 8)
        for k in range(K):
            acc = acc + v[:, :, k, 0]
        for o in (4, 2, 1):
            acc = acc + acc[:, torch.arange(8) ^ o]
        sums.append(acc[:, :1])
    m, m2 = sums[0] * (1.0 / C), sums[1] * (1.0 / C)
    r = torch.rsqrt(torch.clamp(m2 - m * m, min=0.0) + eps)
    w32, b32 = w.float(), b.float()
    return (x.float() * (r * w32) + (b32 - (m * r) * w32)).bfloat16()


@pytest.mark.parametrize("C", WIDTHS)
def test_kernel_order_meets_the_agreement_rule(C):
    gen = torch.Generator().manual_seed(10 + C)
    x, w, b = _inputs(gen, 4096, C, torch.bfloat16)
    got = _kernel_order_emulated(x, w, b, 1e-6)
    equal, _, cancel, _ = chip_smoke.layer_norm_agreement(got, x, w, b,
                                                          1e-6)
    assert equal >= chip_smoke.LN_EQUAL_SHARE
    assert cancel <= chip_smoke.LN_CANCEL_REL


# ----------------------------------------------------------------- card


@pytest.fixture(scope="module")
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: python -m pytest "
                    "tests/test_torch_layer_norm.py)")
    _build.load("layer_norm")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 7, 289, 30 * 18225])
@pytest.mark.parametrize("C", WIDTHS)
def test_kernel_matches_composite(cuda_gen, C, rows, w_dtype):
    x, w, b = _inputs(cuda_gen, rows, C, w_dtype, "cuda")
    before = layer_norm.launches
    got = layer_norm(x, w, b, 1e-6)
    assert layer_norm.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    chip_smoke.layer_norm_agreement(got, x, w, b, 1e-6)  # raises


@pytest.mark.cuda
def test_kernel_refusals(cuda_gen):
    x, w, b = _inputs(cuda_gen, 64, 128, torch.bfloat16, "cuda")
    with pytest.raises(ValueError):  # rows not stored densely
        layer_norm(x[:, :64], w[:64], b[:64], 1e-6)
    with pytest.raises(ValueError):
        layer_norm(x.t(), w[:64], b[:64], 1e-6)
    with pytest.raises(ValueError):  # C % 8 != 0
        layer_norm(x[:, :36].contiguous(), w[:36], b[:36], 1e-6)
    wide, ww, bw = _inputs(cuda_gen, 4, 1024, torch.bfloat16, "cuda")
    with pytest.raises(ValueError):  # wider than the kernel's rows
        layer_norm(wide, ww, bw, 1e-6)
    with pytest.raises(TypeError):
        layer_norm(x.float(), w, b, 1e-6)
    with pytest.raises(ValueError):
        layer_norm(x, w.requires_grad_(), b, 1e-6)


@pytest.mark.cuda
def test_mit_b1_forward_launches_once_per_norm(cuda_gen, monkeypatch):
    composite = []

    def spy(*args):
        composite.append(args[0].shape)
        return layer_norm_reference(*args)

    monkeypatch.setattr(layers, "layer_norm_reference", spy)
    model = MixVisionTransformer("mit_b1", drop_path_rate=0.0)
    model.init_weights(torch.Generator().manual_seed(0))
    model = cast_floating(model.cuda().eval(), torch.bfloat16)
    norms = []
    for m in model.modules():
        if isinstance(m, TorchLayerNorm):
            m.register_forward_hook(lambda *_: norms.append(1))
    x = torch.randn(2, 64, 64, 3, generator=cuda_gen,
                    device="cuda").bfloat16()
    before = layer_norm.launches
    with torch.no_grad():
        outs = model(x)
    torch.cuda.synchronize()
    assert len(norms) == 30  # 8 blocks x 2, 6 reductions, 4 embeds, 4 stages
    assert layer_norm.launches - before == len(norms)
    assert composite == []
    assert all(o.dtype == torch.bfloat16 and torch.isfinite(o).all()
               for o in outs)
