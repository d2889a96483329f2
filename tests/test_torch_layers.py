"""The port's layers and resize ops (refign_tpu_torch/nn/layers.py,
refign_tpu_torch/ops/resize.py) against the JAX package.

Weights travel from the JAX modules into the port through
``load_jax_variables``.  fp32 at atol 1e-5.  bf16 (parameters and input
in bf16, as the bf16 inference path runs them) at atol 2e-2 plus rtol
2e-2: the two frameworks round to bf16 at different places (the JAX resize
rounds after each axis and uses bf16 interpolation weights; torch rounds
once), which costs up to a few bf16 ulps (2^-8 relative each).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.nn import layers as jl
from refign_tpu.ops import resize as jr
from refign_tpu_torch.nn import layers as tl
from refign_tpu_torch.ops import resize as tr
from refign_tpu_torch.parallel.mesh import cast_floating
from refign_tpu_torch.utils.jax_convert import load_jax_variables

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _perturb(tree, seed, scale=0.1):
    """Add noise to every leaf so biases, BN stats and LN affines differ
    from their init values; variances stay positive."""
    rng = np.random.RandomState(seed)

    def go(t, name=""):
        if isinstance(t, dict):
            return {k: go(v, k) for k, v in t.items()}
        a = np.asarray(t, np.float32)
        noise = scale * rng.randn(*a.shape).astype(np.float32)
        return np.abs(a + noise) + 0.1 if name == "var" else a + noise

    return go(tree)


def _init(module, x, seed=0, **kw):
    variables = jax.jit(lambda k, x: module.init(k, x, **kw))(
        jax.random.PRNGKey(seed), x)
    return _perturb(jax.tree_util.tree_map(np.asarray, dict(variables)),
                    seed)


def _to_jax_bf16(variables):
    """bf16 params, fp32 batch stats (the JAX package's cast_floating of
    params only)."""
    out = dict(variables)
    out["params"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), variables["params"])
    return out


def _run_both(jmod, tmod, x, variables, bf16=False, **apply_kw):
    tmod.eval()
    load_jax_variables(tmod, variables)
    if bf16:
        variables = _to_jax_bf16(variables)
        cast_floating(tmod, torch.bfloat16)
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jmod.apply(variables, xj, **apply_kw), np.float32)
    with torch.no_grad():
        got = tmod(xt)
    assert got.dtype == xt.dtype
    return got.float().numpy(), want


@pytest.mark.parametrize("bf16", [False, True])
def test_layer_norm(bf16):
    rng = np.random.RandomState(0)
    x = (3.0 + 2.0 * rng.randn(2, 5, 7, 48)).astype(np.float32)
    jm = jl.TorchLayerNorm(epsilon=1e-6)
    got, want = _run_both(jm, tl.TorchLayerNorm(48, eps=1e-6), x,
                          _init(jm, x), bf16=bf16)
    tol = BF16_TOL if bf16 else dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("bf16", [False, True])
def test_batch_norm_eval(bf16):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 5, 24).astype(np.float32)
    jm = jl.TorchBatchNorm()
    tm = tl.TorchBatchNorm(24)
    got, want = _run_both(jm, tm, x, _init(jm, x), bf16=bf16,
                          use_running_average=True)
    assert tm.running_mean.dtype == torch.float32  # stats stay fp32
    tol = BF16_TOL if bf16 else dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, **tol)


def test_batch_norm_train_mode_raises():
    """Train mode raises where a channel has one value (torch's
    BatchNorm2d rule) and leaves the running statistics as they were; eval
    mode takes the same input."""
    x = torch.ones(1, 1, 1, 4)
    bn = tl.TorchBatchNorm(4)
    with pytest.raises(ValueError, match="more than one value"):
        bn.train()(x)
    assert torch.equal(bn.running_mean, torch.zeros(4))
    assert torch.equal(bn.running_var, torch.ones(4))
    assert bn.eval()(x).shape == x.shape


def test_batch_norm_train_mode_uses_batch_stats():
    """Train mode normalises with the batch statistics and updates the
    running ones (held against the JAX module in
    tests/test_torch_train_layers.py)."""
    x = torch.arange(16, dtype=torch.float32).reshape(1, 2, 2, 4)
    bn = tl.TorchBatchNorm(4).train()
    y = bn(x)
    torch.testing.assert_close(y.mean((0, 1, 2)), torch.zeros(4), rtol=0,
                               atol=1e-6)
    assert not torch.equal(bn.running_mean, torch.zeros(4))


@pytest.mark.parametrize("kind,bf16", [("plain3x3", False),
                                       ("separable", False),
                                       ("separable", True),
                                       ("pointwise", False)])
def test_conv_bn_relu(kind, bf16):
    rng = np.random.RandomState(2)
    cin, cout = 16, 24
    x = rng.randn(2, 11, 13, cin).astype(np.float32)
    if kind == "separable":
        jm = jl.ConvBNReLU(cout, kernel_size=3, dilation=6, padding=6,
                           depthwise_separable=True)
        tm = tl.ConvBNReLU(cin, cout, kernel_size=3, dilation=6, padding=6,
                           depthwise_separable=True)
    elif kind == "plain3x3":
        jm = jl.ConvBNReLU(cout, kernel_size=3, padding=1)
        tm = tl.ConvBNReLU(cin, cout, kernel_size=3, padding=1)
    else:
        jm = jl.ConvBNReLU(cout, kernel_size=1, padding=0)
        tm = tl.ConvBNReLU(cin, cout, kernel_size=1, padding=0)
    got, want = _run_both(jm, tm, x, _init(jm, x), bf16=bf16)
    tol = BF16_TOL if bf16 else dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("bf16", [False, True])
def test_mlp_embed(bf16):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 6, 40).astype(np.float32)
    jm = jl.MLPEmbed(32)
    got, want = _run_both(jm, tl.MLPEmbed(40, 32), x, _init(jm, x),
                          bf16=bf16)
    tol = BF16_TOL if bf16 else dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, **tol)


def test_gelu_dropout_droppath_eval():
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 4, 5)
                         .astype(np.float32))
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()),
                                  approximate=False))
    np.testing.assert_allclose(tl.gelu(x).numpy(), want, rtol=0, atol=1e-6)
    for m in (tl.DropPath(0.3), tl.Dropout2d(0.3)):
        assert m.eval()(x) is x
        # train mode draws only from an explicit generator
        with pytest.raises(ValueError, match="generator"):
            m.train()(x)
    for m in (tl.DropPath(0.0), tl.Dropout2d(0.0)):
        assert m.train()(x) is x


RESIZE_CASES = [
    ("bilinear", False, (17, 23)), ("bilinear", False, (5, 4)),
    ("bilinear", True, (17, 23)), ("bilinear", True, (5, 4)),
    ("nearest", None, (17, 23)), ("nearest", None, (5, 4)),
    ("area", None, (5, 4)), ("area", None, (3, 7)),
]


@pytest.mark.parametrize("mode,align,size", RESIZE_CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_interpolate(mode, align, size, bf16):
    x = np.random.RandomState(5).randn(2, 9, 14, 6).astype(np.float32)
    dt_j, dt_t = ((jnp.bfloat16, torch.bfloat16) if bf16
                  else (jnp.float32, torch.float32))
    want = np.asarray(jr.interpolate(jnp.asarray(x, dt_j), size, mode=mode,
                                     align_corners=align), np.float32)
    got = tr.interpolate(torch.from_numpy(x).to(dt_t), size, mode=mode,
                         align_corners=align)
    assert got.dtype == dt_t and tuple(got.shape) == (2, *size, 6)
    tol = BF16_TOL if bf16 else dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_interpolate_rejects_integer_linear():
    with pytest.raises(TypeError):
        tr.interpolate(torch.zeros(1, 4, 4, 1, dtype=torch.int64), (8, 8),
                       mode="bilinear", align_corners=False)


@pytest.mark.parametrize("out_size", [1, 3, (2, 5), (9, 14)])
@pytest.mark.parametrize("bf16", [False, True])
def test_adaptive_avg_pool(out_size, bf16):
    x = np.random.RandomState(6).randn(2, 9, 14, 6).astype(np.float32)
    dt_j, dt_t = ((jnp.bfloat16, torch.bfloat16) if bf16
                  else (jnp.float32, torch.float32))
    want = np.asarray(jr.adaptive_avg_pool(jnp.asarray(x, dt_j), out_size),
                      np.float32)
    got = tr.adaptive_avg_pool(torch.from_numpy(x).to(dt_t), out_size)
    assert got.dtype == dt_t
    tol = BF16_TOL if bf16 else dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
