"""Train mode of the port's layers and heads (refign_tpu_torch/nn/layers.py,
models/heads/) against the JAX package.

* ``TorchBatchNorm`` with batch statistics: outputs, running statistics
  (unbiased variance, momentum 0.1, fp32) and gradients against the JAX
  module applied with ``use_running_average=False`` at 1e-5 in fp32; the
  bf16 fold at the layer tests' bf16 tolerance, its running statistics
  (computed in fp32 from the same bf16 values) at 1e-5;
* ``update_stats = False`` (the EMA teacher) keeps the running statistics;
* ``ConvBNReLU``, DAFormer and SegFormer heads in train mode (batch
  statistics, dropout off without a generator) against the JAX modules
  with ``train=True``, outputs and running statistics at 1e-4;
* ``DropPath`` and ``Dropout2d``: their draws come from a torch generator
  and cannot match JAX's, so they are checked as distributions: the keep
  rate within 5 sigma of 1 - rate, kept values scaled by 1 / (1 - rate),
  one draw per sample (per sample and channel), the same draws from the
  same seed, the identity in eval and without a generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.models.heads.daformer import DAFormerHead as JaxDAFormer
from refign_tpu.models.heads.segformer import SegFormerHead as JaxSegFormer
from refign_tpu.nn import layers as jl
from refign_tpu_torch.models.heads.daformer import DAFormerHead
from refign_tpu_torch.models.heads.segformer import SegFormerHead
from refign_tpu_torch.nn import layers as tl
from refign_tpu_torch.parallel.mesh import cast_floating
from refign_tpu_torch.utils.jax_convert import (flax_location,
                                              load_jax_variables)

TOL = dict(rtol=0, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
HEAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _perturb(tree, seed, scale=0.1):
    rng = np.random.RandomState(seed)

    def go(t, name=""):
        if isinstance(t, dict):
            return {k: go(v, k) for k, v in t.items()}
        a = np.asarray(t, np.float32)
        noise = scale * rng.randn(*a.shape).astype(np.float32)
        return np.abs(a + noise) + 0.1 if name == "var" else a + noise

    return go(tree)


def _init(module, *args, seed=0, **kw):
    variables = jax.jit(lambda k: module.init(k, *args, **kw))(
        jax.random.PRNGKey(seed))
    return _perturb(jax.tree_util.tree_map(np.asarray, dict(variables)),
                    seed)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _bn_input(seed, shape=(3, 7, 6, 24)):
    rng = np.random.RandomState(seed)
    # an offset per channel, so E[x^2] - E[x]^2 is not trivially E[x^2]
    return (rng.randn(*shape) * 1.5 + rng.randn(shape[-1]) * 2.0).astype(
        np.float32)


@pytest.mark.parametrize("bf16", [False, True])
def test_batch_norm_train_matches_jax(bf16):
    x = _bn_input(0)
    jm = jl.TorchBatchNorm()
    variables = _init(jm, x)
    tm = tl.TorchBatchNorm(24)
    load_jax_variables(tm, variables)
    jvars = dict(variables)
    if bf16:
        jvars["params"] = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.bfloat16), variables["params"])
        cast_floating(tm, torch.bfloat16)
    dt_j = jnp.bfloat16 if bf16 else jnp.float32
    dt_t = torch.bfloat16 if bf16 else torch.float32
    want, mut = jm.apply(jvars, jnp.asarray(x, dt_j),
                         use_running_average=False, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(x).to(dt_t))
    assert got.dtype == dt_t
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(BF16_TOL if bf16 else TOL))
    assert tm.running_mean.dtype == torch.float32
    np.testing.assert_allclose(tm.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(tm.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), **TOL)


def test_batch_norm_train_gradients_match_jax():
    x = _bn_input(1)
    jm = jl.TorchBatchNorm()
    variables = _init(jm, x)
    g = np.random.RandomState(2).randn(*x.shape).astype(np.float32)

    def f(xx, params):
        y, _ = jm.apply({"params": params,
                         "batch_stats": variables["batch_stats"]}, xx,
                        use_running_average=False, mutable=["batch_stats"])
        return y

    _, vjp = jax.vjp(f, jnp.asarray(x), variables["params"])
    gx, gp = vjp(jnp.asarray(g))
    tm = tl.TorchBatchNorm(24)
    load_jax_variables(tm, variables)
    xt = torch.from_numpy(x).requires_grad_()
    tm.train()(xt).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(tm.weight.grad.numpy(),
                               np.asarray(gp["scale"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.bias.grad.numpy(), np.asarray(gp["bias"]),
                               rtol=0, atol=1e-4)


def test_batch_norm_without_stat_updates():
    """The EMA teacher's mode: batch statistics normalise, the running
    statistics stay."""
    x = torch.from_numpy(_bn_input(3))
    tm = tl.TorchBatchNorm(24)
    tm.running_mean.fill_(0.5)
    ref = tl.TorchBatchNorm(24).train()
    with torch.no_grad():
        want = ref(x)
        tm.update_stats = False
        got = tm.train()(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (tm.running_mean == 0.5).all() and (tm.running_var == 1.0).all()
    assert not torch.equal(ref.running_mean, torch.zeros(24))


@pytest.mark.parametrize("kind", ["plain3x3", "separable", "pointwise"])
def test_conv_bn_relu_train_matches_jax(kind):
    rng = np.random.RandomState(4)
    cin, cout = 16, 24
    x = rng.randn(2, 11, 13, cin).astype(np.float32)
    kw = dict(plain3x3=dict(kernel_size=3, padding=1),
              separable=dict(kernel_size=3, dilation=6, padding=6,
                             depthwise_separable=True),
              pointwise=dict(kernel_size=1, padding=0))[kind]
    jm = jl.ConvBNReLU(cout, **kw)
    tm = tl.ConvBNReLU(cin, cout, **kw)
    variables = _init(jm, x)
    load_jax_variables(tm, variables)
    want, mut = jm.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_stats = _flat(mut["batch_stats"])
    bufs = dict(tm.named_buffers())
    assert len(bufs) == len(want_stats) > 0
    for name, buf in bufs.items():
        _, path = flax_location(name, buf.dim())
        np.testing.assert_allclose(buf.numpy(), want_stats[path], **TOL)


def _feats(seed, dims=(32, 64, 160, 256), side=16, B=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, side >> i, side >> i, d).astype(np.float32)
            for i, d in enumerate(dims)]


@pytest.mark.parametrize("which", ["daformer", "segformer"])
def test_heads_train_mode_match_jax(which):
    """Batch-statistics BN through the whole head (dropout off: the
    dropout module in eval mode, ``deterministic=True``), outputs and
    updated statistics."""
    feats = _feats(5)
    dims = [f.shape[-1] for f in feats]
    if which == "daformer":
        jm = JaxDAFormer(num_classes=19, channels=32, embed_dims=32)
        tm = DAFormerHead(19, in_channels=dims, channels=32, embed_dims=32)
    else:
        jm = JaxSegFormer(num_classes=19, channels=32)
        tm = SegFormerHead(19, in_channels=dims, channels=32)
    variables = _init(jm, feats)
    load_jax_variables(tm, variables)
    want, mut = jm.apply(variables, feats, train=True, deterministic=True,
                         mutable=["batch_stats"])
    tm.train()
    tm.dropout.eval()
    with torch.no_grad():
        got = tm([torch.from_numpy(f) for f in feats])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HEAD_TOL)
    want_stats = _flat(mut["batch_stats"])
    n = 0
    for name, buf in tm.named_buffers():
        _, path = flax_location(name, buf.dim())
        np.testing.assert_allclose(buf.numpy(), want_stats[path],
                                   **HEAD_TOL)
        n += 1
    assert n == len(want_stats) > 0


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_drop_path_keeps_and_scales_per_sample(rate):
    m = tl.DropPath(rate).train()
    x = torch.ones(20000, 3, 2, 4)
    y = m(x, _gen(1))
    per_sample = y.reshape(20000, -1)
    # one draw per sample: every element of a sample kept or dropped alike
    assert (per_sample == per_sample[:, :1]).all()
    kept = per_sample[:, 0] != 0
    torch.testing.assert_close(per_sample[kept, 0],
                               torch.full((int(kept.sum()),), 1 / (1 - rate)))
    n, p = 20000, 1 - rate
    assert abs(kept.float().mean().item() - p) < 5 * (p * (1 - p) / n) ** .5
    torch.testing.assert_close(m(x, _gen(1)), y, rtol=0, atol=0)
    assert not torch.equal(m(x, _gen(2)), y)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout2d_keeps_and_scales_per_channel(rate):
    m = tl.Dropout2d(rate).train()
    x = torch.ones(50, 3, 5, 400)
    y = m(x, _gen(3))
    # one draw per (sample, channel), shared over H and W
    assert (y == y[:, :1, :1, :]).all()
    kept = y[:, 0, 0, :] != 0
    torch.testing.assert_close(y[:, 0, 0, :][kept],
                               torch.full((int(kept.sum()),), 1 / (1 - rate)))
    n, p = kept.numel(), 1 - rate
    assert abs(kept.float().mean().item() - p) < 5 * (p * (1 - p) / n) ** .5
    torch.testing.assert_close(m(x, _gen(3)), y, rtol=0, atol=0)


def test_dropouts_are_identity_in_eval_and_without_generator():
    """Identity in eval mode and at rate 0, where no generator is needed;
    in train mode a rate > 0 draws from the generator passed and raises
    without one."""
    x = torch.randn(4, 3, 2, 8)
    for m in (tl.DropPath(0.3), tl.Dropout2d(0.3)):
        assert m.eval()(x, _gen()) is x
        assert m.eval()(x) is x
        with pytest.raises(ValueError, match="generator"):
            m.train()(x)
        assert m.train()(x, _gen()) is not x
    for m in (tl.DropPath(0.0), tl.Dropout2d(0.0)):
        assert m.train()(x) is x
        assert m.train()(x, _gen()) is x
