"""The port's grouped BatchNorm (``refign_tpu_torch/nn/layers.py``
``TorchBatchNorm(groups=G)``, ``grouped_bn``) against the JAX package's
``TorchBatchNorm(groups=3)`` and ``_PackedBN(groups=3)``, and against
three serial port calls.

Train mode on a batch that stacks three calls' rows along axis 0: the
output, the running statistics (three EMA updates in group order) and
the gradients of the input and of the affine parameters, fp32 at 1e-5
(rtol, and atol of each array's largest |value| or 1, as
``tests/test_torch_train_layers.py`` holds the ungrouped BN); bf16 output
against JAX's bf16 fold within one bf16 ulp.
The packed BN's (B, H, W, P*C) layout is the port's (B, H, W*P, C):
the same samples per channel.  The grouped module's S = 9 uncertainty
BN, UncertaintyModule under ``grouped_bn(module, 3)``, is held against
JAX's module with ``bn_groups=3``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.models import matching_modules as jm
from refign_tpu.nn.layers import TorchBatchNorm as JaxBN
from refign_tpu_torch.models import matching_modules as tm
from refign_tpu_torch.nn.layers import TorchBatchNorm, grouped_bn
from refign_tpu_torch.utils.jax_convert import load_jax_variables

G = 3
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    C = shape[-1]
    # each group its own mean and scale, so per-group statistics matter
    x = np.concatenate([(rng.randn(*shape) * (1 + g) + g - 1)
                        for g in range(G)]).astype(np.float32)
    return (x, rng.randn(C).astype(np.float32),
            rng.randn(C).astype(np.float32),
            rng.randn(*x.shape).astype(np.float32),
            (rng.rand(C) + 0.5).astype(np.float32),
            (0.1 * rng.randn(C)).astype(np.float32))


def _port(x, w, b, lw, ra_var, ra_mean, groups=G, dtype=torch.float32):
    """Port BN in train mode: output, running stats, dx, dweight, dbias."""
    bn = TorchBatchNorm(x.shape[-1], groups=groups).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
        bn.running_var.copy_(torch.from_numpy(ra_var))
        bn.running_mean.copy_(torch.from_numpy(ra_mean))
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    y = bn(xt)
    (y.float() * torch.from_numpy(lw)).sum().backward()
    return {"y": y.detach().float(), "mean": bn.running_mean,
            "var": bn.running_var, "dx": xt.grad.float(),
            "dw": bn.weight.grad, "db": bn.bias.grad}


def _jax(module, x, w, b, lw, ra_var, ra_mean, reshape=None):
    """The JAX module in train mode on ``x`` (its layout), the gradients
    of sum(y * lw) by jax.grad; returned in the port's layout."""
    stats = {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}

    def f(x, scale, bias):
        y, mut = module.apply({"params": {"scale": scale, "bias": bias},
                               "batch_stats": stats}, x,
                              use_running_average=False,
                              mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * lw.reshape(y.shape)), (
            y, mut["batch_stats"])

    (_, (y, st)), (dx, dw, db) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b))
    back = reshape or (lambda a: a)
    return {"y": back(np.asarray(y, np.float32)),
            "mean": np.asarray(st["mean"]), "var": np.asarray(st["var"]),
            "dx": back(np.asarray(dx, np.float32)), "dw": np.asarray(dw),
            "db": np.asarray(db)}


def _close(got, want, tol=TOL):
    """Each value within rtol, or atol of its array's largest |value|
    (the parameter gradients sum a thousand terms in another order)."""
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(np.asarray(got[k]), w, err_msg=k,
                                   rtol=tol["rtol"],
                                   atol=tol["atol"] * max(np.abs(w).max(),
                                                          1.0))


def test_grouped_bn_matches_jax_grouped_bn():
    x, w, b, lw, rv, rm = _inputs((2, 5, 7, 6), 0)
    _close(_port(x, w, b, lw, rv, rm), _jax(JaxBN(groups=G), x, w, b, lw,
                                            rv, rm))


def test_grouped_bn_bf16_matches_jax_fold():
    """bf16 input: the fp32 fold y = x*a + b per group, then one bf16
    rounding on both sides."""
    x, w, b, lw, rv, rm = _inputs((2, 5, 7, 6), 1)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    got = _port(x, w, b, lw, rv, rm, dtype=torch.bfloat16)
    want = _jax(JaxBN(groups=G), jnp.asarray(x, jnp.bfloat16), w, b, lw,
                rv, rm)
    scale = np.abs(want["y"]).max()
    np.testing.assert_allclose(got["y"].numpy(), want["y"], rtol=2 ** -8,
                               atol=1e-5 * scale)
    _close({k: got[k] for k in ("mean", "var")},
           {k: want[k] for k in ("mean", "var")})


def test_grouped_bn_matches_jax_packed_bn():
    """JAX's packed (B, H, W, P*C) layout, C fastest, against the port's
    BN on (B, H, W*P, C)."""
    B, H, W, P, C = 2, 4, 5, 9, 8
    x, w, b, lw, rv, rm = _inputs((B, H, W * P, C), 2)
    packed = x.reshape(G * B, H, W, P * C)
    want = _jax(jm._PackedBN(C, groups=G), packed, w, b, lw, rv, rm,
                reshape=lambda a: a.reshape(x.shape))
    _close(_port(x, w, b, lw, rv, rm), want)


def test_grouped_bn_equals_three_serial_calls():
    """One grouped call against three serial ungrouped calls threading
    the running statistics: outputs, gradients and statistics."""
    x, w, b, lw, rv, rm = _inputs((2, 5, 7, 6), 3)
    grouped = _port(x, w, b, lw, rv, rm)
    parts = []
    for g in range(G):
        sl = slice(g * 2, (g + 1) * 2)
        parts.append(_port(x[sl], w, b, lw[sl], rv, rm, groups=1))
        rv, rm = parts[-1]["var"].numpy(), parts[-1]["mean"].numpy()
    want = {"y": torch.cat([p["y"] for p in parts]),
            "dx": torch.cat([p["dx"] for p in parts]),
            "dw": sum(p["dw"] for p in parts),
            "db": sum(p["db"] for p in parts),
            "mean": parts[-1]["mean"], "var": parts[-1]["var"]}
    _close(grouped, want, dict(rtol=1e-6, atol=1e-6))


def test_grouped_bn_context_sets_and_restores_groups():
    m = tm.RefinementModule(32)
    bns = [x for x in m.modules() if isinstance(x, TorchBatchNorm)]
    with grouped_bn(m, 3):
        assert {x.groups for x in bns} == {3}
    assert {x.groups for x in bns} == {1}
    # eval mode normalises with the running statistics whatever the groups
    bn = TorchBatchNorm(4, groups=3).eval()
    x = torch.randn(4, 2, 2, 4)
    torch.testing.assert_close(bn(x), TorchBatchNorm(4).eval()(x))
    with pytest.raises(ValueError, match="3 groups"):
        bn.train()(x)


def test_grouped_uncertainty_module_matches_jax():
    """S = 9: the port's little-image BN in 3 groups against JAX's packed
    BN in 3 groups, train mode: output and running statistics."""
    B, H, W = 3, 4, 5
    rng = np.random.RandomState(4)
    corr = np.abs(rng.randn(B, H, W, 81)).astype(np.float32)
    feat = rng.randn(B, H, W, 32).astype(np.float32)
    prev_u = rng.randn(B, H, W, 1).astype(np.float32)
    prev_f = rng.randn(B, H, W, 2).astype(np.float32)
    args = (corr, feat, prev_u, prev_f)
    jmod = jm.UncertaintyModule(search_size=9, feed_in_previous=True,
                                bn_groups=G)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(
        lambda k, *a: jmod.init(k, *a))(jax.random.PRNGKey(0), *args)))
    want, mut = jmod.apply(variables, *args, train=True,
                           mutable=["batch_stats"])
    port = load_jax_variables(
        tm.UncertaintyModule(9, feed_in_previous=True), variables).train()
    with grouped_bn(port, G):
        got = port(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
    ref = load_jax_variables(tm.UncertaintyModule(9, feed_in_previous=True),
                             {"params": variables["params"],
                              "batch_stats": mut["batch_stats"]})
    for (name, t), (_, r) in zip(port.named_buffers(), ref.named_buffers()):
        np.testing.assert_allclose(t.numpy(), r.numpy(), err_msg=name,
                                   **TOL)
