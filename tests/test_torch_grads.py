"""Gradients of the port against the JAX package.

* K1 and K2's plain versions (``sra_attention_reference``,
  ``dwconv3x3_gelu_reference``), whose autograd is what the CUDA backward
  kernels are held against on the card, against ``jax.vjp`` of the JAX ops
  with the Pallas kernels in interpret mode (their ``custom_vjp``
  backwards), fp32, at 1e-5;
* MiT-b0 parameter and input gradients against ``jax.grad`` of the JAX
  backbone with the same weights and cotangents, fp32, at 1e-4; with
  ``remat`` the port's gradients and drop-path draws are those without it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.models.mix_transformer import \
    MixVisionTransformer as JaxMiT
from refign_tpu.ops.attention import sra_attention as jax_sra_attention
from refign_tpu.ops.dwconv import dwconv3x3_gelu as jax_dwconv3x3_gelu
from refign_tpu.utils.torch_convert import convert_state_dict
from refign_tpu_torch.models.mix_transformer import MixVisionTransformer
from refign_tpu_torch.ops.attention import sra_attention_reference
from refign_tpu_torch.ops.dwconv import dwconv3x3_gelu_reference
from refign_tpu_torch.utils.jax_convert import (load_jax_variables,
                                                params_like)

TOL = dict(rtol=0, atol=1e-5)
MIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


@pytest.mark.parametrize("N,M,H", [(300, 17, 1), (333, 256, 2),
                                   (130, 65, 5)])
def test_attention_plain_grads_match_jax_pallas_vjp(N, M, H):
    B, D = 2, 64
    q, g = _rand(N, B, N, H, D), _rand(N + 1, B, N, H, D)
    kv = _rand(N + 2, B, M, 2, H, D)
    scale = D ** -0.5

    def f(q, k, v):
        return jax_sra_attention(q, k, v, scale, use_pallas=True,
                                 interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(kv[:, :, 0]),
                     jnp.asarray(kv[:, :, 1]))
    want = vjp(jnp.asarray(g))
    qt = torch.from_numpy(q).requires_grad_()
    kvt = torch.from_numpy(kv).requires_grad_()
    # k and v as the two strided halves of one kv tensor, as MiT passes them
    sra_attention_reference(qt, kvt[:, :, 0], kvt[:, :, 1], scale).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(kvt.grad[:, :, 0].numpy(), np.asarray(want[1]),
                               **TOL)
    np.testing.assert_allclose(kvt.grad[:, :, 1].numpy(), np.asarray(want[2]),
                               **TOL)


@pytest.mark.parametrize("C,oihw", [(40, False), (128, True), (256, False)])
def test_dwconv_plain_grads_match_jax_pallas_vjp(C, oihw):
    x = _rand(C, 2, 9, 11, C)
    w = _rand(C + 1, 3, 3, 1, C, scale=0.3)
    b = _rand(C + 2, C, scale=0.1)
    g = _rand(C + 3, 2, 9, 11, C)

    def f(x, w, b):
        return jax_dwconv3x3_gelu(x, w, b, use_pallas=True, interpret=True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, w, b)))
    gx, gw, gb = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    if oihw:
        # the parameter layout of the port's MiT; its gradient comes back
        # in that layout
        wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous() \
            .requires_grad_()
        dwconv3x3_gelu_reference(xt, wt, bt).backward(torch.from_numpy(g))
        got_w = wt.grad.permute(2, 3, 1, 0)
    else:
        wt = torch.from_numpy(w).requires_grad_()
        dwconv3x3_gelu_reference(xt, wt, bt).backward(torch.from_numpy(g))
        got_w = wt.grad
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    # dw and db sum over B*H*W = 198 products of O(1) values
    np.testing.assert_allclose(got_w.numpy(), np.asarray(gw), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), rtol=0,
                               atol=1e-4)


@pytest.fixture(scope="module")
def mit_pair():
    """mit_b0 weights from the port's seeded init with every parameter
    moved off it, as JAX params (``convert_state_dict``, copied), and the
    JAX gradients of the four stage outputs against fixed cotangents."""
    x = _rand(0, 2, 64, 64, 3)
    tm = MixVisionTransformer("mit_b0", drop_path_rate=0.0)
    gen = torch.Generator().manual_seed(1)
    tm.init_weights(gen)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    params = jax.tree_util.tree_map(
        np.array, convert_state_dict(tm.state_dict())["params"])
    jm = JaxMiT(model_type="mit_b0", drop_path_rate=0.0)
    shapes = [(2, 16 >> i, 16 >> i, d)
              for i, d in enumerate(tm.embed_dims)]
    cots = [_rand(10 + i, *shape) for i, shape in enumerate(shapes)]

    def loss(params, x):
        outs = jm.apply({"params": params}, x)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    return x, params, cots, gp, np.asarray(gx)


def _torch_grads(x, params, cots, remat=False, drop_path_rate=0.0,
                 generator=None):
    tm = MixVisionTransformer("mit_b0", drop_path_rate=drop_path_rate,
                              remat=remat)
    load_jax_variables(tm, {"params": params, "batch_stats": {}})
    xt = torch.from_numpy(x).requires_grad_()
    outs = tm.train()(xt, generator)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)
        ).backward()
    return tm, xt.grad


def test_mit_b0_gradients_match_jax(mit_pair):
    x, params, cots, gp, gx = mit_pair
    tm, got_x = _torch_grads(x, params, cots)
    want = params_like(tm, gp)
    assert len(want) == len(list(tm.parameters()))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **MIT_TOL)
    np.testing.assert_allclose(got_x.numpy(), gx, **MIT_TOL)


@pytest.mark.parametrize("drop_path_rate", [0.0, 0.3])
def test_mit_remat_gives_the_same_gradients(mit_pair, drop_path_rate):
    """Recomputing each block in the backward changes neither the
    gradients nor, with stochastic depth, the draws (they are made before
    a block is checkpointed and handed to it)."""
    x, params, cots, _, _ = mit_pair
    plain, gx = _torch_grads(x, params, cots, False, drop_path_rate,
                             torch.Generator().manual_seed(5))
    remat, gx_r = _torch_grads(x, params, cots, True, drop_path_rate,
                               torch.Generator().manual_seed(5))
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-6, atol=1e-7,
                                   msg=name)
    torch.testing.assert_close(gx_r, gx, rtol=1e-6, atol=1e-7)
