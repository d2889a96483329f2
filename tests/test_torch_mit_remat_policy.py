"""MiT's ``remat_policy='dots'`` in the port
(``refign_tpu_torch/models/mix_transformer.py``, ``nn/layers.py``
``remat_call(policy="dots")``) against plain ``remat`` and against the
JAX backbone's ``remat_policy='dots'``
(``refign_tpu/models/mix_transformer.py:205-240``).

mit_b0, B=2, 64^2, fp32, the weights of ``tests/test_torch_grads.py``'s
``mit_pair`` (its fixture): the four stage outputs and every parameter's
and the input's gradient against JAX's under the same policy at 1e-4
(that file's MiT tolerance); against plain remat, with stochastic depth,
at 1e-6 (the same arithmetic, another schedule).  The recompute keeps the
matrix products' and convolutions' outputs (the backward runs no more mm,
addmm or convolution than without remat) and runs every block's attention and
depthwise conv + GELU (K1's and K2's wrappers) again.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.models.mix_transformer import \
    MixVisionTransformer as JaxMiT
from refign_tpu_torch.config import build_backbone
from refign_tpu_torch.models import mix_transformer as mt
from refign_tpu_torch.models.mix_transformer import MixVisionTransformer
from refign_tpu_torch.utils.jax_convert import (load_jax_variables,
                                                params_like)
from test_torch_grads import MIT_TOL, mit_pair  # noqa: F401  (fixture)

SAVED_OPS = ("aten.mm.default", "aten.addmm.default",
             "aten.convolution.default")


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count[str(func)] = self.count.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def _port(params, x, cots, policy, drop_path_rate=0.0, generator=None,
          remat=True):
    """Outputs, the module (gradients in .grad), the input gradient, and
    the saved-op and kernel-wrapper counts of the backward."""
    tm = MixVisionTransformer("mit_b0", drop_path_rate=drop_path_rate,
                              remat=remat, remat_policy=policy)
    load_jax_variables(tm, {"params": params, "batch_stats": {}})
    calls = {"attention": 0, "dwconv": 0}
    attn, dw = mt.sra_attention, mt.dwconv3x3_gelu

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mt, "sra_attention", count("attention", attn))
        mp.setattr(mt, "dwconv3x3_gelu", count("dwconv", dw))
        xt = torch.from_numpy(x).requires_grad_()
        outs = tm.train()(xt, generator)
        forward_calls = dict(calls)
        loss = sum((o * torch.from_numpy(c)).sum()
                   for o, c in zip(outs, cots))
        with _OpCount() as ops:
            loss.backward()
    backward_calls = {k: calls[k] - forward_calls[k] for k in calls}
    saved = sum(ops.count.get(k, 0) for k in SAVED_OPS)
    return outs, tm, xt.grad, saved, backward_calls


def test_dots_matches_jax_dots(mit_pair):  # noqa: F811
    x, params, cots, _, _ = mit_pair
    jm = JaxMiT(model_type="mit_b0", drop_path_rate=0.0, remat=True,
                remat_policy="dots")

    def loss(params, x):
        outs = jm.apply({"params": params}, x)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, want_outs), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    outs, tm, got_x, _, _ = _port(params, x, cots, "dots")
    for o, w in zip(outs, want_outs):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w),
                                   **MIT_TOL)
    want = params_like(tm, gp)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **MIT_TOL)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(gx), **MIT_TOL)


@pytest.mark.parametrize("drop_path_rate", [0.0, 0.3])
def test_dots_gives_plain_remat_gradients(mit_pair, drop_path_rate):  # noqa: F811
    x, params, cots, _, _ = mit_pair
    _, plain, gx, _, _ = _port(params, x, cots, None, drop_path_rate,
                               torch.Generator().manual_seed(5))
    _, dots, gx_d, _, _ = _port(params, x, cots, "dots", drop_path_rate,
                                torch.Generator().manual_seed(5))
    for (name, p), q in zip(plain.named_parameters(), dots.parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-6, atol=1e-7,
                                   msg=name)
    torch.testing.assert_close(gx_d, gx, rtol=1e-6, atol=1e-7)


def test_dots_keeps_products_and_recomputes_the_kernels(mit_pair):  # noqa: F811
    x, params, cots, _, _ = mit_pair
    blocks = sum(mt.ARCH_SETTINGS["mit_b0"]["depths"])
    _, _, _, saved_none, calls_none = _port(params, x, cots, None)
    _, _, _, saved_dots, calls_dots = _port(params, x, cots, "dots")
    _, _, _, saved_off, calls_off = _port(params, x, cots, None, remat=False)
    # the backward's own products (the gradients) are those without
    # remat; whole-block remat runs each block's products again, dots none
    assert saved_dots == saved_off < saved_none
    # K1's and K2's wrappers run again in both recomputes, not without
    assert calls_none == calls_dots == {"attention": blocks,
                                        "dwconv": blocks}
    assert calls_off == {"attention": 0, "dwconv": 0}


def test_config_passes_the_policy_and_unknown_raises():
    spec = {"class_path": "models.backbones.MixVisionTransformer",
            "init_args": {"model_type": "mit_b0", "remat": True,
                          "remat_policy": "dots"}}
    backbone, _ = build_backbone(spec)
    assert backbone.remat_policy == "dots"
    with pytest.raises(ValueError, match="remat_policy"):
        MixVisionTransformer("mit_b0", remat=True, remat_policy="all")
    # as in JAX, the policy is read only where blocks are rematerialised
    MixVisionTransformer("mit_b0", remat=False, remat_policy="all")
