"""The port's MiT backbone (refign_tpu_torch/models/mix_transformer.py)
against the JAX package's, with the JAX weights carried over by
``load_jax_variables``.

mit_b1 has mit_b5's widths and heads (64/128/320/512, 1/2/5/8) at depth 2
per stage.  All four stage outputs at 64^2, fp32, rtol/atol 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.models.mix_transformer import \
    MixVisionTransformer as JaxMiT
from refign_tpu.utils.torch_convert import (check_tree_match,
                                            convert_state_dict)
from refign_tpu_torch.models.mix_transformer import (ARCH_SETTINGS,
                                                     MixVisionTransformer)
from refign_tpu_torch.utils.jax_convert import load_jax_variables


def _perturb(tree, seed, scale=0.02):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + scale * rng.randn(*np.shape(a)).astype(np.float32), tree)


@pytest.fixture(scope="module", params=["mit_b0", "mit_b1"])
def pair(request):
    model_type = request.param
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    jm = JaxMiT(model_type=model_type, drop_path_rate=0.0)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    params = _perturb(jax.tree_util.tree_map(np.asarray,
                                             dict(variables["params"])), 1)
    want = [np.asarray(f) for f in
            jax.jit(jm.apply)({"params": params}, x)]
    tm = MixVisionTransformer(model_type=model_type, drop_path_rate=0.0)
    load_jax_variables(tm, {"params": params, "batch_stats": {}})
    with torch.no_grad():
        got = [f.numpy() for f in tm.eval()(torch.from_numpy(x))]
    return model_type, params, tm, got, want


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_stage_outputs_match_jax(pair, stage):
    model_type, _, _, got, want = pair
    dims = ARCH_SETTINGS[model_type]["embed_dims"]
    side = 64 // (4 * 2 ** stage)
    assert got[stage].shape == (2, side, side, dims[stage])
    np.testing.assert_allclose(got[stage], want[stage], rtol=1e-4,
                               atol=1e-4)


def test_state_dict_converts_to_jax_tree(pair):
    _, params, tm, _, _ = pair
    conv = convert_state_dict(tm.state_dict())
    assert check_tree_match(conv["params"], params) == []
    assert conv["batch_stats"] == {}


def test_init_weights_is_seeded():
    a = MixVisionTransformer("mit_b0")
    b = MixVisionTransformer("mit_b0")
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    w = a.block1[0].attn.q.weight
    assert 0.015 < w.std().item() < 0.025  # Linear init N(0, .02)
