"""The port's alignment network (refign_tpu_torch/models/{matching_modules,
vgg}.py, models/heads/uawarpc.py) against the JAX package, with the JAX
weights and non-trivial BN statistics carried over, fp32 at rtol/atol 1e-4.

The uncertainty module runs S = 9 as an ordinary conv and BN on the B*H*W
little 9x9 images where the JAX module runs a Toeplitz matmul and a packed
BN on the same parameters.  The head is held at tests/test_uawarpc.py's
shapes with uncertainty on and off, and with the eval-only iterative
refinement at an out_size of about 1200 on small feature maps.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.models import matching_modules as jm
from refign_tpu.models.heads.uawarpc import UAWarpCHead as JaxHead
from refign_tpu.models.vgg import VGG as JaxVGG
from refign_tpu.utils.torch_convert import (check_tree_match,
                                            convert_state_dict)
from refign_tpu_torch.models import matching_modules as tm
from refign_tpu_torch.models.heads.uawarpc import UAWarpCHead
from refign_tpu_torch.models.vgg import VGG
from refign_tpu_torch.utils.jax_convert import load_jax_variables

TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _perturb_bn(variables, seed):
    """Non-trivial BN: running mean/var and BN scale/bias away from their
    init; conv kernels keep their init so activations stay in range."""
    rng = np.random.RandomState(seed)

    def go(t, path=()):
        if isinstance(t, dict):
            return {k: go(v, path + (k,)) for k, v in t.items()}
        a = np.asarray(t, np.float32)
        noise = 0.1 * rng.randn(*a.shape).astype(np.float32)
        if path[-1] == "var":
            return np.abs(a + noise) + 0.5
        if path[-1] == "mean" or "bn" in path:
            return a + noise
        return a

    return go(variables)


def _init(module, *args, seed=0, **kw):
    variables = jax.jit(lambda k, *a: module.init(k, *a, **kw))(
        jax.random.PRNGKey(seed), *args)
    return _perturb_bn(_np_tree(variables), seed)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_optical_flow_estimator_matches_jax():
    x = _rand(0, 2, 9, 11, 84)
    jmod = jm.OpticalFlowEstimator()
    variables = _init(jmod, x)
    want_map, want_feat = jmod.apply(variables, x)
    port = load_jax_variables(tm.OpticalFlowEstimator(84).eval(), variables)
    with torch.no_grad():
        got_map, got_feat = port(_t(x))
    _close(got_map, want_map)
    _close(got_feat, want_feat)


def test_refinement_module_matches_jax():
    x = _rand(1, 1, 40, 36, 32)  # dilation 16 reaches past the image
    jmod = jm.RefinementModule()
    variables = _init(jmod, x)
    port = load_jax_variables(tm.RefinementModule(32).eval(), variables)
    with torch.no_grad():
        _close(port(_t(x)), jmod.apply(variables, x))


@pytest.mark.parametrize("S,prev", [(9, True), (16, False)])
def test_uncertainty_module_matches_jax(S, prev):
    B, H, W = 2, 5, 7
    corr = np.abs(_rand(2, B, H, W, S * S))
    feat = _rand(3, B, H, W, 32)
    args = [corr, feat]
    if prev:
        args += [_rand(4, B, H, W, 1), _rand(5, B, H, W, 2)]
    jmod = jm.UncertaintyModule(search_size=S, feed_in_previous=prev)
    variables = _init(jmod, *args)
    port = load_jax_variables(
        tm.UncertaintyModule(S, feed_in_previous=prev).eval(), variables)
    with torch.no_grad():
        got = port(*map(_t, args))
    assert got.shape == (B, H, W, 1)
    _close(got, jmod.apply(variables, *args))


def test_vgg16_pyramids_match_jax():
    x = _rand(6, 2, 64, 96, 3)
    jmod = JaxVGG(model_type="vgg16", out_indices=(2, 3, 4))
    variables = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(0), x))
    port = load_jax_variables(VGG("vgg16", out_indices=(2, 3, 4)).eval(),
                              variables)
    for sel in ([-3, -2], [-2, -1]):
        want = jmod.apply(variables, x, extract_only_indices=sel)
        with torch.no_grad():
            got = port(_t(x), extract_only_indices=sel)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _close(g, w)


@pytest.mark.parametrize("model_type", ["vgg16_bn", "vgg19"])
def test_vgg_rejects_other_architectures(model_type):
    """Every configuration of the JAX package's VGG builds (these two
    since UAWarpC training, tests/test_torch_align_train_ops.py holds them
    against JAX); an architecture outside that list is refused."""
    levels = VGG(model_type, out_indices=(2, 3, 4))(torch.zeros(1, 32, 32, 3))
    assert [f.shape[-1] for f in levels] == [128, 256, 512]
    with pytest.raises(ValueError, match="unknown VGG"):
        VGG(model_type.replace("vgg", "resnet"))


def _head_inputs(sizes, seed):
    """Unit-scale pyramids: (trg, src, trg_256, src_256)."""
    (h1, w1), (h2, w2) = sizes
    shapes = [(1, h1, w1, 128), (1, h2, w2, 256), (1, 32, 32, 256),
              (1, 16, 16, 512)]
    feats = [_rand(seed + i, *s) for i, s in enumerate(shapes * 2)]
    return feats[0:2], feats[4:6], feats[2:4], feats[6:8]


def _head_pair(uncertainty, iterative, inputs, out_size):
    jmod = JaxHead(in_index=(0, 1), estimate_uncertainty=uncertainty,
                   iterative_refinement=iterative)
    variables = _init(jmod, *inputs, out_size=out_size, seed=3)
    port = UAWarpCHead(in_index=(0, 1), estimate_uncertainty=uncertainty,
                       iterative_refinement=iterative).eval()
    return jmod, variables, load_jax_variables(port, variables)


def _run_head(jmod, variables, port, inputs, out_size):
    want = jax.jit(lambda v, *a: jmod.apply(v, *a, out_size))(
        variables, *inputs)
    with torch.no_grad():
        got = port(*[[_t(a) for a in lvl] for lvl in inputs], out_size)
    return got, want


@pytest.mark.parametrize("uncertainty", [True, False])
def test_uawarpc_head_matches_jax(uncertainty):
    out_size = (64, 96)
    if uncertainty:
        inputs, jmod, variables, port = _default_head()
    else:
        inputs = _head_inputs([(16, 24), (8, 12)], seed=10)
        jmod, variables, port = _head_pair(False, False, inputs, out_size)
    got, want = _run_head(jmod, variables, port, inputs, out_size)
    assert len(got) == len(want) == 4
    for lvl, (g, w) in enumerate(zip(got, want)):
        if uncertainty:
            (gf, gu), (wf, wu) = g, w
            assert gu.dtype == torch.float32
            _close(gu, wu)
        else:
            gf, wf = g, w
        assert gf.dtype == torch.float32 and gf.shape == wf.shape
        _close(gf, wf)


def test_uawarpc_head_iterative_refinement_matches_jax():
    """out_size 1200x1000: n_extra = round(log2(1200/8/32/3)) = 1 extra
    level at 1/16 of the image, through decoder2 and the level-2
    uncertainty module; the feature maps are small (the head only reads
    their sizes and out_size)."""
    inputs = _head_inputs([(20, 16), (10, 8)], seed=20)
    out_size = (1200, 1000)
    jmod, variables, port = _head_pair(True, True, inputs, out_size)
    got, want = _run_head(jmod, variables, port, inputs, out_size)
    for (gf, gu), (wf, wu) in zip(got, want):
        _close(gf, wf)
        _close(gu, wu)
    # level 3 ends at the extra level's 75x62 grid, and it moves level 2
    assert got[1][0].shape == (1, 75, 62, 2)
    plain = UAWarpCHead(iterative_refinement=False).eval()
    plain.load_state_dict(port.state_dict())
    with torch.no_grad():
        flat = plain(*[[_t(a) for a in lvl] for lvl in inputs], out_size)
    assert not torch.allclose(flat[2][0], got[2][0], atol=1e-3)


@functools.lru_cache(maxsize=None)
def _default_head():
    inputs = _head_inputs([(16, 24), (8, 12)], seed=10)
    return (inputs,) + _head_pair(True, False, inputs, (64, 96))


@pytest.mark.parametrize("collection", ["params", "batch_stats"])
def test_head_state_dict_converts_to_jax_tree(collection):
    _, _, variables, port = _default_head()
    conv = convert_state_dict(port.state_dict())
    assert check_tree_match(conv[collection], variables[collection]) == []


def test_vgg_state_dict_converts_to_jax_tree():
    x = np.zeros((1, 32, 32, 3), np.float32)
    variables = jax.jit(JaxVGG(model_type="vgg16", out_indices=(2, 3, 4))
                        .init)(jax.random.PRNGKey(0), x)
    conv = convert_state_dict(VGG("vgg16", out_indices=(2, 3, 4))
                              .state_dict())
    assert check_tree_match(conv["params"], variables["params"]) == []
