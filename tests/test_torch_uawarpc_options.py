"""The UAWarpC head's options in the port
(``refign_tpu_torch/models/heads/uawarpc.py``) against the JAX head
(``refign_tpu/models/heads/uawarpc.py:57-67``): ``batch_norm``,
``refinement_at_adaptive_res`` and ``refinement_at_finest_level`` each
False, and JAX's ``bn_groups=3`` against the port's head under
``grouped_bn(head, 3)``.

The JAX head's weights (BN statistics and affine moved off their init)
are carried into the port's; the forward in eval mode and in train mode
(batch statistics, and the running statistics it leaves), every level's
flow and log-variance, fp32 at ``tests/test_torch_matching.py``'s 1e-4
(in train mode the absolute part of each array's largest |value|, as
batch-statistics BatchNorm amplifies fp32 rounding: a flow of ~50 pixels
moved 1.3e-4 in the grouped head).
A module the flag turns off has no parameters on either side.  In 3
groups the batch stacks three calls' rows, and the head's output and
statistics are those of JAX's grouped head; ``config.py``'s
``build_head`` passes the three flags through.
"""
import jax
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.models.heads.uawarpc import UAWarpCHead as JaxHead
from refign_tpu_torch.config import build_head
from refign_tpu_torch.models.heads.uawarpc import UAWarpCHead
from refign_tpu_torch.nn.layers import grouped_bn
from refign_tpu_torch.utils.jax_convert import load_jax_variables
from test_torch_matching import _init, _rand, _t

OUT_SIZE = (64, 96)
FLAGS = ("batch_norm", "refinement_at_adaptive_res",
         "refinement_at_finest_level")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, seed):
    """Pyramids (trg, src, trg_256, src_256) for a 64x96 image."""
    shapes = [(B, 16, 24, 128), (B, 8, 12, 256), (B, 32, 32, 256),
              (B, 16, 16, 512)]
    feats = [_rand(seed + i, *s) for i, s in enumerate(shapes * 2)]
    return feats[0:2], feats[4:6], feats[2:4], feats[6:8]


def _pair(B, seed, bn_groups=1, **opts):
    inputs = _inputs(B, seed)
    jmod = JaxHead(in_index=(0, 1), estimate_uncertainty=True,
                   bn_groups=bn_groups, **opts)
    variables = _init(jmod, *inputs, out_size=OUT_SIZE, seed=3)
    port = load_jax_variables(UAWarpCHead(in_index=(0, 1), **opts),
                              variables)
    return inputs, jmod, variables, port


def _compare(got, want, scaled=False):
    """Each level's flow and log-variance; ``scaled``: atol of the
    array's largest |value| (train mode, where BatchNorm on the batch's
    statistics amplifies fp32 rounding)."""
    assert len(got) == len(want) == 4
    for (gf, gu), (wf, wu) in zip(got, want):
        assert gf.shape == wf.shape
        for g, w in ((gf, wf), (gu, wu)):
            w = np.asarray(w)
            scale = max(1.0, float(np.abs(w).max())) if scaled else 1.0
            np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                       atol=1e-4 * scale)


def _train(jmod, variables, port, inputs):
    want, mut = jax.jit(lambda v, *a: jmod.apply(
        v, *a, OUT_SIZE, train=True, mutable=["batch_stats"]))(
            variables, *inputs)
    got = port.train()(*[[_t(a) for a in lvl] for lvl in inputs], OUT_SIZE)
    _compare(got, want, scaled=True)
    ref = load_jax_variables(UAWarpCHead(
        in_index=(0, 1), **{k: v for k, v in jmod.__dict__.items()
                            if k in FLAGS}),
        {"params": variables["params"],
         "batch_stats": mut.get("batch_stats", {})})
    for (name, t), (_, r) in zip(port.named_buffers(), ref.named_buffers()):
        np.testing.assert_allclose(t.numpy(), r.numpy(), err_msg=name,
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("flag", FLAGS)
def test_head_flag_off_matches_jax(flag):
    inputs, jmod, variables, port = _pair(2, 40, **{flag: False})
    names = {n.split(".")[0] for n, _ in port.named_parameters()}
    if flag == "batch_norm":
        assert not any("bn" in n for n, _ in port.named_parameters())
        assert not list(port.buffers())
    else:
        module = {"refinement_at_adaptive_res": "refinement_module_adaptive",
                  "refinement_at_finest_level": "refinement_module_finest"}
        assert module[flag] not in names
        assert set(variables["params"]) == names
    with torch.no_grad():
        want = jax.jit(lambda v, *a: jmod.apply(v, *a, OUT_SIZE))(
            variables, *inputs)
        _compare(port.eval()(*[[_t(a) for a in lvl] for lvl in inputs],
                             OUT_SIZE), want)
        _train(jmod, variables, port, inputs)


def test_grouped_head_matches_jax_grouped_head():
    inputs, jmod, variables, port = _pair(3, 50, bn_groups=3)
    with torch.no_grad(), grouped_bn(port, 3):
        _train(jmod, variables, port, inputs)


def test_build_head_passes_the_flags():
    spec = {"class_path": "models.heads.UAWarpCHead",
            "init_args": {"batch_norm": False,
                          "refinement_at_adaptive_res": False,
                          "refinement_at_finest_level": False}}
    head, _ = build_head(spec)
    assert head.refinement_module_adaptive is None
    assert head.refinement_module_finest is None
    assert not list(head.buffers())
