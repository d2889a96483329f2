"""The port's native host correlation (``refign_tpu_torch/native``, its
own copy of ``correlation.cc`` built with g++ into the package's
``build/``) against the JAX package's ``refign_tpu.native`` (the same
source and flags: bit for bit) and against the local correlation's plain
version (``refign_tpu_torch/ops/correlation.py:local_correlation_reference``
and its autograd), forward and backward, fp32 at 1e-5 of the largest
|value| (sums over C in another order), at P = 9 and a small P = 3 with
odd sizes, so the window reaches past every border.
"""
import os

import numpy as np
import pytest
import torch

from refign_tpu import native as jax_native
from refign_tpu_torch import native
from refign_tpu_torch.ops.correlation import local_correlation_reference

CASES = [(2, 7, 11, 16, 9), (1, 5, 6, 3, 3)]


def _inputs(N, H, W, C, P, seed=0):
    rng = np.random.RandomState(seed)
    t, s = (rng.randn(N, H, W, C).astype(np.float32) for _ in range(2))
    g = rng.randn(N, H, W, P * P).astype(np.float32)
    return t, s, g


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("N,H,W,C,P", CASES)
def test_native_matches_jax_native(N, H, W, C, P):
    t, s, g = _inputs(N, H, W, C, P)
    np.testing.assert_array_equal(native.correlation_forward(t, s, P),
                                  jax_native.correlation_forward(t, s, P))
    for got, want in zip(native.correlation_backward(t, s, g, P),
                         jax_native.correlation_backward(t, s, g, P)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N,H,W,C,P", CASES)
def test_native_matches_the_plain_version(N, H, W, C, P):
    t, s, g = _inputs(N, H, W, C, P, seed=1)
    tt = torch.from_numpy(t).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    out = local_correlation_reference(tt, st, P)
    _close(native.correlation_forward(t, s, P), out.detach().numpy())
    out.backward(torch.from_numpy(g))
    gt, gs = native.correlation_backward(t, s, g, P)
    _close(gt, tt.grad.numpy())
    _close(gs, st.grad.numpy())


def test_library_builds_into_the_package_build_dir():
    native.get_lib()
    path = native._lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.sep + "build" + os.sep in path
    # nothing is written next to the source
    here = os.path.dirname(native.__file__)
    assert sorted(f for f in os.listdir(here)
                  if not f.startswith("__")) == ["correlation.cc"]
