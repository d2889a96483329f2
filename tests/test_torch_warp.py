"""The port's warp ops (refign_tpu_torch/ops/warp.py) against the JAX
package, fp32 at atol 1e-5; grid_sample also keeps a bf16 input's dtype."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
from refign_tpu.ops import warp as jw
from refign_tpu_torch.ops import warp as tw

TOL = dict(rtol=0, atol=1e-5)


def _flow(B, H, W, seed, scale=3.0):
    return (scale * np.random.RandomState(seed).randn(B, H, W, 2)
            ).astype(np.float32)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_matches_jax(align_corners, padding_mode):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 13, 5).astype(np.float32)
    # coordinates reach outside [-1, 1] so both padding rules are exercised
    grid = rng.uniform(-1.3, 1.3, (2, 7, 11, 2)).astype(np.float32)
    want = np.asarray(jw.grid_sample(jnp.asarray(x), jnp.asarray(grid),
                                     align_corners, padding_mode))
    got = tw.grid_sample(torch.from_numpy(x), torch.from_numpy(grid),
                         align_corners, padding_mode)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got_bf16 = tw.grid_sample(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(grid), align_corners,
                              padding_mode)
    assert got_bf16.dtype == torch.bfloat16


def test_grid_sample_rejects_reflection():
    with pytest.raises(ValueError):
        tw.grid_sample(torch.zeros(1, 2, 2, 1), torch.zeros(1, 2, 2, 2),
                       padding_mode="reflection")


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_warp_and_mask_match_jax(padding_mode):
    x = np.random.RandomState(1).randn(2, 12, 15, 6).astype(np.float32)
    flow = _flow(2, 12, 15, seed=2)
    want, want_mask = jw.warp(jnp.asarray(x), jnp.asarray(flow),
                              padding_mode, return_mask=True)
    got, mask = tw.warp(torch.from_numpy(x), torch.from_numpy(flow),
                        padding_mode, return_mask=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert 0 < mask.float().mean() < 1


def test_warp_does_not_short_circuit_zero_flow():
    """An all-zero flow still samples and masks (the strict mask drops the
    border rows and columns), as in the JAX version."""
    x = torch.randn(1, 4, 5, 3)
    out, mask = tw.warp(x, torch.zeros(1, 4, 5, 2), return_mask=True)
    torch.testing.assert_close(out, x, rtol=0, atol=1e-6)
    want = torch.zeros(1, 4, 5, dtype=torch.bool)
    want[:, 1:-1, 1:-1] = True
    assert torch.equal(mask, want)


def test_flow_helpers_match_jax():
    flow = _flow(2, 6, 8, seed=3)
    nmap = np.random.RandomState(4).uniform(-1, 1, (2, 6, 8, 2)).astype(
        np.float32)
    logvar = np.random.RandomState(5).randn(2, 6, 8, 1).astype(np.float32)
    jf, tf = jnp.asarray(flow), torch.from_numpy(flow)
    pairs = [
        (jw.flow_to_mapping(jf), tw.flow_to_mapping(tf)),
        (jw.mapping_to_flow(jf), tw.mapping_to_flow(tf)),
        (jw.unnormalize_mapping_to_flow(jnp.asarray(nmap)),
         tw.unnormalize_mapping_to_flow(torch.from_numpy(nmap))),
        (jw.confidence_from_logvar(jnp.asarray(logvar), R=1.0),
         tw.confidence_from_logvar(torch.from_numpy(logvar), R=1.0)),
        (jw.confidence_from_logvar(jnp.asarray(logvar), R=3.0),
         tw.confidence_from_logvar(torch.from_numpy(logvar), R=3.0)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        tw.gt_correspondence_mask(tf).numpy(),
        np.asarray(jw.gt_correspondence_mask(jf)))
