"""Grouped BatchNorm and the folded UAWarpC step under a process group:
2 gloo ranks on the CPU against one process on the global batch
(``tests/torch_dist_ranks.py:grouped_case``).

* ``TorchBatchNorm`` in 3 groups (``grouped_bn``), each rank holding its
  rows of every group stacked group by group (the folded step's layout):
  the output, the running statistics (three updates in group order from
  each group's statistics averaged over the ranks, the unbiased count the
  global one), the input and parameter gradients, at sync-BN's 1e-6
  (``tests/test_torch_dist_layers.py``); behind a conv under
  ``remat_call``, whose recompute replays the (3, C) statistics: one
  reduction in the forward, one in the backward, one gradient bucket.
* The tiny UAWarpC step (``tests/test_torch_dist_align.py``'s) with
  ``fold_passes`` and with ``remat_head`` ('dots'), one step: the losses
  and gradients against one process's folded step at that file's rule
  (losses 1e-5; gradients 1e-4 + 5x one process's one-ulp floor over all
  parameters and for the median one), every parameter equal on both
  ranks, and no more collectives than the serial step makes.
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from test_torch_dist_align import FLOOR_ADD, FLOOR_X, _grad_errors
from test_torch_dist_layers import REL, _close

WORLD = 2
G = R.GBN_GROUPS


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.spawn(R.grouped_case, WORLD,
                   str(tmp_path_factory.mktemp("grouped")))


@pytest.fixture(scope="module")
def single():
    return {"fold": R.align_steps(**R.FOLD_OPTS),
            "floor": R.align_steps(move_backbone=1, **R.FOLD_OPTS)}


def _global(outs, key, name):
    """The ranks' rows (each rank: its rows of group 0, 1, 2) back in the
    global batch's group-major order."""
    parts = [o[key][name].unflatten(0, (G, -1)) for o in outs]
    return torch.cat(parts, dim=1).flatten(0, 1)


@pytest.mark.parametrize("remat", [False, True])
def test_grouped_sync_bn_matches_one_process(ranks, remat):
    key = "gbn_remat" if remat else "gbn"
    single = R.gbn_run(None, remat=remat)
    _close(_global(ranks, key, "y"), single["y"], what="output")
    _close(_global(ranks, key, "dx") / WORLD, single["dx"], what="dx")
    grads = [k for k in single if k.startswith("d") and k != "dx"]
    scale = max(float(single[k].abs().max()) for k in grads)
    for o in ranks:
        for k in ("mean", "var"):
            _close(o[key][k], single[k], what=k)
        for k in grads:
            _close(o[key][k], single[k], what=k, scale=scale)
    # three groups' updates moved the statistics, each group its own
    assert float((single["var"] - 1).abs().max()) > 1e-2


def test_grouped_remat_reduces_once_each_way(ranks):
    assert all(o["gbn_remat_collectives"] == 3 for o in ranks)


@pytest.mark.parametrize("run", ["fold", "remat_head"])
def test_folded_and_remat_head_steps_match_one_process(ranks, single, run):
    want = single["fold"]
    floor_all, floor_med = _grad_errors(single["floor"]["grads"],
                                        want["grads"])
    assert floor_all < 1e-3
    for o in ranks:
        got = o[run]
        for k, v in want["logs"][0].items():
            np.testing.assert_allclose(got["logs"][0][k], v, rtol=1e-5,
                                       err_msg=k)
        err_all, err_med = _grad_errors(got["grads"], want["grads"])
        assert err_all <= FLOOR_ADD + FLOOR_X * floor_all
        assert err_med <= FLOOR_ADD + FLOOR_X * floor_med
        assert got["divergence"] == 0.0
        assert got["collectives"] <= o["serial"]["collectives"]

