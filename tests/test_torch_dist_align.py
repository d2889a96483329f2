"""The port's data-parallel UAWarpC stage-1 train step on 2 gloo ranks on
the CPU against one process on the global batch.

The tiny step (``tests/torch_dist_ranks.py``): the frozen VGG-11 and the
UAWarpC head with uncertainty in train-mode BatchNorm (sync-BN across the
ranks), the stage-1 prime view (photometric augmentations, a synthetic
flow) on 80^2 uint8 pairs cropped to 64^2, global B = 4 (2 + 2), fp32,
Adam; every draw made by every rank for the global batch.  Two steps with
``remat_modules`` on and one with it off (the recompute replays the
statistics its forward reduced: the same collectives either way).

Tolerances, the method of ``tests/test_torch_align_train_step.py``: the
head's train-mode BatchNorm on near-uniform correlation volumes amplifies
fp32 rounding, so the gradients are held against one process's own
movement when the frozen weights move by one ulp in random directions
(the noise floor): 1e-4 + 5x the floor in relative L2 over all parameters
together and for the median parameter; the losses 1e-5 relative after
the first step and 1e-4 after the second (the adaptive weight and the
visibility threshold carry the rounding), the BN statistics after two
steps 1e-4 of the largest entry of their kind (the limit that file sets
after three steps), and every parameter equal on every rank.
"""
import statistics

import numpy as np
import pytest
import torch

import torch_dist_ranks as R

FLOOR_ADD, FLOOR_X = 1e-4, 5.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.spawn(R.align_case, 2, str(tmp_path_factory.mktemp("align")))


@pytest.fixture(scope="module")
def single():
    return {"remat": R.align_steps(steps=2),
            "floor": R.align_steps(move_backbone=1)}


def _rel(got, want, keys):
    num = sum(float((got[k] - want[k]).double().norm()) ** 2 for k in keys)
    den = sum(float(want[k].double().norm()) ** 2 for k in keys)
    return (num / den) ** 0.5


def _grad_errors(got, want):
    keys = [k for k in want if want[k].any()]
    return (_rel(got, want, keys),
            statistics.median(_rel(got, want, [k]) for k in keys))


@pytest.mark.parametrize("run", ["remat", "no_remat"])
def test_first_step_matches_one_process(ranks, single, run):
    want = single["remat"]
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


def test_remat_adds_no_collective(ranks):
    # the recompute replays the statistics its forward reduced: as many
    # all_reduce calls with remat_modules as without
    for o in ranks:
        assert o["remat"]["collectives"] == o["no_remat"]["collectives"] > 0


def test_two_steps_match_and_ranks_agree(ranks, single):
    want = single["remat"]
    for o in ranks:
        for got_l, want_l, tol in zip(o["remat"]["logs"], want["logs"],
                                      (1e-5, 1e-4)):
            for k, v in want_l.items():
                np.testing.assert_allclose(got_l[k], v, rtol=tol, err_msg=k)
        assert o["remat"]["divergence"] == 0.0
        for kind in ("running_mean", "running_var"):
            keys = [k for k in want["state"] if k.endswith(kind)]
            scale = max(float(want["state"][k].abs().max()) for k in keys)
            for k in keys:
                err = float((o["remat"]["state"][k]
                             - want["state"][k]).abs().max())
                assert err <= 1e-4 * scale, k
    a, b = ranks
    for k, v in a["remat"]["state"].items():
        assert torch.equal(v, b["remat"]["state"][k]), k
