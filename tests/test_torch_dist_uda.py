"""The port's data-parallel Refign-HRDA train step on 2 gloo ranks on the
CPU, against one process on the global batch
(``tests/test_torch_dist_uda_jax.py`` holds it against JAX's step on a
2-device mesh).

The tiny step (``tests/torch_dist_ranks.py``): mit_b0 with drop path 0.1
and remat, DAFormer and the SegFormer scale attention at 32 channels with
dropout 0.1, the frozen VGG-11 + UAWarpC, 64^2, the feature distance on
(the first image all of one of its classes), DACS with colour jitter and
blur, AdamW at 6e-4 without warmup, fp32; every draw made by every rank
for the global batch.  The cases: global B = 4 + 4 for two steps, the
first on the refine branch and the second with the reference as target;
and one step each of the halved source of
``ignore_every_second_semantic_training_batch`` (2 source rows, 1 + 1,
for 2 targets), the semi-supervised source before halving (4 source rows
for 2 targets, so DACS pairs a rank's target with a source row another
rank holds), and 3 source rows, which the world size does not divide and
every rank holds whole.

Tolerances: each rank's logs (the global values) 1e-5 relative to one
process's.  Every step's gradients 1e-5 relative L2 over all parameters
together and for the median parameter, and each parameter's 1e-5 + 5x
its own noise floor: its movement when one process's images move by one
ulp in random directions (the ``floor`` run), each error taken relative
to the gradient's norm or to a thousandth of the RMS parameter gradient
norm, whichever is larger (``chip_smoke.py:compare_step``'s floor: a
bias before a batch-statistics BatchNorm has a zero gradient in exact
arithmetic).  The parameters and the teacher after the steps: 1e-5 of the
largest entry of their group; an entry whose reference gradient lies
within its parameter's noise (the floor run's largest change of that
gradient) at some step may also differ by 2 lr a step, since Adam's first
updates are ~sign(g) lr and rounding can move such a gradient across
zero.  Every parameter equal on every rank.
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as R

REL = 1e-5
GRAD_ALL = 1e-5
GRAD_MEDIAN = 1e-5
GRAD_PARAM, FLOOR_X = 1e-5, 5.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.spawn(R.uda_case, 2, str(tmp_path_factory.mktemp("uda")))


@pytest.fixture(scope="module")
def single():
    return {name: R.uda_steps(case) for name, case in R.UDA_CASES.items()}


@pytest.fixture(scope="module")
def floor():
    return {name: R.uda_steps(case, floor=True)
            for name, case in R.UDA_CASES.items()}


def _group(name):
    return "stats" if name.endswith(("running_mean", "running_var")) \
        else name.split(".")[0]


def _close_by_group(got, want, rel, what, flip=None):
    """Every entry within ``rel`` of the largest entry of its group, or,
    where ``flip`` (by name: an allowance and a mask) marks it, within
    that allowance more."""
    scale = {}
    for k, v in want.items():
        if v.is_floating_point():
            g = _group(k)
            scale[g] = max(scale.get(g, 0.0), float(v.abs().max()))
    for k, v in want.items():
        if not v.is_floating_point():
            assert torch.equal(got[k], v), (what, k)
            continue
        limit = torch.full_like(v, rel * scale[_group(k)])
        if flip and k in flip:
            allow, mask = flip[k]
            limit = limit + allow * mask
        err = (got[k] - v).abs()
        assert bool((err <= limit).all()), (what, k, float(err.max()))


@pytest.mark.parametrize("case", list(R.UDA_CASES))
def test_logs_match_one_process(ranks, single, case):
    for o in ranks:
        for got, want in zip(o[case]["logs"], single[case]["logs"]):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=REL,
                                           atol=1e-7, err_msg=k)
    assert single[case]["logs"][0]["train_loss_featdist_src"] > 1e-4


def _rel_l2(got, want, keys):
    num = sum(float((got[k] - want[k]).double().norm()) ** 2 for k in keys)
    den = sum(float(want[k].double().norm()) ** 2 for k in keys)
    return (num / den) ** 0.5


def _per_param(got, want):
    """Each parameter's gradient error relative to its norm or to a
    thousandth of the RMS parameter gradient norm, whichever is larger."""
    norms = {k: float(v.double().norm()) for k, v in want.items()}
    rms = (sum(n * n for n in norms.values()) / len(norms)) ** 0.5
    return {k: float((got[k] - want[k]).double().norm())
            / max(norms[k], 1e-3 * rms) for k in want}


@pytest.mark.parametrize("case", list(R.UDA_CASES))
def test_gradients_match_one_process(ranks, single, floor, case):
    for step, want in enumerate(single[case]["grads"]):
        noise = _per_param(floor[case]["grads"][step], want)
        for o in ranks:
            got = o[case]["grads"][step]
            assert got.keys() == want.keys()
            zero = [k for k in want if not want[k].any()]
            assert all(not got[k].any() for k in zero)
            per = sorted(_rel_l2(got, want, [k]) for k in want
                         if k not in zero)
            assert _rel_l2(got, want, list(want)) <= GRAD_ALL
            assert per[len(per) // 2] <= GRAD_MEDIAN
            for k, err in _per_param(got, want).items():
                assert err <= GRAD_PARAM + FLOOR_X * noise[k], (step, k, err)


def _near_zero(single, floor):
    """By parameter name: the entries whose reference gradient lies within
    that gradient's noise (the floor run's largest change of it) at some
    step."""
    out = {}
    for want, moved in zip(single["grads"], floor["grads"]):
        for k, g in want.items():
            noise = float((moved[k] - g).abs().max())
            near = g.abs() <= noise
            out[k] = out[k] | near if k in out else near
    return out


@pytest.mark.parametrize("case", list(R.UDA_CASES))
def test_parameters_match_one_process(ranks, single, floor, case):
    steps = R.UDA_CASES[case].get("steps", 1)
    near = _near_zero(single[case], floor[case])
    # Adam's first updates are ~sign(g) lr: a gradient entry that rounding
    # moves across zero moves its parameter by up to 2 lr a step
    flip = {k: (2 * R.UDA_LR * steps, m.float()) for k, m in near.items()}
    for o in ranks:
        for what in ("state", "teacher"):
            _close_by_group(o[case][what], single[case][what], REL, what,
                            flip)


@pytest.mark.parametrize("case", list(R.UDA_CASES))
def test_every_rank_holds_the_same_parameters(ranks, case):
    a, b = ranks
    assert a[case]["divergence"] == 0.0
    for k, v in a[case]["state"].items():
        assert torch.equal(v, b[case]["state"][k]), k


