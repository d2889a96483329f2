"""The port's UAWarpC train step (refign_tpu_torch/alignment/trainer.py)
against the JAX ``make_align_train_step``.

vgg11 (the JAX align tests' backbone) + UAWarpC with uncertainty, B=2,
64^2 images (and the fixed 256^2 small pyramid), fp32, three head passes,
the warp-supervision and W-bipath losses with the visibility mask (the
stage-2 losses), the adaptive weights, Adam with L2 decay and MultiStepLR.
Both sides start from the port's seeded init, carried to JAX by the JAX
package's ``convert_state_dict``, and consume the SAME fixed prime data:
JAX draws it inside its step, so its ``prepare_alignment_batch`` is
monkeypatched to return it, as ``tests/test_align_trajectory_golden.py``
does, and so is the port's (the prime view itself is held in
``tests/test_torch_align_train_prime.py``).  One JAX step function serves
every test: its optimizer keeps the gradient it was given in its state,
then applies Adam.

* the first step: the three losses, every head parameter's gradient
  against the JAX step's own ``jax.grad``, and the BN running statistics,
  with ``remat_modules`` on and off (which must leave the gradients and
  update the statistics once per pass);
* 3 steps: the losses, the parameter sq-norm trace, the final parameters
  and BN statistics;
* the JAX state after 2 steps carried into a fresh port trainer
  (``load_align_state``: head, backbone, Adam moments and count, step)
  takes step 3 as the JAX step does;
* a fourth step under the port's ``utils/profiling.Recorder`` records
  the step's phase spans in order.

The trajectory runs at lr 1e-6 and wd 0.1, as the JAX golden does, and for
its reason (``tests/test_align_trajectory_golden.py:9-18``): at the
stage's lr the W-bipath NLL with its ~100x adaptive weight and the hard
visibility threshold make the trajectory chaotic, so a 1e-7 forward
difference flips Adam's update signs and by step 2 the losses differ by
percents; at 1e-6 it stays linear while wd 0.1 dominates most gradients.
The first step's gradients are compared as they are, whatever the rate.

The images are smooth random fields (bicubic upsampling of 4x4 noise,
plus a little pixel noise).  Pixel noise alone through the random VGG
gives a level-4 correlation volume within ~4 % of uniform across
positions; the head's train-mode BatchNorm then normalises near-constant
inputs and amplifies fp32 rounding, so that JAX's own gradient moves by
1e-4 (all parameters, relative L2) when the frozen weights move by one
ulp, and single parameters by up to 5e-2 between the two frameworks.

Tolerances: the first step's losses 1e-5 relative or 5x what the same
JAX step from the frozen weights moved by one ulp moves them by, whichever
is larger (the gradients' rule, below; the reading on the CPU, port
against JAX and JAX's own floor: train_matching_loss 1.25e-5 against
5.01e-6, loss_ss 9.6e-8 against 3.8e-7, loss_us 1.42e-5 against 5.53e-6:
the weighted sum carries loss_us's 100x adaptive weight, and the port's
error lies within 2.6x the floor on every loss); the later steps' 1e-4
(the 100x adaptive weight and the hard visibility threshold carry the
rounding through the steps); the gradients against what fp32 rounding
alone does to JAX's own: the same JAX step from the frozen weights moved
by one ulp in random directions gives each parameter's noise floor, and
the port's error, relative L2, must stay within 1e-4 + 5x the floor over
all parameters together and for the median parameter, and within 3e-2 for
every one (the reading on the CPU: 2.1e-4 against a floor of 4.6e-4 over
all; 1e-2 at most, in the finest level's decoder and its feature skip,
where a pixel's hard visibility threshold falls differently on the two
sides); BN statistics 1e-5 / 1e-6 after the first step, 1e-4 / 1e-5
after three; parameters after the trajectory 8 lr (Adam's early updates
are ~sign(g) lr, so a sign that rounding flips moves an entry by up to
2 lr a step).
"""
import copy
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
import refign_tpu.alignment.trainer as jax_trainer
from refign_tpu.models.heads.uawarpc import UAWarpCHead as JaxUAWarpC
from refign_tpu.models.vgg import VGG as JaxVGG
from refign_tpu.train.optim import make_adam_optimizer as jax_adam
from refign_tpu.utils.torch_convert import convert_state_dict
from refign_tpu_torch.alignment import trainer as port_trainer
from refign_tpu_torch.alignment.trainer import (AlignConfig, AlignTrainer,
                                                forward_backward,
                                                init_align_state, train_step)
from refign_tpu_torch.models.heads.uawarpc import UAWarpCHead
from refign_tpu_torch.models.vgg import VGG
from refign_tpu_torch.train.optim import make_adam_optimizer
from refign_tpu_torch.utils.jax_convert import (load_align_state,
                                                load_jax_variables,
                                                params_like)
from refign_tpu_torch.utils.profiling import Recorder

B, H, W = 2, 64, 64
LR, WD, MILESTONES = 1e-6, 0.1, (2,)
N_STEPS = 3
LOSS_RTOL, LATER_LOSS_RTOL = 1e-5, 1e-4
GRAD_FLOOR, NOISE_X, GRAD_MAX = 1e-4, 5.0, 3e-2
STAT_TOL = dict(rtol=1e-5, atol=1e-6)
LATER_STAT_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL = 8 * LR
LOG_KEYS = ("train_matching_loss", "loss_ss", "loss_us")


def _smooth_images(rng):
    lo = torch.from_numpy(rng.randn(B, 3, 4, 4).astype(np.float32))
    img = F.interpolate(lo, (H, W), mode="bicubic", align_corners=False)
    return (img.permute(0, 2, 3, 1).numpy()
            + 0.1 * rng.randn(B, H, W, 3).astype(np.float32))


def _prime_np():
    rng = np.random.RandomState(11)
    return {
        "image_ref": _smooth_images(rng),
        "image_trg": _smooth_images(rng),
        "image_prime": _smooth_images(rng),
        "flow_prime": rng.randn(B, H, W, 2).astype(np.float32) * 2.0,
        "mask_prime": rng.rand(B, H, W) > 0.2,
        "prime_trg_idx": np.array([0, 1], np.int32),
    }


def _port_nets(remat_modules=False, seed=3):
    backbone = VGG("vgg11", out_indices=(2, 3, 4))
    head = UAWarpCHead(in_index=(0, 1), estimate_uncertainty=True,
                       remat_modules=remat_modules)
    gen = torch.Generator().manual_seed(seed)
    backbone.init_weights(gen)
    head.init_weights(gen)
    return backbone, head


def _port_trainer(remat_modules=False, seed=3):
    backbone, head = _port_nets(remat_modules, seed)
    opt, sched = make_adam_optimizer(head.parameters(), LR, MILESTONES,
                                     gamma=0.5, weight_decay=WD)
    cfg = AlignConfig(visibility_mask=True, compute_dtype="float32",
                      remat_modules=remat_modules)
    return AlignTrainer(cfg, init_align_state(backbone, head, opt, sched))


def _grad_capture():
    """Passes the gradient on and keeps it as its state."""
    def init(params):
        return {"g": jax.tree_util.tree_map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return grads, {"g": grads}

    return optax.GradientTransformation(init, update)


def _jax_tx():
    adam, _ = jax_adam(LR, MILESTONES, gamma=0.5, weight_decay=WD)
    return optax.chain(_grad_capture(), adam)


def _jax_state(tx):
    backbone, head = _port_nets()
    bb = convert_state_dict(backbone.state_dict())
    hd = convert_state_dict(head.state_dict())
    tree = jax.tree_util.tree_map(np.array, (bb["params"], hd))
    return jax_trainer.init_align_state(tree[1], tree[0], tx)


def _jax_step(tx, prime):
    """The JAX step, jitted, with the fixed prime data injected (the
    monkeypatch holds while the step is traced)."""
    fixed = {k: jnp.asarray(prime[k]) for k in
             ("image_prime", "flow_prime", "mask_prime", "prime_trg_idx")}
    cfg = jax_trainer.AlignConfig(visibility_mask=True,
                                  compute_dtype="float32")
    backbone = JaxVGG(model_type="vgg11", out_indices=(2, 3, 4))
    head = JaxUAWarpC(in_index=(0, 1), estimate_uncertainty=True)
    step = jax.jit(jax_trainer.make_align_train_step(backbone, head, tx, cfg))
    batch = {"image_ref": jnp.asarray(prime["image_ref"]),
             "image_trg": jnp.asarray(prime["image_trg"])}

    def run(state, key):
        mp = pytest.MonkeyPatch()
        mp.setattr(jax_trainer, "prepare_alignment_batch",
                   lambda *a, **k: dict(fixed))
        try:
            state, logs = step(state, batch, key)
        finally:
            mp.undo()
        return state, {k: float(v) for k, v in logs.items()}

    return run


def _port_batch(prime):
    return {k: torch.from_numpy(prime[k]) for k in ("image_ref",
                                                    "image_trg")}


def _with_fixed_prime(prime, fn):
    fixed = {k: torch.from_numpy(np.asarray(prime[k])) for k in
             ("image_prime", "flow_prime", "mask_prime", "prime_trg_idx")}
    mp = pytest.MonkeyPatch()
    mp.setattr(port_trainer, "prepare_alignment_batch",
               lambda *a, **k: dict(fixed))
    try:
        return {k: float(v) for k, v in fn().items()}
    finally:
        mp.undo()


def _stats(head):
    return {n: b.detach().clone() for n, b in head.named_buffers()}


def _grads(head):
    return {n: p.grad.detach().clone() for n, p in head.named_parameters()}


def _sq_norm(head):
    return sum(float((p.detach().double() ** 2).sum())
               for p in head.parameters())


def _jax_head(state):
    """A port head holding a JAX state's head parameters and statistics."""
    ref = UAWarpCHead(in_index=(0, 1), estimate_uncertainty=True)
    load_jax_variables(ref, {"params": state.params,
                             "batch_stats": state.batch_stats})
    return ref


@pytest.fixture(scope="module")
def run():
    prime = _prime_np()
    tx = _jax_tx()
    step = _jax_step(tx, prime)
    state = _jax_state(tx)
    ref = _port_nets()[1]
    out = dict(states=[state], jax_logs=[], jax_norms=[])
    for i in range(N_STEPS):
        state, logs = step(state, jax.random.PRNGKey(i))
        out["states"].append(state)
        out["jax_logs"].append(logs)
        out["jax_norms"].append(sum(
            float(jnp.sum(jnp.square(x)))
            for x in jax.tree_util.tree_leaves(state.params)))
    first = out["states"][1]
    out["jax_grads"] = params_like(ref, first.opt_state[0]["g"])
    out["jax_stats"] = _stats(_jax_head(first))
    # JAX's own gradient from the frozen weights moved by one ulp
    start = out["states"][0]
    rng = np.random.RandomState(1)
    moved = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * (1 + 2.0 ** -23 * rng.choice(
            [-1, 1], size=a.shape))).astype(np.float32),
        start.backbone_params)
    noisy, out["noise_logs"] = step(start._replace(backbone_params=moved),
                                    jax.random.PRNGKey(0))
    out["noise_grads"] = params_like(ref, noisy.opt_state[0]["g"])

    batch = _port_batch(prime)
    trainer = _port_trainer(remat_modules=True)
    out["port_logs"], out["port_norms"] = [], []
    for i in range(N_STEPS):
        out["port_logs"].append(_with_fixed_prime(
            prime, lambda: train_step(trainer, batch, None)))
        out["port_norms"].append(_sq_norm(trainer.state.head))
        if i == 0:
            out[True] = dict(logs=out["port_logs"][0],
                             grads=_grads(trainer.state.head),
                             stats=_stats(trainer.state.head))
    out["trainer"] = trainer
    plain = _port_trainer(remat_modules=False)
    logs = _with_fixed_prime(prime, lambda: forward_backward(plain, batch,
                                                             None))
    out[False] = dict(logs=logs, grads=_grads(plain.state.head),
                      stats=_stats(plain.state.head))
    resumed = _port_trainer(seed=9)
    load_align_state(resumed, out["states"][N_STEPS - 1])
    out["resumed_logs"] = _with_fixed_prime(
        prime, lambda: train_step(resumed, batch, None))
    out["resumed"] = resumed
    return out


def _rel_errors(got, want):
    return {n: float((got[n] - want[n]).norm()) / float(want[n].norm())
            for n in want}


def _total_error(got, want):
    return (sum(float(((got[n] - want[n]) ** 2).sum()) for n in want)
            / sum(float((want[n] ** 2).sum()) for n in want)) ** 0.5


def _first_loss_rtol(run):
    """Each first-step loss's limit: LOSS_RTOL or NOISE_X x what JAX's own
    step moves it by from the frozen weights moved by one ulp, whichever
    is larger (the gradients' rule)."""
    want, noisy = run["jax_logs"][0], run["noise_logs"]
    floor = {k: abs(noisy[k] - want[k]) / abs(want[k]) for k in LOG_KEYS}
    # the floor is rounding, not a different step
    assert all(v < 1e-4 for v in floor.values()), floor
    return {k: max(LOSS_RTOL, NOISE_X * floor[k]) for k in LOG_KEYS}


@pytest.mark.parametrize("remat", [False, True])
def test_first_step_losses_match_jax(run, remat):
    want, got = run["jax_logs"][0], run[remat]["logs"]
    rtol = _first_loss_rtol(run)
    errors = {k: abs(got[k] - want[k]) / abs(want[k]) for k in LOG_KEYS}
    assert all(errors[k] <= rtol[k] for k in LOG_KEYS), (errors, rtol)
    # both losses are live
    assert want["loss_ss"] > 0 and want["loss_us"] > 0


@pytest.mark.parametrize("remat", [False, True])
def test_first_step_head_gradients_match_jax_grad(run, remat):
    want, got = run["jax_grads"], run[remat]["grads"]
    assert set(got) == set(want)
    floor = _rel_errors(run["noise_grads"], want)
    errors = _rel_errors(got, want)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= GRAD_MAX, (worst, errors[worst])
    assert statistics.median(errors.values()) <= GRAD_FLOOR + NOISE_X * \
        statistics.median(floor.values())
    total_floor = _total_error(run["noise_grads"], want)
    assert _total_error(got, want) <= GRAD_FLOOR + NOISE_X * total_floor
    # the floor is rounding, not a different gradient
    assert total_floor < 1e-3
    assert all(float(want[n].abs().max()) > 0 for n in want)


@pytest.mark.parametrize("remat", [False, True])
def test_first_step_bn_statistics_match_jax(run, remat):
    """Three sequential EMA updates, one per head pass, with or without the
    modules' checkpoints (whose recompute must not update them again)."""
    want, got = run["jax_stats"], run[remat]["stats"]
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   err_msg=name, **STAT_TOL)
    assert any(float((t - 1).abs().max()) > 1e-3 for n, t in want.items()
               if n.endswith("running_var"))


def test_remat_modules_leaves_gradients_and_statistics(run):
    plain, remat = run[False], run[True]
    for name, g in plain["grads"].items():
        torch.testing.assert_close(remat["grads"][name], g, rtol=1e-5,
                                   atol=1e-6 * float(g.abs().max()))
    for name, t in plain["stats"].items():
        torch.testing.assert_close(remat["stats"][name], t, rtol=0, atol=0)


@pytest.mark.parametrize("step", range(N_STEPS))
def test_trajectory_losses_match_jax(run, step):
    want, got = run["jax_logs"][step], run["port_logs"][step]
    rtol = (_first_loss_rtol(run) if step == 0
            else dict.fromkeys(LOG_KEYS, LATER_LOSS_RTOL))
    for key in LOG_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol[key],
                                   err_msg=f"step {step} {key}")


def test_trajectory_norm_trace_matches_jax(run):
    np.testing.assert_allclose(run["port_norms"], run["jax_norms"],
                               rtol=1e-6)
    # wd 0.1 shrinks the parameters every step
    assert np.all(np.diff(run["jax_norms"]) < 0)


def test_trajectory_final_parameters_and_statistics_match_jax(run):
    head = run["trainer"].state.head
    want = _jax_head(run["states"][-1]).state_dict()
    for key, t in head.state_dict().items():
        tol = (LATER_STAT_TOL
               if key.endswith(("running_mean", "running_var"))
               else dict(rtol=0, atol=PARAM_ATOL))
        np.testing.assert_allclose(t.numpy(), want[key].numpy(),
                                   err_msg=key, **tol)
    state = run["trainer"].state
    assert state.step == N_STEPS
    # the schedule halved the rate at its milestone
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(LR / 2)


def test_resumed_from_jax_state_matches_jax_step(run):
    """``load_align_state`` carries the JAX state after 2 steps (Adam
    moments and count included); the port's third step then matches
    JAX's."""
    want, got = run["jax_logs"][N_STEPS - 1], run["resumed_logs"]
    for key in LOG_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=LATER_LOSS_RTOL,
                                   err_msg=key)
    resumed = run["resumed"].state
    assert resumed.step == N_STEPS
    np.testing.assert_allclose(_sq_norm(resumed.head), run["jax_norms"][-1],
                               rtol=1e-6)



ALIGN_SPANS = ["align.step", "align.prime", "align.pyramids",
               "align.cast_params", "align.head", "align.losses",
               "align.backward", "align.optimizer"]


def test_train_step_records_its_phases_in_order(run):
    """One more step of the trained port trainer, on a copy, under a
    recorder: exactly the step's spans, every phase a child of
    ``align.step``, closed in the order they opened."""
    prime = _prime_np()
    trainer = copy.deepcopy(run["trainer"])
    with Recorder() as rec:
        _with_fixed_prime(prime, lambda: train_step(
            trainer, _port_batch(prime), None))
    assert [s.name for s in rec.spans] == ALIGN_SPANS
    assert [s.parent for s in rec.spans] == [None] + [0] * 7
    assert {s.step for s in rec.spans} == {0}
    ends = [s.end_ns for s in rec.spans[1:]]
    assert ends == sorted(ends) and ends[-1] <= rec.spans[0].end_ns
