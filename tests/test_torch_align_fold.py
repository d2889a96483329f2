"""The port's UAWarpC step under the JAX step's memory options
(``refign_tpu_torch/alignment/trainer.py``: ``fold_passes``,
``remat_head``, ``remat_head_policy``, ``remat_skip_last``) against the
JAX folded step and against the port's serial step.

The setting of ``tests/test_torch_align_train_step.py`` (vgg11 +
UAWarpC, B=2, 64^2, fp32, the visibility mask, the fixed prime data
monkeypatched into both steps, its helpers): one step each.

* The folded step (one head pass of 3B rows, BatchNorm in 3 groups)
  against JAX's ``fold_passes`` step: the three losses, every head
  gradient and the BN running statistics, at the serial step test's
  limits (losses 1e-5 or 5x JAX's own one-ulp floor; gradients 1e-4 +
  5x the floor over all and for the median parameter, 3e-2 for each;
  statistics 1e-5 / 1e-6).  The reading on the CPU: losses 1.24e-5,
  9.6e-8, 1.41e-5 against floors 4.9e-6, 5.7e-7, 5.5e-6; gradients
  3.8e-4 over all (floor 4.6e-4), median 2.4e-4 (floor 7.6e-5), largest
  1.2e-2.
* The folded step, with and without ``remat_modules``, against the
  port's serial step (``tests/test_fold_passes.py:111-160`` asserts it
  for JAX): the same losses, gradients and statistics up to the order of
  fp32 sums (a conv over 3B rows, per-group reductions; the reading:
  losses and statistics bit-equal, gradients 2.3e-7 over all).
* ``remat_head`` (whole passes recomputed), with the 'dots' policy, with
  ``remat_skip_last`` and nested with ``remat_modules``: the serial
  step's gradients and statistics (``tests/test_alignment.py:367-400``
  asserts it for JAX); the recompute must not update the statistics again
  (the reading: bit-equal).
"""
import dataclasses
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
import refign_tpu.alignment.trainer as jax_trainer
from refign_tpu.models.heads.uawarpc import UAWarpCHead as JaxUAWarpC
from refign_tpu.models.vgg import VGG as JaxVGG
from refign_tpu_torch.alignment.trainer import (AlignConfig, AlignTrainer,
                                                forward_backward,
                                                init_align_state)
from refign_tpu_torch.train.optim import make_adam_optimizer
from refign_tpu_torch.utils.jax_convert import params_like
from test_torch_align_train_step import (GRAD_FLOOR, GRAD_MAX, LOG_KEYS,
                                         LOSS_RTOL, LR, MILESTONES, NOISE_X,
                                         STAT_TOL, WD, _grads, _jax_head,
                                         _jax_state, _jax_tx, _port_batch,
                                         _port_nets, _prime_np, _rel_errors,
                                         _stats, _total_error,
                                         _with_fixed_prime)

# port variants: their AlignConfig options
VARIANTS = {
    "serial": {},
    "fold": dict(fold_passes=True),
    "fold_remat_modules": dict(fold_passes=True, remat_modules=True),
    "remat_head": dict(remat_head=True),
    "remat_head_dots": dict(remat_head=True, remat_head_policy="dots"),
    "remat_skip_last": dict(remat_head=True, remat_skip_last=True),
    "remat_head_modules": dict(remat_head=True, remat_head_policy="dots",
                               remat_modules=True),
}
# the folded step against the serial one, both the port's: the same math
# up to the order of fp32 sums
FOLD_LOSS_RTOL = 1e-6
FOLD_GRAD_TOTAL = 1e-5
FOLD_STAT_TOL = dict(rtol=1e-6, atol=1e-6)


def _port_run(prime, **opts):
    backbone, head = _port_nets(remat_modules=opts.get("remat_modules",
                                                       False))
    opt, sched = make_adam_optimizer(head.parameters(), LR, MILESTONES,
                                     gamma=0.5, weight_decay=WD)
    cfg = AlignConfig(visibility_mask=True, compute_dtype="float32", **opts)
    trainer = AlignTrainer(cfg, init_align_state(backbone, head, opt, sched))
    logs = _with_fixed_prime(prime, lambda: forward_backward(
        trainer, _port_batch(prime), None))
    return dict(logs=logs, grads=_grads(head), stats=_stats(head))


@pytest.fixture(scope="module")
def run():
    prime = _prime_np()
    tx = _jax_tx()
    fixed = {k: jnp.asarray(prime[k]) for k in
             ("image_prime", "flow_prime", "mask_prime", "prime_trg_idx")}
    cfg = jax_trainer.AlignConfig(visibility_mask=True,
                                  compute_dtype="float32", fold_passes=True)
    step = jax.jit(jax_trainer.make_align_train_step(
        JaxVGG(model_type="vgg11", out_indices=(2, 3, 4)),
        JaxUAWarpC(in_index=(0, 1), estimate_uncertainty=True), tx, cfg))
    batch = {k: jnp.asarray(prime[k]) for k in ("image_ref", "image_trg")}

    def jax_step(state):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_trainer, "prepare_alignment_batch",
                       lambda *a, **k: dict(fixed))
            state, logs = step(state, batch, jax.random.PRNGKey(0))
        return state, {k: float(v) for k, v in logs.items()}

    ref = _port_nets()[1]
    start = _jax_state(tx)
    first, logs = jax_step(start)
    out = {"jax": dict(logs=logs,
                       grads=params_like(ref, first.opt_state[0]["g"]),
                       stats=_stats(_jax_head(first)))}
    rng = np.random.RandomState(1)
    moved = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * (1 + 2.0 ** -23 * rng.choice(
            [-1, 1], size=a.shape))).astype(np.float32),
        start.backbone_params)
    noisy, noise_logs = jax_step(start._replace(backbone_params=moved))
    out["noise"] = dict(logs=noise_logs,
                        grads=params_like(ref, noisy.opt_state[0]["g"]))
    for name, opts in VARIANTS.items():
        out[name] = _port_run(prime, **opts)
    return out


def _loss_errors(got, want):
    return {k: abs(got[k] - want[k]) / abs(want[k]) for k in LOG_KEYS}


def test_folded_step_matches_jax_folded_step(run):
    want, got, noise = run["jax"], run["fold"], run["noise"]
    floor = _loss_errors(noise["logs"], want["logs"])
    errors = _loss_errors(got["logs"], want["logs"])
    assert all(errors[k] <= max(LOSS_RTOL, NOISE_X * floor[k])
               for k in LOG_KEYS), (errors, floor)
    assert want["logs"]["loss_ss"] > 0 and want["logs"]["loss_us"] > 0
    assert set(got["grads"]) == set(want["grads"])
    grad_floor = _rel_errors(noise["grads"], want["grads"])
    rel = _rel_errors(got["grads"], want["grads"])
    assert max(rel.values()) <= GRAD_MAX, max(rel.items(), key=lambda kv:
                                              kv[1])
    assert statistics.median(rel.values()) <= GRAD_FLOOR + NOISE_X * \
        statistics.median(grad_floor.values())
    total_floor = _total_error(noise["grads"], want["grads"])
    assert total_floor < 1e-3
    assert _total_error(got["grads"], want["grads"]) <= \
        GRAD_FLOOR + NOISE_X * total_floor
    for name, t in got["stats"].items():
        np.testing.assert_allclose(t.numpy(), want["stats"][name].numpy(),
                                   err_msg=name, **STAT_TOL)


@pytest.mark.parametrize("variant", ["fold", "fold_remat_modules"])
def test_folded_step_matches_serial_step(run, variant):
    want, got = run["serial"], run[variant]
    errors = _loss_errors(got["logs"], want["logs"])
    assert max(errors.values()) <= FOLD_LOSS_RTOL, errors
    assert _total_error(got["grads"], want["grads"]) <= FOLD_GRAD_TOTAL
    for name, t in got["stats"].items():
        np.testing.assert_allclose(t.numpy(), want["stats"][name].numpy(),
                                   err_msg=name, **FOLD_STAT_TOL)
    # three passes' updates, not one
    assert any(float((t - 1).abs().max()) > 1e-3
               for n, t in want["stats"].items() if n.endswith("running_var"))


@pytest.mark.parametrize("variant", ["remat_head", "remat_head_dots",
                                     "remat_skip_last", "remat_head_modules"])
def test_remat_head_leaves_gradients_and_statistics(run, variant):
    want, got = run["serial"], run[variant]
    for key in LOG_KEYS:
        np.testing.assert_allclose(got["logs"][key], want["logs"][key],
                                   rtol=1e-6, err_msg=key)
    for name, g in want["grads"].items():
        torch.testing.assert_close(got["grads"][name], g, rtol=1e-5,
                                   atol=1e-6 * float(g.abs().max()))
    for name, t in want["stats"].items():
        torch.testing.assert_close(got["stats"][name], t, rtol=0, atol=0)


def test_unknown_remat_head_policy_raises():
    prime = _prime_np()
    with pytest.raises(ValueError, match="unknown remat policy"):
        _port_run(prime, remat_head=True, remat_head_policy="everything")
