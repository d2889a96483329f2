"""The three branches of the port's UDA step that the trajectory test
(tests/test_torch_uda_trajectory.py) does not take, each held against one
step of the JAX ``make_uda_train_step``:

* the adapt-to-reference coin that makes the normal-condition reference
  the target (the plain teacher runs on it; align and refine are skipped);
* ``use_refign=False`` (the plain teacher on the target);
* ``use_align=False`` (Refign's refine of the unwarped reference logits).

Set-up as in the trajectory test, whose helpers this file uses: mit_b0 +
DAFormer (32), 64^2, B=2, fp32, the frozen VGG-16 + UAWarpC aligner, the
ImageNet feature distance, AdamW with warmup-poly, and every random draw
pinned on both sides (the deterministic ClassMix rule, no jitter, no
blur, no dropout).  One step from the port's seeded init at an update
count past the warmup (the trajectory test's HRDA step does the same; at
count 0 the warmup rate moves the parameters by less than rounding): the
losses and each parameter's and BN statistic's change, with the
trajectory test's tolerances.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
import refign_tpu.uda.dacs as jax_dacs
import refign_tpu.uda.trainer as jax_trainer
import test_torch_uda_trajectory as traj
from refign_tpu.train.optim import make_uda_optimizer as jax_optimizer
from refign_tpu_torch.uda import trainer as port_trainer
from refign_tpu_torch.uda.trainer import UDAConfig, train_step
from refign_tpu_torch.utils.jax_convert import load_uda_state

BRANCHES = {
    # name: (config overrides, the coin's outcome)
    "reference_as_target": (dict(adapt_to_ref=True), True),
    "no_refign": (dict(use_refign=False), False),
    "no_align": (dict(use_align=False), False),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_branch_step_matches_jax(branch):
    overrides, coin = BRANCHES[branch]
    cfg_kw = dict(traj.CFG, **overrides)
    batch_np = traj._batch_np()
    align_bb, align_head, tree, align_net = traj._align_trees()
    seg, variables, student = traj._models(hrda=False)
    tx, _ = jax_optimizer(variables["params"], traj.LR, traj.WD,
                          traj.MAX_STEPS, backbone_lr_factor=0.1,
                          warmup_iters=traj.WARMUP, power=1.0)
    imnet = traj._imnet(variables["params"])
    start = traj._at_update_count(jax_trainer.init_uda_state(
        variables["params"], variables["batch_stats"], tx)._replace(
            imnet_params=imnet), traj.HRDA_COUNT)

    # which branch each side took: the teacher's inputs and the refine
    # calls, recorded on both sides
    jax_refines, port_refines = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_dacs, "get_class_masks", traj._det_class_masks_jax)
    real = jax_trainer.refine
    mp.setattr(jax_trainer, "refine",
               lambda *a, **k: jax_refines.append(a[2] is None) or real(*a,
                                                                         **k))
    try:
        step_fn = jax_trainer.make_uda_train_step(
            seg, align_bb, align_head, tx,
            jax_trainer.UDAConfig(**cfg_kw))
        state, logs = step_fn(start, batch_np, tree, jax.random.PRNGKey(0),
                              use_ref_as_target=coin)
        want = {k: float(v) for k, v in logs.items()}
    finally:
        mp.undo()

    port_real = port_trainer.refine
    mp = pytest.MonkeyPatch()
    mp.setattr(port_trainer, "refine",
               lambda *a, **k: port_refines.append(a[2] is None)
               or port_real(*a, **k))
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    try:
        with traj._one_thread():
            trainer = traj._port_trainer(
                student, UDAConfig(**cfg_kw),
                align_net if cfg_kw["use_align"] else None, imnet)
            load_uda_state(trainer, start)
            draws = dataclasses.replace(traj._pinned_draws(),
                                        use_ref_as_target=coin)
            got = {k: float(v) for k, v in train_step(trainer, batch,
                                                      draws).items()}
    finally:
        mp.undo()

    # the branch: refine with a warp, refine without one, or none at all
    expect = {"reference_as_target": [], "no_refign": [],
              "no_align": [True]}[branch]
    assert jax_refines == port_refines == expect
    assert want["train_loss_featdist_src"] > 1e-4
    assert trainer.state.step == traj.HRDA_COUNT + 1
    for key in traj.LOSS_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=traj.LOSS_RTOL,
                                   err_msg=key)
    traj._assert_updates_match(variables,
                               {"params": state.params,
                                "batch_stats": state.batch_stats},
                               trainer.state.student, 1)
