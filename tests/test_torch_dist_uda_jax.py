"""The port's data-parallel Refign train step on 2 gloo ranks on the CPU
against JAX's ``make_uda_train_step`` on a 2-device mesh
(``make_mesh(jax.devices()[:2])``: the batch sharded, the state
replicated).

One pinned DAFormer step (no HRDA, no Refign: the align and refine have no
reduction over the batch, and their compile would double the JAX side's;
dropout and drop path 0, the feature distance, AdamW without warmup,
fp32, global B = 4 + 4) from the port's seeded init, carried to JAX by the JAX
package's ``convert_state_dict``, with the draws that
``tests/test_torch_uda_trajectory.py`` pins on both sides (the
deterministic ClassMix rule, no jitter, no blur); held at that file's
tolerances: the losses, the parameter sq-norm and each entry's update.
"""
import jax
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
import refign_tpu.uda.dacs as jax_dacs
import refign_tpu.uda.trainer as jax_trainer
import torch_dist_ranks as R
from refign_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from refign_tpu.train.optim import make_uda_optimizer as jax_optimizer
from refign_tpu_torch.uda.dacs import DACSDraws, JitterFactors
from refign_tpu_torch.uda.trainer import StepDraws
from refign_tpu_torch.utils.jax_convert import load_jax_variables
from test_torch_uda_trajectory import (CFG, LOSS_KEYS, LOSS_RTOL, NORM_RTOL,
                                       _assert_updates_match,
                                       _det_class_masks_jax, _imnet, _models,
                                       _port_student, _sq_norm_jax)

GB = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pinned_draws():
    """The trajectory file's pinned draws for the global batch of 4."""
    scores = (1.0 - torch.arange(20, dtype=torch.float32) / 20).expand(
        GB, 20)
    idle = JitterFactors(1.0, 1.0, 1.0, 0.0, (0, 1, 2, 3))
    dacs = DACSDraws(0.5, 0.0, scores.contiguous(), [idle] * GB, [0.5] * GB)
    return StepDraws(False, dacs, (0, 0), (0, 0), 0)


@pytest.fixture(scope="module")
def jax_setup():
    seg, variables, student = _models(hrda=False)
    imnet = _imnet(variables["params"])
    port_imnet = _port_student(False).backbone
    load_jax_variables(port_imnet, {"params": imnet, "batch_stats": {}})
    return dict(seg=seg, variables=variables,
                state_dict=student.state_dict(),
                imnet=imnet, imnet_sd=port_imnet.state_dict())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_setup):
    return R.spawn(R.uda_pinned_case, 2,
                   str(tmp_path_factory.mktemp("pinned")),
                   jax_setup["state_dict"], jax_setup["imnet_sd"],
                   _pinned_draws())


def test_two_rank_step_matches_jax_mesh(ranks, jax_setup):
    """One pinned Refign step, JAX on a 2-device mesh (batch sharded,
    state replicated) against the port on 2 ranks."""
    variables = jax_setup["variables"]
    params = variables["params"]
    cfg = jax_trainer.UDAConfig(**dict(CFG, use_refign=False))
    tx, _ = jax_optimizer(params, R.UDA_LR, 0.01, R.UDA_MAX_STEPS,
                          backbone_lr_factor=0.1, warmup_iters=0,
                          power=1.0)
    state = jax_trainer.init_uda_state(params, variables["batch_stats"],
                                       tx)._replace(
        imnet_params=jax_setup["imnet"])
    batch = {k: v.numpy() for k, v in R.pinned_batch().items()}
    mesh = make_mesh(jax.devices()[:2])
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_dacs, "get_class_masks", _det_class_masks_jax)
    try:
        step_fn = jax_trainer.make_uda_train_step(
            jax_setup["seg"], None, None, tx, cfg)
        state, logs = step_fn(replicate(mesh, state),
                              shard_batch(mesh, batch), None,
                              jax.random.PRNGKey(0))
        want = {k: float(v) for k, v in logs.items()}
    finally:
        mp.undo()
    assert want["train_loss_featdist_src"] > 1e-4
    for o in ranks:
        assert o["divergence"] == 0.0
        for key in LOSS_KEYS:
            np.testing.assert_allclose(o["logs"][key], want[key],
                                       rtol=LOSS_RTOL, err_msg=key)
    port = _port_student(False)
    port.load_state_dict(ranks[0]["state"])
    np.testing.assert_allclose(
        sum(float((p.detach().double() ** 2).sum())
            for p in port.parameters()),
        _sq_norm_jax(state.params), rtol=NORM_RTOL)
    _assert_updates_match(variables, {"params": state.params,
                                      "batch_stats": state.batch_stats},
                          port, 1)
