"""The UAWarpC step's loss and normalisation settings in the port
(``refign_tpu_torch/tasks/align_task.py``, ``alignment/trainer.py``) at
values other than the defaults, against the JAX package.

``tests/test_torch_data.py``'s tiny stage-1 configuration with the train
pipeline's Normalize at another mean and std, the W-bipath loss's
``visibility_mask``, ``alpha_1`` and ``alpha_2`` changed,
``apply_constant_flow_weights`` on (the weight_ss slot: ratio 1) and the
memory options set, built by each package's ``build_task`` (the step
below also sets the L2 loss and level weights, which no configuration
sets, on both sides):

* the two tasks' step settings are the same, field by field (the JAX
  ``device_normalize`` switch aside: the port always normalises uint8
  batches on the device);
* the prime view under the other normalisation (jitter, channel shuffle
  and blur run in the space it maps back to [0, 1]) against JAX's, with
  the numbers JAX draws (``tests/test_torch_align_train_prime.py``'s
  replay), at that file's image tolerance;
* one step from the same weights on the same uint8 batch (normalised on
  the device by each side) and the same fixed prime data: the three
  losses at ``tests/test_torch_align_train_step.py``'s rule (1e-5, or 5x
  what JAX's own step moves them by from the frozen weights moved by one
  ulp: here the largest over three random directions).  The reading on
  the CPU: loss_us 2.39e-5 against JAX, 1.8x its floor of 1.33e-5, the
  other losses 1.2e-6 against 7.1e-7 (with the Huber loss and unit
  weights: loss_us 1.33e-5 against 5.78e-6, where one direction alone
  read 1.57e-6); JAX's W-bipath loss on the port's own head outputs gives
  the port's value bit for bit, so the difference is the networks'
  rounding, not the loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
import refign_tpu.alignment.trainer as jax_trainer
from refign_tpu.config import build_task as jax_build_task
from refign_tpu.models.heads.uawarpc import UAWarpCHead as JaxUAWarpC
from refign_tpu.models.vgg import VGG as JaxVGG
from refign_tpu_torch.alignment.trainer import (AlignTrainer, crop_window,
                                                forward_backward,
                                                init_align_state,
                                                prepare_alignment_batch)
from refign_tpu_torch.config import build_task
from refign_tpu_torch.train.optim import make_adam_optimizer
from test_torch_align_train_prime import IMG_TOL, _align_draws, _jax_cfg
from test_torch_align_train_step import (LOG_KEYS, LOSS_RTOL, LR,
                                         MILESTONES, NOISE_X, WD, _jax_state,
                                         _jax_tx, _port_nets, _prime_np,
                                         _with_fixed_prime)
from test_torch_data import tiny_stage1_config

MEAN, STD = (0.5, 0.4, 0.3), (0.2, 0.3, 0.25)
# random one-ulp directions of the frozen weights; the largest movement
# of each loss is its floor (the method of chip_smoke.py's loss_floor)
FLOOR_DIRECTIONS = 3
SETTINGS = dict(alpha_1=0.1, alpha_2=2.0, visibility_mask=True)
MODEL_ARGS = dict(apply_constant_flow_weights=True, remat_modules=False,
                  remat_head=True, remat_head_policy="dots",
                  remat_skip_last=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config():
    cfg = tiny_stage1_config()
    train = cfg["data"]["init_args"]["load_config"]["train"]["MegaDepth"]
    for t in train["transforms"]:
        if t["class_path"].endswith(".Normalize"):
            t["init_args"] = {"mean": list(MEAN), "std": list(STD)}
    margs = cfg["model"]["init_args"]
    margs["unsupervised_loss"]["init_args"].update(SETTINGS)
    margs.update(MODEL_ARGS)
    return cfg


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("none"))
    port, _ = build_task(_config(), data_dir, device="cpu")
    jax_task, _ = jax_build_task(_config(), data_dir)
    return port.align_cfg, jax_task.align_cfg


def test_tasks_read_the_same_settings(tasks):
    port, jax_cfg = tasks
    fields = {f.name for f in dataclasses.fields(port)}
    assert fields == {f.name for f in dataclasses.fields(jax_cfg)} - {
        "device_normalize"}
    for name in sorted(fields):
        got, want = getattr(port, name), getattr(jax_cfg, name)
        if isinstance(want, (list, tuple)):
            got, want = tuple(got), tuple(want)
        assert got == want, (name, got, want)
    np.testing.assert_allclose(port.norm_mean, MEAN, rtol=1e-7)
    np.testing.assert_allclose(port.norm_std, STD, rtol=1e-7)
    assert port.apply_constant_flow_weights and port.alpha_1 == 0.1
    assert port.remat_head_policy == "dots" and not port.remat_modules


def test_prime_view_under_the_normalisation_matches_jax(tasks):
    cfg = dataclasses.replace(tasks[0], prime_blur=(0.5, 7, 0.2, 2.0))
    B, H, W = 3, 44, 44
    rng = np.random.RandomState(0)
    ref = rng.randn(B, H, W, 3).astype(np.float32) * 0.5
    trg = rng.randn(B, H, W, 3).astype(np.float32) * 0.5
    key = jax.random.PRNGKey(7)
    out_slice = crop_window(dataclasses.replace(cfg,
                                                crop_after_flow=(32, 32)),
                            H, W)
    want = jax.jit(jax_trainer.prepare_alignment_batch,
                   static_argnames=("cfg", "out_slice"))(
        key, jnp.asarray(ref), jnp.asarray(trg), cfg=_jax_cfg(cfg),
        out_slice=out_slice)
    draws, noise = _align_draws(key, B, H, W, cfg)
    assert all(d.jitter is not None for d in draws.photometric)
    got = prepare_alignment_batch(draws, torch.from_numpy(ref),
                                  torch.from_numpy(trg), cfg,
                                  out_slice=out_slice, noise=noise)
    np.testing.assert_allclose(got["image_prime"].numpy(),
                               np.asarray(want["image_prime"]), **IMG_TOL)


def _uint8_batch(prime):
    """uint8 80^2 pairs whose 64^2 centre crop holds the fixed data's
    images (the tiny configuration's crop after the flow)."""
    def u8(x):
        img = np.clip(np.asarray(x) * 40 + 128, 0, 255).astype(np.uint8)
        return np.pad(img, ((0, 0), (8, 8), (8, 8), (0, 0)), mode="edge")
    return {k: u8(prime[k]) for k in ("image_ref", "image_trg")}


def test_step_with_the_settings_matches_jax(tasks):
    # the loss settings no config sets, changed on both sides too
    losses = dict(loss_type="L2Loss", level_weights=(0.5, 1.0, 1.5, 2.0))
    port_cfg = dataclasses.replace(tasks[0], **losses)
    jax_cfg = dataclasses.replace(tasks[1], device_normalize=True, **losses)
    prime = _prime_np()
    batch = _uint8_batch(prime)
    fixed = {k: jnp.asarray(prime[k]) for k in
             ("image_prime", "flow_prime", "mask_prime", "prime_trg_idx")}
    tx = _jax_tx()
    step = jax.jit(jax_trainer.make_align_train_step(
        JaxVGG(model_type="vgg11", out_indices=(2, 3, 4)),
        JaxUAWarpC(in_index=(0, 1), estimate_uncertainty=True), tx,
        jax_cfg))

    def jax_logs(state):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_trainer, "prepare_alignment_batch",
                       lambda *a, **k: dict(fixed))
            _, logs = step(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        return {k: float(v) for k, v in logs.items()}

    start = _jax_state(tx)
    want = jax_logs(start)
    rng = np.random.RandomState(1)
    noisy = []
    for _ in range(FLOOR_DIRECTIONS):
        moved = jax.tree_util.tree_map(
            lambda a: (np.asarray(a) * (1 + 2.0 ** -23 * rng.choice(
                [-1, 1], size=a.shape))).astype(np.float32),
            start.backbone_params)
        noisy.append(jax_logs(start._replace(backbone_params=moved)))

    backbone, head = _port_nets()
    opt, sched = make_adam_optimizer(head.parameters(), LR, MILESTONES,
                                     gamma=0.5, weight_decay=WD)
    trainer = AlignTrainer(port_cfg,
                           init_align_state(backbone, head, opt, sched))
    got = _with_fixed_prime(prime, lambda: forward_backward(
        trainer, {k: torch.from_numpy(v) for k, v in batch.items()}, None))
    for key in LOG_KEYS:
        floor = max(abs(n[key] - want[key]) for n in noisy) / abs(want[key])
        assert floor < 1e-4, (key, floor)
        err = abs(got[key] - want[key]) / abs(want[key])
        assert err <= max(LOSS_RTOL, NOISE_X * floor), (key, err, floor)
    # ratio 1 with the constant weights: the total is no longer one loss
    # times (0, 1) or (1, 100)
    assert want["loss_ss"] > 0 and want["loss_us"] > 0
    assert want["train_matching_loss"] not in (
        want["loss_us"], want["loss_ss"] + 100 * want["loss_us"])
