"""The port's Refign train step (refign_tpu_torch/uda/trainer.py) against
the JAX ``make_uda_train_step`` over a short trajectory.

mit_b0 + DAFormer (32), 64^2, B=2, fp32, ``use_refign`` and ``use_align``
with a frozen VGG-16 + UAWarpC (the only alignment variant the port
builds), the ImageNet feature distance, AdamW in 4 groups with the
warmup-poly schedule.  Every random draw is pinned on both sides as
``tests/test_refign_trajectory_golden.py`` pins them: the deterministic
ClassMix rule (first ceil(n/2) present classes; the port gets class scores
that rank the classes in that order), ``color_jitter_p=1.0`` (no jitter),
``blur=False``, dropout and drop path 0, ``adapt_to_ref=False``.  Both
sides start from the port's seeded init, carried to JAX by the JAX
package's ``convert_state_dict``.

* 3 steps from one init (the ImageNet copy moved off it on both sides, so
  the feature distance is not a difference of rounding errors): the three
  losses per step, the parameter sq-norm trace, the refined
  pseudo-probabilities at the first and the last step, the student's BN
  statistics and its final parameters, and each entry's change from the
  init (the backbone's, at its 0.1 learning-rate factor, is ~1e-5 an
  element, below what the final parameters' limit can see);
* the JAX state after 2 steps carried into a fresh port trainer
  (``load_uda_state``: parameters, BN statistics, the Adam moments and
  count) takes step 3 as the JAX step does;
* one HRDA step (SegFormer scale attention) with the crop offsets of both
  passes pinned on both sides, from a state past the warmup (every optax
  count set, carried by ``load_uda_state``), with each entry's change.

Both sides compute in fp32 on the CPU; they differ by summation order,
which the closed teacher -> student loop carries from step to step.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
import refign_tpu.uda.dacs as jax_dacs
import refign_tpu.uda.trainer as jax_trainer
from refign_tpu.models.heads.daformer import DAFormerHead as JaxDAFormer
from refign_tpu.models.heads.segformer import SegFormerHead as JaxSegFormer
from refign_tpu.models.heads.uawarpc import UAWarpCHead as JaxUAWarpC
from refign_tpu.models.mix_transformer import \
    MixVisionTransformer as JaxMiT
from refign_tpu.models.segmentor import Segmentor as JaxSegmentor
from refign_tpu.models.vgg import VGG as JaxVGG
from refign_tpu.train.optim import make_uda_optimizer as jax_optimizer
from refign_tpu.utils.torch_convert import convert_state_dict
from refign_tpu_torch.alignment.trainer import AlignmentNet
from refign_tpu_torch.models.heads.daformer import DAFormerHead
from refign_tpu_torch.models.heads.segformer import SegFormerHead
from refign_tpu_torch.models.heads.uawarpc import UAWarpCHead
from refign_tpu_torch.models.mix_transformer import MixVisionTransformer
from refign_tpu_torch.models.segmentor import Segmentor
from refign_tpu_torch.models.vgg import VGG
from refign_tpu_torch.train.optim import make_uda_optimizer
from refign_tpu_torch.uda import trainer as port_trainer
from refign_tpu_torch.uda.dacs import DACSDraws, JitterFactors
from refign_tpu_torch.uda.trainer import (StepDraws, UDAConfig, UDATrainer,
                                          init_uda_state, train_step)
from refign_tpu_torch.utils.jax_convert import (load_jax_variables,
                                                load_uda_state)

B, H, W = 2, 64, 64
LR, WD, MAX_STEPS, WARMUP = 6e-4, 0.01, 20, 4
N_STEPS = 3
CFG = dict(use_refign=True, use_align=True, adapt_to_ref=False,
           enable_fdist=True, color_jitter_p=1.0, blur=False,
           compute_dtype="float32")
# Tolerances, about 10x the largest difference read on the CPU (losses
# 4.9e-7 relative, sq-norm 1.6e-7 relative, probabilities 2.2e-8,
# parameters 6.0e-6, BN statistics 2.1e-6; the updates, per entry as
# _update_errors reads them, 4.9e-5 over the 3 steps and 6.1e-4 in the
# HRDA step, 2.7e-4 on an entry above its floor).  A port that left the
# state unchanged reads 0.99 or more on every entry above its floor, and
# one that left only the backbone unchanged reads 1.0 on its worst entry.
LOSS_RTOL = 5e-6
NORM_RTOL = 2e-6
PROBS_ATOL = 2e-7
PARAM_ATOL = 6e-5
UPDATE_RTOL = 5e-3
# the HRDA step's update count: past the warmup, at 7/8 of the base rate
HRDA_COUNT = WARMUP + 2


def _det_class_masks_jax(rng, labels, num_classes=19, ignore_index=255):
    """The deterministic ClassMix rule: the first ceil(n/2) classes present
    in the batch (ascending), for every image."""
    lab = jnp.where(labels == ignore_index, num_classes, labels)
    present = jnp.zeros((num_classes + 1,), jnp.bool_).at[
        lab.reshape(-1)].set(True)
    n = jnp.sum(present.astype(jnp.int32))
    k = (n + n % 2) // 2
    rank = jnp.cumsum(present.astype(jnp.int32)) - 1
    selected = present & (rank < k)
    return selected[lab].astype(jnp.float32)


def _pinned_draws(crop_src=(0, 0), crop_mix=(0, 0)):
    """Port draws matching the pinned JAX ones: scores that rank the
    classes in ascending order, no jitter (coin <= p = 1), no blur."""
    scores = (1.0 - torch.arange(20, dtype=torch.float32) / 20).expand(B, 20)
    idle = JitterFactors(1.0, 1.0, 1.0, 0.0, (0, 1, 2, 3))
    dacs = DACSDraws(0.5, 0.0, scores.contiguous(), [idle] * B, [0.5] * B)
    return StepDraws(False, dacs, crop_src, crop_mix, 0)


def _batch_np():
    rng = np.random.RandomState(13)
    blocks = rng.randint(0, 19, size=(B, H // 32, W // 32))
    blocks[0, 0, 0] = 11
    semantic = np.kron(blocks, np.ones((32, 32), np.int64))
    trg = rng.randn(B, H, W, 3).astype(np.float32) * 0.5
    ref = np.roll(trg, 3, axis=2) * 0.9 + \
        rng.randn(B, H, W, 3).astype(np.float32) * 0.1
    return {"image_src": rng.randn(B, H, W, 3).astype(np.float32) * 0.5,
            "semantic_src": semantic.astype(np.int64),
            "image_trg": trg, "image_ref": ref.astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _align_trees():
    """The frozen aligner: the port's VGG-16 + UAWarpC from its seeded init
    (head BN statistics moved off 0/1), and the same weights as the JAX
    step's alignment trees (``convert_state_dict``)."""
    net = AlignmentNet(VGG("vgg16", out_indices=(2, 3, 4)),
                       UAWarpCHead(in_index=(0, 1),
                                   estimate_uncertainty=True))
    gen = torch.Generator().manual_seed(1)
    net.backbone.init_weights(gen)
    net.head.init_weights(gen)
    with torch.no_grad():
        for name, buf in net.head.named_buffers():
            noise = 0.1 * torch.randn(buf.shape, generator=gen)
            buf.copy_((buf + noise).abs() + 0.5 if name.endswith("var")
                      else buf + noise)
    net.eval().requires_grad_(False)
    head = convert_state_dict(net.head.state_dict())
    tree = jax.tree_util.tree_map(np.array, {
        "backbone": convert_state_dict(net.backbone.state_dict())["params"],
        "head": head["params"], "head_stats": head["batch_stats"]})
    return (JaxVGG(model_type="vgg16", out_indices=(2, 3, 4)),
            JaxUAWarpC(in_index=(0, 1), estimate_uncertainty=True), tree,
            net)


def _port_student(hrda: bool, seed: int = 0):
    backbone = MixVisionTransformer("mit_b0", drop_path_rate=0.0)
    dims = backbone.embed_dims
    student = Segmentor(
        backbone, DAFormerHead(19, in_channels=dims, channels=32,
                               embed_dims=32, dropout_ratio=0.0),
        SegFormerHead(19, in_channels=dims, channels=32, dropout_ratio=0.0)
        if hrda else None)
    gen = torch.Generator().manual_seed(seed)
    for m in (backbone, student.head, student.scale_attention):
        if m is not None:
            m.init_weights(gen)
    return student


def _models(hrda: bool):
    """The JAX segmentor and its variables, and the port student with the
    same weights (the port's seeded init, converted)."""
    seg = JaxSegmentor(
        backbone=JaxMiT(model_type="mit_b0", drop_path_rate=0.0),
        head=JaxDAFormer(num_classes=19, channels=32, embed_dims=32,
                         dropout_ratio=0.0),
        scale_attention=(JaxSegFormer(num_classes=19, channels=32,
                                      dropout_ratio=0.0) if hrda else None))
    student = _port_student(hrda)
    # copies: the numpy views of the state_dict would follow the port's
    # in-place updates
    variables = jax.tree_util.tree_map(
        np.array, convert_state_dict(student.state_dict()))
    return seg, variables, student


def _imnet(params):
    """An ImageNet backbone away from the student's init (both sides start
    it as a copy of the init): the feature distance is then well above
    the two frameworks' rounding."""
    rng = np.random.RandomState(3)
    return jax.tree_util.tree_map(
        lambda a: a + 0.02 * rng.randn(*a.shape).astype(np.float32),
        params["backbone"])


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread for the port's steps: the VGG-16 align convs at
    256^2 crawl when every test worker's thread pool competes for the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _port_trainer(student, cfg, align_net, imnet, imnet_stats=None):
    """A port trainer on ``student`` whose ImageNet copy holds ``imnet``
    (and ``imnet_stats``, the BatchNorm statistics of a BN backbone)."""
    opt, sched = make_uda_optimizer(student, LR, WD, MAX_STEPS,
                                    backbone_lr_factor=0.1,
                                    warmup_iters=WARMUP, power=1.0)
    state = init_uda_state(student, opt, sched, cfg.enable_fdist)
    load_jax_variables(state.imnet, {"params": imnet,
                                     "batch_stats": imnet_stats or {}})
    return UDATrainer(cfg, state, align_net, torch.Generator())


def _update_errors(init_variables, jax_variables, student, n_steps,
                   make_ref=None):
    """Per state_dict entry of ``student``: the L2 error of its change from
    ``init_variables`` against the JAX state's change, less what rounding
    the fp32 entry on both sides may account for (``n_steps`` roundings of
    at most half an ulp each, 2^-24 |p| or less), relative to the size of
    the JAX change or to its floor, whichever is larger; the sizes; and the
    floors.  An entry's floor is what its change would be at a tenth of
    the RMS change per element of its group (the backbone's, a head's
    parameters; the BN statistics): it stands in for the size of a change
    that is rounding noise, where a gradient is zero in exact arithmetic
    (a bias before a batch-statistics BN, which removes any such shift; q
    where a stage's attention has one key) and Adam turns its noise into
    an update.  ``make_ref`` builds a module of ``student``'s structure
    (default: the mit_b0 student of this file)."""
    ref = (_port_student(student.scale_attention is not None)
           if make_ref is None else make_ref())

    def entries(variables):
        load_jax_variables(ref, variables)
        return {k: v.double().clone() for k, v in ref.state_dict().items()}

    def group(key):
        return "stats" if key.endswith(("running_mean", "running_var")) \
            else key.split(".")[0]

    s0, s1 = entries(init_variables), entries(jax_variables)
    sizes = {k: float((s1[k] - s0[k]).norm()) for k in s0}
    sq, count = {}, {}
    for k, t in s0.items():
        sq[group(k)] = sq.get(group(k), 0.0) + sizes[k] ** 2
        count[group(k)] = count.get(group(k), 0) + t.numel()
    floors = {k: 0.1 * np.sqrt(sq[group(k)] / count[group(k)] * t.numel())
              for k, t in s0.items()}
    errors = {}
    for key, t in student.state_dict().items():
        rounding = n_steps * 2.0 ** -23 * float(s1[key].norm())
        err = float((t.double() - s1[key]).norm())
        errors[key] = (max(0.0, err - rounding)
                       / max(sizes[key], floors[key]))
    return errors, sizes, floors


def _assert_updates_match(init_variables, jax_variables, student, n_steps,
                          make_ref=None, rtol=UPDATE_RTOL):
    errors, sizes, floors = _update_errors(init_variables, jax_variables,
                                           student, n_steps, make_ref)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= rtol, (worst, errors[worst])
    # the check sees every change above the floor: a port that left the
    # state unchanged (all of it, or the backbone group at its 0.1
    # learning-rate factor) fails it on each such entry
    unchanged = (_port_student(student.scale_attention is not None)
                 if make_ref is None else make_ref())
    load_jax_variables(unchanged, init_variables)
    fault, _, _ = _update_errors(init_variables, jax_variables, unchanged,
                                 n_steps, make_ref)
    moved = [k for k in sizes if sizes[k] > floors[k]]
    assert any(k.startswith("backbone.") for k in moved)
    assert all(fault[k] > rtol for k in moved)


def _at_update_count(state, count):
    """The JAX state with its step and every optax count (Adam's and the
    schedules') at ``count``; the Adam moments stay zero."""
    def at_count(x):
        return (jnp.full_like(x, count) if jnp.issubdtype(x.dtype, jnp.integer)
                else x)
    return state._replace(step=jnp.asarray(count, jnp.int32),
                          opt_state=jax.tree_util.tree_map(at_count,
                                                           state.opt_state))


def _sq_norm_jax(params):
    return sum(float(jnp.sum(jnp.square(x)))
               for x in jax.tree_util.tree_leaves(params))


def _sq_norm_port(trainer):
    return sum(float((p.detach().double() ** 2).sum())
               for p in trainer.state.student.parameters())


@pytest.fixture(scope="module")
def trajectory():
    batch_np = _batch_np()
    align_bb, align_head, tree, align_net = _align_trees()
    seg, variables, student = _models(hrda=False)
    params = variables["params"]
    batch_stats = variables["batch_stats"]
    cfg = jax_trainer.UDAConfig(**CFG)
    tx, _ = jax_optimizer(params, LR, WD, MAX_STEPS, backbone_lr_factor=0.1,
                          warmup_iters=WARMUP, power=1.0)
    imnet = _imnet(params)
    state = jax_trainer.init_uda_state(params, batch_stats, tx)._replace(
        imnet_params=imnet)

    refined = []
    real_refine = jax_trainer.refine

    def capturing_refine(*a, **k):
        out = real_refine(*a, **k)
        jax.debug.callback(lambda x: refined.append(np.asarray(x)), out)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_dacs, "get_class_masks", _det_class_masks_jax)
    mp.setattr(jax_trainer, "refine", capturing_refine)
    try:
        step_fn = jax_trainer.make_uda_train_step(seg, align_bb, align_head,
                                                  tx, cfg)
        jax_logs, jax_norms, states = [], [], [state]
        for step in range(N_STEPS):
            state, logs = step_fn(state, batch_np, tree,
                                  jax.random.PRNGKey(step))
            jax_logs.append({k: float(v) for k, v in logs.items()})
            jax_norms.append(_sq_norm_jax(state.params))
            states.append(state)
        jax.effects_barrier()
    finally:
        mp.undo()

    port_refined = []
    mp = pytest.MonkeyPatch()
    port_real_refine = port_trainer.refine

    def port_capturing_refine(*a, **k):
        out = port_real_refine(*a, **k)
        port_refined.append(out.numpy().copy())
        return out

    mp.setattr(port_trainer, "refine", port_capturing_refine)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    try:
        with _one_thread():
            trainer = _port_trainer(student, UDAConfig(**CFG), align_net,
                                    imnet)
            port_logs, port_norms = [], []
            for _ in range(N_STEPS):
                logs = train_step(trainer, batch, _pinned_draws())
                port_logs.append({k: float(v) for k, v in logs.items()})
                port_norms.append(_sq_norm_port(trainer))
            # from the JAX state after N_STEPS - 1 steps, one more port step
            resumed = _port_trainer(_port_student(False, seed=9),
                                    UDAConfig(**CFG), align_net, imnet)
            load_uda_state(resumed, states[N_STEPS - 1])
            logs = train_step(resumed, batch, _pinned_draws())
            resumed_logs = {k: float(v) for k, v in logs.items()}
    finally:
        mp.undo()
    return dict(init=variables, jax_logs=jax_logs, jax_norms=jax_norms,
                refined=refined, states=states, port_logs=port_logs,
                port_norms=port_norms,
                port_refined=port_refined, trainer=trainer,
                resumed=resumed, resumed_logs=resumed_logs)


LOSS_KEYS = ("train_loss_src", "train_loss_featdist_src",
             "train_loss_uda_trg", "train_pseudo_weight", "train_loss_total")


@pytest.mark.parametrize("step", range(N_STEPS))
def test_losses_match_jax(trajectory, step):
    want, got = trajectory["jax_logs"][step], trajectory["port_logs"][step]
    assert want["train_loss_featdist_src"] > 1e-4  # the mask keeps pixels
    for key in LOSS_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                   err_msg=f"step {step} {key}")


def test_parameter_norm_trace_matches_jax(trajectory):
    np.testing.assert_allclose(trajectory["port_norms"],
                               trajectory["jax_norms"], rtol=NORM_RTOL)
    # the trajectory moves: each step changes the parameters
    assert len(set(trajectory["jax_norms"])) == N_STEPS


@pytest.mark.parametrize("step", [0, N_STEPS - 1])
def test_refined_probabilities_match_jax(trajectory, step):
    want = trajectory["refined"][step]
    got = trajectory["port_refined"][step]
    assert got.shape == want.shape == (B, H, W, 19)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROBS_ATOL)


def test_final_parameters_and_statistics_match_jax(trajectory):
    final = trajectory["states"][-1]
    student = trajectory["trainer"].state.student
    ref = Segmentor(MixVisionTransformer("mit_b0", drop_path_rate=0.0),
                    DAFormerHead(19, in_channels=[32, 64, 160, 256],
                                 channels=32, embed_dims=32))
    load_jax_variables(ref, {"params": final.params,
                             "batch_stats": final.batch_stats})
    want = ref.state_dict()
    for key, t in student.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)


def test_parameter_updates_match_jax(trajectory):
    """Each parameter's and BN statistic's change over the 3 steps against
    JAX's, relative to the size of JAX's change: the backbone group moves
    by ~1e-5 an element at its 0.1 learning-rate factor, below what the
    final parameters' absolute limit can see."""
    final = trajectory["states"][-1]
    _assert_updates_match(trajectory["init"],
                          {"params": final.params,
                           "batch_stats": final.batch_stats},
                          trajectory["trainer"].state.student, N_STEPS)


def test_resumed_from_jax_state_matches_jax_step(trajectory):
    """``load_uda_state`` carries the JAX state after 2 steps (Adam moments
    and count included); the port's third step then matches JAX's."""
    want = trajectory["jax_logs"][N_STEPS - 1]
    got = trajectory["resumed_logs"]
    for key in LOSS_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                   err_msg=key)
    resumed = trajectory["resumed"]
    assert resumed.state.step == N_STEPS
    np.testing.assert_allclose(_sq_norm_port(resumed),
                               trajectory["jax_norms"][-1], rtol=NORM_RTOL)


def test_hrda_step_matches_jax():
    """One Refign step with HRDA (LR + one HR crop per pass, the scale
    attention masked to the crop, the HR loss at weight 0.1) and the crop
    offsets of both passes pinned."""
    batch_np = _batch_np()
    # one class over the first image: at 64^2 the LR features are 2x2, so
    # only a pure 32-pixel cell of a feature-distance class keeps a pixel
    batch_np["semantic_src"][0] = 11
    align_bb, align_head, tree, align_net = _align_trees()
    seg, variables, student = _models(hrda=True)
    cfg_kw = dict(CFG, use_hrda=True)
    tx, _ = jax_optimizer(variables["params"], LR, WD, MAX_STEPS,
                          backbone_lr_factor=0.1, warmup_iters=WARMUP,
                          power=1.0)
    imnet = _imnet(variables["params"])
    state = _at_update_count(jax_trainer.init_uda_state(
        variables["params"], variables["batch_stats"], tx)._replace(
            imnet_params=imnet), HRDA_COUNT)
    trainer = _port_trainer(student, UDAConfig(**cfg_kw), align_net, imnet)
    load_uda_state(trainer, state)
    offsets = [(8, 24), (16, 0)]
    calls = iter(offsets)

    def pinned_offset(rng, H_, W_, divisible):
        return jnp.asarray(next(calls), jnp.int32)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_dacs, "get_class_masks", _det_class_masks_jax)
    mp.setattr(jax_trainer, "_hrda_crop_offset", pinned_offset)
    try:
        step_fn = jax_trainer.make_uda_train_step(
            seg, align_bb, align_head, tx, jax_trainer.UDAConfig(**cfg_kw))
        state, logs = step_fn(state, batch_np, tree, jax.random.PRNGKey(0))
        want = {k: float(v) for k, v in logs.items()}
    finally:
        mp.undo()
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    with _one_thread():
        got = {k: float(v) for k, v in train_step(
            trainer, batch, _pinned_draws(*offsets)).items()}
    assert want["train_loss_featdist_src"] > 1e-4
    for key in LOSS_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                   err_msg=key)
    assert trainer.state.step == HRDA_COUNT + 1
    np.testing.assert_allclose(_sq_norm_port(trainer),
                               _sq_norm_jax(state.params), rtol=NORM_RTOL)
    _assert_updates_match(variables, {"params": state.params,
                                      "batch_stats": state.batch_stats},
                          trainer.state.student, 1)


def test_config_defaults_match_jax():
    """The port's UDAConfig has the JAX one's fields and defaults."""
    want = {f.name: f.default for f in
            dataclasses.fields(jax_trainer.UDAConfig)}
    got = {f.name: f.default for f in dataclasses.fields(UDAConfig)}
    assert got == want
