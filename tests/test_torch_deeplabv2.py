"""The port's DeepLabV2 (refign_tpu_torch/models/heads/deeplabv2.py with the
ResNet v1c of models/resnet.py), its IoU metrics (refign_tpu_torch/
metrics.py) and its Refign UDA step with a BatchNorm backbone against the
JAX package, fp32 on the CPU.

Weights come from the port's seeded init with every BatchNorm's scale,
bias and running statistics drawn at random (``test_torch_resnet.
randomize_bn_``), carried to JAX by the JAX package's ``convert_state_dict``.

* the head: the sum of the four dilated convs, at 1e-5;
* ``Segmentor.whole`` (eval and train BatchNorm) and
  ``logits_and_features`` with ResNet + DeepLabV2 (strides (1, 2, 1, 1),
  dilations (1, 1, 2, 4), head on layer4), within 1e-4 of the largest
  |value| (train-mode resnet50: + 5x JAX's own floor, as in
  ``tests/test_torch_resnet.py``);
* ``iou_update`` / ``iou_compute`` against ``refign_tpu/metrics.py`` on
  logits and on indices with ignored pixels: the confusion matrix and the
  scores exactly;
* a short UDA trajectory against ``make_uda_train_step``: resnet18_v1c
  (stem and base width 16) + DeepLabV2, B=2, 64^2, the Refign branch with
  the frozen VGG-16 + UAWarpC, the ImageNet feature distance on layer4,
  every draw pinned as ``tests/test_torch_uda_trajectory.py`` pins them
  (its helpers): the losses per step, the student's BatchNorm statistics
  (batch statistics in both passes, the mixed pass's update following the
  source pass's), the ImageNet copy's statistics (eval BatchNorm on the
  init statistics, unchanged), the final parameters and each entry's
  change from the init, and one step resumed from a JAX state through
  ``load_uda_state``.  Tolerances are that file's, stated there, with one
  difference: the student's train-mode BatchNorm over 8x8 maps makes some
  gradient elements rounding noise, and Adam's first updates (about the
  learning rate whatever the gradient's size) give each such element a
  full update of either sign.  JAX's own trajectory moves by that much when
  the source image moves by one ulp (readings on the CPU: final parameters
  by 8.7e-5, an entry's change by 0.11 of its size, where the port differs
  from JAX by 8.0e-5 and 0.10), so the final parameters and the changes are
  held to the trajectory file's limit + 5x JAX's largest such movement, and
  the median entry's change to its limit + 5x the median movement.  The
  losses keep that file's limit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refign_tpu  # noqa: F401  (fp32 matmul precision for the JAX side)
import refign_tpu.metrics as jax_metrics
import refign_tpu.uda.dacs as jax_dacs
import refign_tpu.uda.trainer as jax_trainer
import test_torch_uda_trajectory as traj
from refign_tpu.models.heads.deeplabv2 import DeepLabV2Head as JaxDeepLabV2
from refign_tpu.models.resnet import ResNet as JaxResNet
from refign_tpu.models.segmentor import Segmentor as JaxSegmentor
from refign_tpu.train.optim import make_uda_optimizer as jax_optimizer
from refign_tpu.utils.torch_convert import convert_state_dict
from refign_tpu_torch import metrics
from refign_tpu_torch.entry import (DEEPLABV2_DILATIONS, DEEPLABV2_STRIDES,
                                    REFIGN_DEEPLABV2, build_deeplabv2,
                                    build_uda_trainer, deeplabv2_forward,
                                    deeplabv2_segmentor)
from refign_tpu_torch.models.resnet import ResNet
from refign_tpu_torch.nn.layers import TorchBatchNorm
from refign_tpu_torch.models.heads.deeplabv2 import DeepLabV2Head
from refign_tpu_torch.uda.trainer import UDAConfig, train_step
from refign_tpu_torch.utils.jax_convert import (load_jax_variables,
                                                load_uda_state)
from test_torch_resnet import (REL, _floor, _ulp, assert_close_rel,
                               randomize_bn_)

NARROW = dict(stem_channels=16, base_channels=16)
N_STEPS = 3
FLOOR_FACTOR = 5
CFG = dict(traj.CFG, use_hrda=False)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_segmentor(model_type="resnet18_v1c", **kw):
    return JaxSegmentor(
        backbone=JaxResNet(model_type=model_type, strides=DEEPLABV2_STRIDES,
                           dilations=DEEPLABV2_DILATIONS, **kw),
        head=JaxDeepLabV2(num_classes=19, in_index=3))


def _port_segmentor(model_type="resnet18_v1c", seed=0):
    seg = deeplabv2_segmentor(model_type, 19, seed, **NARROW)
    randomize_bn_(seg, seed + 1)
    return seg


def _variables(module):
    return jax.tree_util.tree_map(np.array,
                                  convert_state_dict(module.state_dict()))


def test_head_matches_jax():
    head = DeepLabV2Head(19, in_channels=48, in_index=3)
    head.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for conv in head.conv2d_list:
            conv.bias.normal_(generator=torch.Generator().manual_seed(1))
    feats = [_rand(i, 2, 13, 17, 48) for i in range(4)]
    want = JaxDeepLabV2(num_classes=19, in_index=3).apply(
        _variables(head), feats)
    got = head([torch.from_numpy(f) for f in feats])
    assert got.shape == (2, 13, 17, 19)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("model_type", ["resnet18_v1c", "resnet50_v1c"])
@pytest.mark.parametrize("train", [False, True])
def test_whole_matches_jax(model_type, train):
    """``Segmentor.whole``: logits upsampled to the input (eval BatchNorm,
    and train BatchNorm as the EMA teacher runs it)."""
    seg = _port_segmentor(model_type)
    jseg = _jax_segmentor(model_type, **NARROW)
    x = _rand(3, 2, 65, 97, 3)
    floor = 0.0
    if train:
        def whole(x):
            return jseg.apply(_variables(seg), x, train=True,
                              mutable=["batch_stats"],
                              method=JaxSegmentor.whole)[0]
        want = whole(x)
        # train-mode BatchNorm: JAX's own floor, as in test_torch_resnet.py
        floor = _floor(want, whole(_ulp(x)))
    else:
        want = jseg.apply(_variables(seg), x, method=JaxSegmentor.whole)
    seg.train(train)
    with torch.no_grad():
        got = seg.whole(torch.from_numpy(x))
    assert got.shape == (2, 65, 97, 19)
    assert_close_rel(got.numpy(), want, REL + FLOOR_FACTOR * floor)


def test_logits_and_features_match_jax():
    """The student's train-mode forward: head logits at 1/8 and the four
    stage features, and the running statistics it leaves."""
    seg = _port_segmentor()
    jseg = _jax_segmentor(**NARROW)
    x = _rand(4, 2, 64, 64, 3)
    (want, want_feats), mut = jseg.apply(
        _variables(seg), x, train=True, mutable=["batch_stats"],
        method=JaxSegmentor.logits_and_features)
    seg.train()
    with torch.no_grad():
        got, feats = seg.logits_and_features(torch.from_numpy(x))
    assert got.shape == (2, 8, 8, 19)
    assert_close_rel(got.numpy(), want)
    assert [f.shape[-1] for f in feats] == [16, 32, 64, 128]
    for f, w in zip(feats, want_feats):
        assert_close_rel(f.numpy(), w)
    ref = _port_segmentor()
    load_jax_variables(ref, {"params": _variables(seg)["params"],
                             "batch_stats": mut["batch_stats"]})
    for key, t in ref.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(seg.state_dict()[key].numpy(),
                                       t.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=key)


def _labels(seed, B=2, H=23, W=31, C=19):
    rng = np.random.RandomState(seed)
    target = rng.randint(0, C, size=(B, H, W))
    target[rng.rand(B, H, W) < 0.2] = 255
    target[:, :, :3] = 255  # a strip of ignored pixels
    return target.astype(np.int64)


@pytest.mark.parametrize("preds", ["logits", "indices"])
def test_iou_matches_jax(preds):
    """Two batches accumulated, then the scores: macro and per class, over
    all classes and over the present ones (class 18 absent from the
    targets, class 17 absent everywhere)."""
    C = 19
    conf_jax = jax_metrics.iou_init(C)
    conf = metrics.iou_init(C)
    for seed in (0, 1):
        target = _labels(seed)
        target[target == 18] = 255
        target[target == 17] = 255
        logits = _rand(seed + 10, *target.shape, C)
        logits[..., 17] = -1e3
        p = logits if preds == "logits" else logits.argmax(-1)
        conf_jax = jax_metrics.iou_update(conf_jax, jnp.asarray(p),
                                          jnp.asarray(target))
        conf = metrics.iou_update(conf, torch.from_numpy(p),
                                  torch.from_numpy(target))
    assert conf.dtype == torch.int64
    np.testing.assert_array_equal(conf.numpy(), np.asarray(conf_jax))
    for average in ("macro", "none"):
        for over in (False, True):
            want = np.asarray(jax_metrics.iou_compute(
                conf_jax, average, over_present_classes=over))
            got = metrics.iou_compute(conf, average,
                                      over_present_classes=over).numpy()
            np.testing.assert_array_equal(got, want)


def test_deeplabv2_config_matches_the_yaml():
    """``REFIGN_DEEPLABV2``: the JAX config's fields, no HRDA, Refign with
    align, adapt-to-reference, gamma 0.25 and the feature distance."""
    want = jax_trainer.UDAConfig(use_hrda=False, use_refign=True,
                                 use_align=True, adapt_to_ref=True,
                                 gamma=0.25, enable_fdist=True)
    for field in ("use_hrda", "use_refign", "use_align", "adapt_to_ref",
                  "gamma", "enable_fdist", "fdist_lambda", "compute_dtype"):
        assert getattr(REFIGN_DEEPLABV2, field) == getattr(want, field)


def test_entry_points_build_the_configuration():
    """``build_deeplabv2`` / ``deeplabv2_forward`` (eval, whole-image
    logits) and ``build_uda_trainer`` with a ResNet: the DeepLabV2 student
    of the yaml, no HRDA, the teacher's BatchNorm on batch statistics
    without updates, the ImageNet copy in eval mode, and AdamW in the four
    groups, every rank-1 parameter (BatchNorm scale and bias, head bias)
    without weight decay, the backbone at 0.1 of the rate."""
    model = build_deeplabv2("resnet18_v1c", dtype=torch.float32,
                            device="cpu")
    assert not model.training
    out = deeplabv2_forward(model, torch.from_numpy(_rand(0, 1, 45, 61, 3)))
    assert out.shape == (1, 45, 61, 19) and torch.isfinite(out).all()

    tr = build_uda_trainer("resnet18_v1c", device="cpu")
    assert tr.cfg == REFIGN_DEEPLABV2 and tr.align_net is not None
    student, teacher = tr.state.student, tr.state.teacher
    assert isinstance(student.backbone, ResNet)
    assert student.scale_attention is None and student.head.in_index == 3
    assert student.backbone.layer4[0].conv1.dilation == (4, 4)
    assert student.training and teacher.training
    assert not tr.state.imnet.training
    assert all(not m.update_stats for m in teacher.modules()
               if isinstance(m, TorchBatchNorm))
    names = {id(p): n for n, p in student.named_parameters()}
    groups = {g["label"]: g for g in tr.state.optimizer.param_groups}
    assert sorted(groups) == ["backbone_bias", "backbone_weight",
                              "head_bias", "head_weight"]
    for label, g in groups.items():
        assert g["weight_decay"] == (0.0 if label.endswith("bias")
                                     else 0.01)
        assert g["base_lr"] == pytest.approx(
            6e-4 * (0.1 if label.startswith("backbone") else 1.0))
        for p in g["params"]:
            assert (p.dim() <= 1) == label.endswith("bias"), names[id(p)]
    assert sum(len(g["params"]) for g in groups.values()) == len(names)


def _stats(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.fixture(scope="module")
def trajectory():
    batch_np = traj._batch_np()
    align_bb, align_head, tree, align_net = traj._align_trees()
    student = _port_segmentor()
    variables = _variables(student)
    seg = _jax_segmentor(**NARROW)
    params, batch_stats = variables["params"], variables["batch_stats"]
    cfg = jax_trainer.UDAConfig(**CFG)
    tx, _ = jax_optimizer(params, traj.LR, traj.WD, traj.MAX_STEPS,
                          backbone_lr_factor=0.1, warmup_iters=traj.WARMUP,
                          power=1.0)
    imnet = traj._imnet(params)
    state = jax_trainer.init_uda_state(params, batch_stats, tx)._replace(
        imnet_params=imnet)
    imnet_stats = state.imnet_batch_stats

    # JAX's trajectory, and the same from a source image moved by one ulp
    # (JAX's own floor)
    nudged = dict(batch_np)
    sign = np.random.RandomState(5).choice([-1.0, 1.0],
                                           batch_np["image_src"].shape)
    nudged["image_src"] = (batch_np["image_src"]
                           * (1 + sign * 2.0 ** -23)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_dacs, "get_class_masks", traj._det_class_masks_jax)
    try:
        step_fn = jax_trainer.make_uda_train_step(seg, align_bb, align_head,
                                                  tx, cfg)
        jax_logs, states = [], [state]
        for step in range(N_STEPS):
            state, logs = step_fn(state, batch_np, tree,
                                  jax.random.PRNGKey(step))
            jax_logs.append({k: float(v) for k, v in logs.items()})
            states.append(state)
        moved = states[0]
        for step in range(N_STEPS):
            moved, _ = step_fn(moved, nudged, tree, jax.random.PRNGKey(step))
    finally:
        mp.undo()

    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    trainer = traj._port_trainer(student, UDAConfig(**CFG), align_net,
                                 imnet, imnet_stats)
    imnet_before = _stats(trainer.state.imnet)
    port_logs = []
    for _ in range(N_STEPS):
        logs = train_step(trainer, batch, traj._pinned_draws())
        port_logs.append({k: float(v) for k, v in logs.items()})
    resumed = traj._port_trainer(_port_segmentor(seed=9),
                                 UDAConfig(**CFG), align_net, imnet,
                                 imnet_stats)
    load_uda_state(resumed, states[N_STEPS - 1])
    logs = train_step(resumed, batch, traj._pinned_draws())
    resumed_logs = {k: float(v) for k, v in logs.items()}
    return dict(init=variables, jax_logs=jax_logs, states=states,
                moved=moved, port_logs=port_logs, trainer=trainer,
                imnet_before=imnet_before, resumed=resumed,
                resumed_logs=resumed_logs)


@pytest.mark.parametrize("step", range(N_STEPS))
def test_losses_match_jax(trajectory, step):
    want, got = trajectory["jax_logs"][step], trajectory["port_logs"][step]
    assert want["train_loss_featdist_src"] > 1e-4  # the mask keeps pixels
    for key in traj.LOSS_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=traj.LOSS_RTOL,
                                   err_msg=f"step {step} {key}")


def _state_dict(state):
    """A JAX train state's student on the port's state_dict keys."""
    ref = _port_segmentor()
    load_jax_variables(ref, {"params": state.params,
                             "batch_stats": state.batch_stats})
    return ref.state_dict()


def _variables_of(state):
    return {"params": state.params, "batch_stats": state.batch_stats}


def test_final_parameters_and_statistics_match_jax(trajectory):
    """The student's parameters and BatchNorm statistics after the three
    steps (the statistics moved by six train-mode passes), within the
    trajectory file's limit + 5x JAX's own largest movement."""
    student = trajectory["trainer"].state.student
    want = _state_dict(trajectory["states"][-1])
    moved = _state_dict(trajectory["moved"])
    floor = max(float((moved[k] - want[k]).abs().max()) for k in want)
    init = _port_segmentor().state_dict()
    n_moved = 0
    for key, t in student.state_dict().items():
        np.testing.assert_allclose(
            t.numpy(), want[key].numpy(), rtol=0,
            atol=traj.PARAM_ATOL + FLOOR_FACTOR * floor, err_msg=key)
        if key.endswith(("running_mean", "running_var")):
            n_moved += not torch.equal(t, init[key])
    assert n_moved == sum(k.endswith(("running_mean", "running_var"))
                          for k in init)


def test_imnet_statistics_stay_frozen(trajectory):
    """The ImageNet copy runs eval BatchNorm on the init statistics: they
    are those of the JAX state (``imnet_batch_stats``) and do not move."""
    imnet = trajectory["trainer"].state.imnet
    assert not imnet.training
    after = _stats(imnet)
    for key, t in trajectory["imnet_before"].items():
        assert torch.equal(after[key], t), key
    want = trajectory["states"][-1].imnet_batch_stats
    ref = _port_segmentor().backbone
    load_jax_variables(ref, {"params": trajectory["states"][-1].imnet_params,
                             "batch_stats": want})
    for key, t in _stats(ref).items():
        assert torch.equal(after[key], t), key


def test_parameter_updates_match_jax(trajectory):
    """Each parameter's and BatchNorm statistic's change over the three
    steps against JAX's, relative to the size of JAX's change (the
    trajectory test's rule), within its limit + 5x JAX's own largest
    movement, and the median entry within its limit + 5x the median
    movement."""
    init = trajectory["init"]
    want = _variables_of(trajectory["states"][-1])
    nudged = _port_segmentor()
    load_jax_variables(nudged, _variables_of(trajectory["moved"]))
    floor, _, _ = traj._update_errors(init, want, nudged, N_STEPS,
                                      _port_segmentor)
    student = trajectory["trainer"].state.student
    traj._assert_updates_match(
        init, want, student, N_STEPS, make_ref=_port_segmentor,
        rtol=traj.UPDATE_RTOL + FLOOR_FACTOR * max(floor.values()))
    errors, _, _ = traj._update_errors(init, want, student, N_STEPS,
                                       _port_segmentor)
    assert np.median(list(errors.values())) <= (
        traj.UPDATE_RTOL + FLOOR_FACTOR * np.median(list(floor.values())))


def test_resumed_from_jax_state_matches_jax_step(trajectory):
    """``load_uda_state`` carries the JAX state after two steps (student,
    teacher, ImageNet copy with its statistics, Adam moments and count);
    the port's third step then matches JAX's."""
    want = trajectory["jax_logs"][N_STEPS - 1]
    got = trajectory["resumed_logs"]
    for key in traj.LOSS_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=traj.LOSS_RTOL,
                                   err_msg=key)
    assert trajectory["resumed"].state.step == N_STEPS
