"""The port's entry points build from the repo's YAML configs.

``refign_tpu_torch.entry`` reads each configuration from its file under
``configs/`` through ``config.py``, the code the CLI builds with.  Before
it did, ``entry.py`` held Python copies of those files; those copies are
the goldens here, moved verbatim:

* the step settings each file yields (``REFIGN_HRDA_STAR``,
  ``ALIGN_STAGES``, the DeepLabV2 file's) equal the old constants field
  for field, the normalisation constants as the same Python floats;
* every trainer and frozen model the entry points build equals, bit for
  bit, the one the old hand-written builders made from the same seed:
  ``state_dict`` keys, dtypes and bits, every module's settings, the
  optimizer's groups and the schedule;
* every segmentation file under ``configs/`` builds through
  ``build_uda_trainer(config=...)`` with no code of its own.

No JAX here; the whole file runs in seconds.
"""
from __future__ import annotations

import dataclasses
import functools
import glob
import os

import pytest
import torch

from refign_tpu_torch import entry
from refign_tpu_torch.alignment.trainer import (AlignConfig, AlignmentNet,
                                                init_align_state)
from refign_tpu_torch.models.heads.daformer import DAFormerHead
from refign_tpu_torch.models.heads.deeplabv2 import DeepLabV2Head
from refign_tpu_torch.models.heads.segformer import SegFormerHead
from refign_tpu_torch.models.heads.uawarpc import UAWarpCHead
from refign_tpu_torch.models.mix_transformer import MixVisionTransformer
from refign_tpu_torch.models.resnet import ResNet
from refign_tpu_torch.models.segmentor import Segmentor
from refign_tpu_torch.models.vgg import VGG
from refign_tpu_torch.parallel.mesh import cast_floating
from refign_tpu_torch.train.optim import (make_adam_optimizer,
                                          make_uda_optimizer)
from refign_tpu_torch.uda.trainer import UDAConfig, init_uda_state

# ---------------------------------------------------------------------------
# the goldens: entry.py's copies of the files before it read them
# ---------------------------------------------------------------------------

# the UDA settings of configs/cityscapes_acdc/refign_hrda_star.yaml
REFIGN_HRDA_STAR = UDAConfig(use_hrda=True, hrda_output_stride=4,
                             hr_loss_weight=0.1, use_refign=True,
                             use_align=True, adapt_to_ref=True, gamma=0.25,
                             enable_fdist=True)
# the model and optimizer settings of the same file
UDA_REMAT = True
UDA_DROP_PATH_RATE = 0.1
UDA_DROPOUT_RATIO = 0.1
UDA_BASE_LR = 6e-4
UDA_WEIGHT_DECAY = 0.01
UDA_POLY_POWER = 1.0
UDA_BACKBONE_LR_FACTOR = 0.1
# the UDA settings of configs/{cityscapes_acdc,cityscapes_darkzurich,
# cityscapes_robotcar}/refign_deeplabv2.yaml; their optimizer and schedule
# are the HRDA★ file's, and they set no drop path, dropout or with_cp
REFIGN_DEEPLABV2 = UDAConfig(use_hrda=False, use_refign=True,
                             use_align=True, adapt_to_ref=True, gamma=0.25,
                             enable_fdist=True)
# the model of the same files: ResNet-101 v1c, dilated to output stride 8,
# and the DeepLabV2 head on layer4
DEEPLABV2_STRIDES = (1, 2, 1, 1)
DEEPLABV2_DILATIONS = (1, 1, 2, 4)
DEEPLABV2_IN_INDEX = 3

# configs/megadepth/uawarpc_stage1.yaml as tasks/align_task.py reads it:
# 750^2 loads, the prime's ColorJitter 0.6/0.6/0.6/0, ChannelShuffle and
# GaussianBlur(p 0.2, k 7, sigma 0.2-2), CompositeFlow, CenterCrop 520,
# bf16 compute, remat_modules
UAWARPC_STAGE1 = AlignConfig(
    prime_jitter=(0.6, 0.6, 0.6, 0.0), prime_channel_shuffle=True,
    prime_blur=(0.2, 7, 0.2, 2.0), crop_after_flow=(520, 520),
    remat_modules=True)
# uawarpc_stage2.yaml: the visibility mask, larger perturbations and the
# elastic flow
UAWARPC_STAGE2 = dataclasses.replace(
    UAWARPC_STAGE1, visibility_mask=True, random_t_hom=0.4,
    random_t_tps=0.4, random_t_tps_for_afftps=0.26, add_elastic=True)
# each stage: the step's settings, and Adam's rate, L2 decay and
# MultiStepLR milestones
ALIGN_STAGES = {
    1: (UAWARPC_STAGE1, 1e-4, 4e-4, (250000, 325000)),
    2: (UAWARPC_STAGE2, 5e-5, 4e-4, (100000, 150000, 200000)),
}
ALIGN_LR_GAMMA = 0.5

# ---------------------------------------------------------------------------
# the old builders, in a few lines each: model classes, one generator,
# the old order
# ---------------------------------------------------------------------------


def _frozen(model, dtype):
    cast_floating(model, dtype)
    return model.eval().requires_grad_(False)


def old_alignment(seed, remat_modules=False):
    backbone = VGG("vgg16", out_indices=(2, 3, 4))
    head = UAWarpCHead(in_index=(0, 1), estimate_uncertainty=True,
                       remat_modules=remat_modules)
    gen = torch.Generator().manual_seed(seed)
    backbone.init_weights(gen)
    head.init_weights(gen)
    return AlignmentNet(backbone, head)


def old_hrda_segmentor(model_type, channels, seed, train):
    backbone = MixVisionTransformer(
        model_type=model_type,
        drop_path_rate=UDA_DROP_PATH_RATE if train else 0.0,
        **({"remat": UDA_REMAT} if train else {}))
    dims = backbone.embed_dims
    drop = {"dropout_ratio": UDA_DROPOUT_RATIO} if train else {}
    head = DAFormerHead(19, in_channels=dims, channels=channels,
                        embed_dims=channels, **drop)
    scale_attention = SegFormerHead(19, in_channels=dims, channels=channels,
                                    **drop)
    gen = torch.Generator().manual_seed(seed)
    for m in (backbone, head, scale_attention):
        m.init_weights(gen)
    return Segmentor(backbone, head, scale_attention,
                     **({"hrda_output_stride": 4} if train else {}))


def old_deeplabv2_segmentor(model_type, seed):
    backbone = ResNet(model_type, strides=DEEPLABV2_STRIDES,
                      dilations=DEEPLABV2_DILATIONS)
    head = DeepLabV2Head(19,
                         in_channels=backbone.out_channels[DEEPLABV2_IN_INDEX],
                         in_index=DEEPLABV2_IN_INDEX)
    gen = torch.Generator().manual_seed(seed)
    backbone.init_weights(gen)
    head.init_weights(gen)
    return Segmentor(backbone, head)


def old_uda_trainer(model_type="mit_b0", channels=32, seed=0):
    """The train state and the alignment network as the old
    ``build_uda_trainer`` made them for a MiT."""
    student = old_hrda_segmentor(model_type, channels, seed, train=True)
    opt, sched = make_uda_optimizer(
        student, UDA_BASE_LR, UDA_WEIGHT_DECAY, 40000,
        backbone_lr_factor=UDA_BACKBONE_LR_FACTOR, warmup_iters=1500,
        power=UDA_POLY_POWER)
    state = init_uda_state(student, opt, sched, REFIGN_HRDA_STAR.enable_fdist)
    align = _frozen(old_alignment(seed + 1), REFIGN_HRDA_STAR.dtype)
    return state, align


def old_align_trainer(stage, seed=0):
    cfg, lr, wd, milestones = ALIGN_STAGES[stage]
    net = old_alignment(seed, remat_modules=cfg.remat_modules)
    opt, sched = make_adam_optimizer(net.head.parameters(), lr, milestones,
                                     gamma=ALIGN_LR_GAMMA, weight_decay=wd)
    return init_align_state(net.backbone, net.head, opt, sched, cfg.dtype)

# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def assert_same_fields(got, want):
    """Field for field; a float field stays a float."""
    assert type(got) is type(want)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g == w, f.name
        assert isinstance(g, float) == isinstance(w, float), f.name


def settings(module):
    """Every submodule's class, mode and non-tensor attributes."""
    out = {}
    for name, m in module.named_modules():
        out[name] = (type(m).__name__, m.training, {
            k: getattr(v, "__qualname__", v) for k, v in vars(m).items()
            if not k.startswith("_") and k != "training"
            and not isinstance(v, (torch.Tensor, torch.nn.Module))})
    return out


def assert_same_module(got, want, skip=()):
    sg, sw = settings(got), settings(want)
    for name, attr in skip:
        sg[name][2].pop(attr)
        sw[name][2].pop(attr)
    assert sg == sw
    a, b = got.state_dict(), want.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k
    assert [(n, p.requires_grad) for n, p in got.named_parameters()] == \
        [(n, p.requires_grad) for n, p in want.named_parameters()]


def groups(optimizer, module):
    names = {id(p): n for n, p in module.named_parameters()}
    return [{k: ([names[id(p)] for p in v] if k == "params" else v)
             for k, v in g.items()} for g in optimizer.param_groups]


def schedule(scheduler):
    return {k: v for k, v in vars(scheduler).items() if k != "optimizer"}

# ---------------------------------------------------------------------------
# (a) the derived settings
# ---------------------------------------------------------------------------


def _check_uda(name, want):
    task = entry.load_task(f"cityscapes_acdc/{name}.yaml")
    assert_same_fields(task.uda_cfg, want)
    assert (task.opt.name, task.opt.lr, task.opt.weight_decay) == \
        ("AdamW", UDA_BASE_LR, UDA_WEIGHT_DECAY)
    assert (task.sched.warmup_iters, task.sched.power,
            task.sched.max_steps) == (1500, UDA_POLY_POWER, 40000)
    assert task.backbone_lr_factor == UDA_BACKBONE_LR_FACTOR
    return task


def _check_hrda_star():
    task = _check_uda("refign_hrda_star", REFIGN_HRDA_STAR)
    assert_same_fields(entry.REFIGN_HRDA_STAR, REFIGN_HRDA_STAR)
    # the Python floats, not the fp32 values the data section's Normalize
    # yields (0.48500001430511475, ...), and normalisation off the device
    assert entry.REFIGN_HRDA_STAR.device_normalize is False
    assert entry.REFIGN_HRDA_STAR.norm_mean == (0.485, 0.456, 0.406)
    assert entry.REFIGN_HRDA_STAR.norm_std == (0.229, 0.224, 0.225)
    bb = task.margs["backbone"]["init_args"]
    assert bb.get("remat") is UDA_REMAT
    assert bb.get("drop_path_rate", UDA_DROP_PATH_RATE) == UDA_DROP_PATH_RATE


def _check_deeplabv2():
    task = _check_uda("refign_deeplabv2", REFIGN_DEEPLABV2)
    bb = task.margs["backbone"]["init_args"]
    assert tuple(bb["strides"]) == DEEPLABV2_STRIDES
    assert tuple(bb["dilations"]) == DEEPLABV2_DILATIONS
    assert task.margs["head"]["init_args"]["in_index"] == DEEPLABV2_IN_INDEX


def _check_stage(stage):
    got = entry.ALIGN_STAGES[stage]
    want = ALIGN_STAGES[stage]
    assert_same_fields(got[0], want[0])
    assert got[1:] == want[1:]
    assert isinstance(got[1], float) and isinstance(got[2], float)
    task = entry.load_task(f"megadepth/uawarpc_stage{stage}.yaml")
    assert task.sched.gamma == ALIGN_LR_GAMMA


SETTINGS_CHECKS = {"refign_hrda_star": _check_hrda_star,
                   "refign_deeplabv2": _check_deeplabv2,
                   "uawarpc_stage1": functools.partial(_check_stage, 1),
                   "uawarpc_stage2": functools.partial(_check_stage, 2)}


@pytest.mark.parametrize("name", sorted(SETTINGS_CHECKS))
def test_settings_read_from_the_file_equal_the_old_copies(name):
    SETTINGS_CHECKS[name]()

# ---------------------------------------------------------------------------
# (b), (c) the trainers
# ---------------------------------------------------------------------------


def test_uda_trainer_equals_the_old_build():
    tr = entry.build_uda_trainer("mit_b0", channels=32, device="cpu")
    state, align = old_uda_trainer("mit_b0", channels=32, seed=0)
    assert_same_fields(tr.cfg, REFIGN_HRDA_STAR)
    for what in ("student", "teacher", "imnet"):
        assert_same_module(getattr(tr.state, what), getattr(state, what))
    assert_same_module(tr.align_net, align)
    assert groups(tr.state.optimizer, tr.state.student) == \
        groups(state.optimizer, state.student)
    assert schedule(tr.state.scheduler) == schedule(state.scheduler)
    assert tr.state.step == state.step == 0
    assert tr.dropout_gen.device == torch.device("cpu")


@pytest.mark.parametrize("stage", [1, 2])
def test_align_trainer_equals_the_old_build(stage):
    """The head's ``iterative_refinement`` is the file's True (the old
    builder left it False): an eval-only switch with no parameter, which
    the train step, in train mode, never reads."""
    tr = entry.build_align_trainer(stage, device="cpu")
    state = old_align_trainer(stage)
    assert_same_fields(tr.cfg, ALIGN_STAGES[stage][0])
    assert tr.state.head.iterative_refinement is True
    assert tr.state.head.training
    assert_same_module(tr.state.backbone, state.backbone)
    assert_same_module(tr.state.head, state.head,
                       skip=[("", "iterative_refinement")])
    assert groups(tr.state.optimizer, tr.state.head) == \
        groups(state.optimizer, state.head)
    assert schedule(tr.state.scheduler) == schedule(state.scheduler)

# ---------------------------------------------------------------------------
# (d) the frozen models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what", ["hrda_star", "deeplabv2", "alignment"])
def test_frozen_model_equals_the_old_build(what):
    if what == "hrda_star":
        got = entry.build_hrda_star("mit_b0", channels=32,
                                    dtype=torch.float32, device="cpu")
        want = old_hrda_segmentor("mit_b0", 32, 0, train=False)
        # the measured slide path: no drop path, no remat
        assert not got.backbone.remat
        assert all(m.drop_prob == 0.0 for m in got.backbone.modules()
                   if type(m).__name__ == "DropPath")
        dtype = torch.float32
    elif what == "deeplabv2":
        got = entry.build_deeplabv2("resnet18_v1c", dtype=torch.float32,
                                    device="cpu", seed=1)
        want = old_deeplabv2_segmentor("resnet18_v1c", 1)
        dtype = torch.float32
    else:
        got = entry.build_alignment(dtype=torch.bfloat16, device="cpu",
                                    seed=2)
        want = old_alignment(2)
        dtype = torch.bfloat16
    assert_same_module(got, _frozen(want, dtype))

# ---------------------------------------------------------------------------
# (e) any segmentation file, no code of its own
# ---------------------------------------------------------------------------

CONFIGS = sorted(
    os.path.relpath(p, entry.CONFIGS)
    for p in glob.glob(os.path.join(entry.CONFIGS, "**", "*.yaml"),
                       recursive=True)
    if "DomainAdaptationSegmentationModel" in open(p).read())


@pytest.mark.parametrize("config", CONFIGS)
def test_every_segmentation_file_builds_through_entry(config):
    spec = entry.load_spec(config)
    margs = spec["model"]["init_args"]
    resnet = margs["backbone"]["class_path"].endswith("ResNet")
    tr = entry.build_uda_trainer(
        config=config, model_type="resnet18_v1c" if resnet else "mit_b0",
        channels=32, device="cpu")
    task = entry.load_task(config)
    assert tr.cfg == task.uda_cfg
    student = tr.state.student
    assert type(student.head).__name__ == \
        margs["head"]["class_path"].rsplit(".", 1)[-1]
    assert (student.scale_attention is not None) == bool(
        margs.get("use_hrda") and margs.get("hrda_scale_attention"))
    assert (tr.align_net is not None) == task.has_align
    assert tr.state.scheduler.kw["max_steps"] == task.sched.max_steps
