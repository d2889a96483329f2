"""The port's config system, fit-loop cadence, gradient accumulation and
override parsing against the JAX package's."""
import copy
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))

def test_every_config_is_covered():
    assert len(CONFIGS) == 17


def _pipeline(dm):
    return {stage: [[type(t).__name__ for t in c["transforms"].transforms]
                    for c in dm.stage_config[stage]]
            for stage in ("train", "val", "test", "predict")}


def _num_classes(m):
    """A segmentation head's class count (the JAX module's field; the
    port's heads hold it in their classifier's width)."""
    if hasattr(m, "num_classes"):
        return m.num_classes
    for name in ("conv_seg", "linear_pred"):
        if hasattr(m, name):
            return getattr(m, name).weight.shape[0]
    if hasattr(m, "conv2d_list"):
        return m.conv2d_list[0].weight.shape[0]
    return None


def _module_desc(m):
    return (type(m).__name__, getattr(m, "model_type", None),
            _num_classes(m))


@pytest.mark.parametrize("path", CONFIGS)
def test_build_task_matches_jax(path):
    from refign_tpu.config import build_task as jbuild
    from refign_tpu_torch.config import (backbone_widths, build_backbone,
                                         build_head)
    from refign_tpu_torch.config import build_task as pbuild
    with open(os.path.join(REPO, path)) as f:
        cfg = yaml.safe_load(f)
    jtask, jdm = jbuild(copy.deepcopy(cfg), data_dir="/data")
    ptask, pdm = pbuild(copy.deepcopy(cfg), data_dir="/data", device="cpu")
    assert type(ptask).__name__ == type(jtask).__name__
    assert dataclasses.asdict(ptask.opt) == dataclasses.asdict(jtask.opt)
    assert dataclasses.asdict(ptask.sched) == dataclasses.asdict(jtask.sched)
    assert ptask.metrics_cfg == jtask.metrics_cfg
    assert ptask.pretrained == jtask.pretrained
    for attr in ("stage_on", "batch_size", "val_batch_size",
                 "test_batch_size", "num_workers", "data_dirs",
                 "device_normalize", "normalize_settings",
                 "composite_flow_settings", "prime_photometric_settings"):
        assert getattr(pdm, attr) == getattr(jdm, attr), attr
    assert _pipeline(pdm) == _pipeline(jdm)
    for stage in ("train", "val", "test", "predict"):
        for jc, pc in zip(jdm.stage_config[stage], pdm.stage_config[stage]):
            assert ({k: v for k, v in pc.items() if k != "transforms"}
                    == {k: v for k, v in jc.items() if k != "transforms"})
    margs = cfg["model"]["init_args"]
    if type(jtask).__name__ == "SegTask":
        jcfg = dataclasses.asdict(jtask.uda_cfg)
        pcfg = dataclasses.asdict(ptask.uda_cfg)
        assert pcfg == {k: jcfg[k] for k in pcfg}
        for attr in ("backbone_lr_factor", "use_slide_inference",
                     "inference_crop_size", "inference_stride",
                     "num_classes"):
            assert getattr(ptask, attr) == getattr(jtask, attr), attr
        backbone, pre = build_backbone(margs["backbone"])
        assert pre == jtask.backbone_pretrained
        assert _module_desc(backbone) == _module_desc(jtask.backbone)
        head, _ = build_head(margs["head"], backbone_widths(backbone))
        assert _module_desc(head) == _module_desc(jtask.head)
        if jtask.segmentor.scale_attention is not None:
            sa, _ = build_head(margs["hrda_scale_attention"],
                               backbone_widths(backbone))
            assert _module_desc(sa) == _module_desc(
                jtask.segmentor.scale_attention)
        assert ptask.has_align == (jtask.align_backbone is not None)
        pairs = []
        if ptask.has_align:
            ab, abp = build_backbone(margs["alignment_backbone"])
            ah, ahp = build_head(margs["alignment_head"])
            assert (abp, ahp) == (jtask.align_backbone_pretrained,
                                  jtask.align_head_pretrained)
            pairs = [(ab, jtask.align_backbone), (ah, jtask.align_head)]
    else:
        jcfg = dataclasses.asdict(jtask.align_cfg)
        pcfg = dataclasses.asdict(ptask.align_cfg)
        assert pcfg == {k: (tuple(jcfg[k]) if isinstance(jcfg[k], list)
                            else jcfg[k]) for k in pcfg}
        ab, abp = build_backbone(margs["alignment_backbone"])
        ah, ahp = build_head(margs["alignment_head"])
        assert (abp, ahp) == (jtask.backbone_pretrained,
                              jtask.head_pretrained)
        pairs = [(ab, jtask.backbone), (ah, jtask.head)]
    for p, j in pairs:
        assert _module_desc(p) == _module_desc(j)
        for attr in ("out_indices", "in_index", "estimate_uncertainty",
                     "iterative_refinement"):
            if hasattr(j, attr):
                assert tuple(np.atleast_1d(getattr(p, attr))) == tuple(
                    np.atleast_1d(getattr(j, attr))), attr


# ---------------------------------------------------------------------------
# fit-loop cadence
# ---------------------------------------------------------------------------

CADENCES = [
    ({"max_steps": 10, "val_every_n_steps": 4, "log_every_n_steps": 3}, 0),
    ({"max_steps": 7, "log_every_n_steps": 2, "callbacks": [
        {"class_path": "helpers.callbacks.ValEveryNSteps",
         "init_args": {"every_n_steps": 3}}]}, 0),
    ({"max_steps": 5}, 0),
    ({"max_steps": 9, "val_every_n_steps": 4, "log_every_n_steps": 5}, 2),
]


@pytest.mark.parametrize("trainer_cfg,start", CADENCES)
def test_fit_bookkeeper_cadence_matches_jax(tmp_path, monkeypatch,
                                            trainer_cfg, start):
    import refign_tpu.train.loop as JL
    from refign_tpu_torch.train.loop import FitBookkeeper
    events = {"jax": [], "port": []}
    monkeypatch.setattr(JL, "save_checkpoint",
                        lambda d, s, step: events["jax"].append(
                            ("save", step)))
    sched = lambda s: 0.1 * (s + 1)  # noqa: E731
    jbk = JL.FitBookkeeper(str(tmp_path / "j"), trainer_cfg, sched,
                           lambda hs: {"val_x_IoU": 0.5}, 40000)
    pbk = FitBookkeeper(str(tmp_path / "p"), trainer_cfg, sched,
                        lambda: {"val_x_IoU": 0.5},
                        lambda step: events["port"].append(("save", step)),
                        40000)
    assert (pbk.max_steps, pbk.val_every, pbk.log_every) == (
        jbk.max_steps, jbk.val_every, jbk.log_every)
    for step in range(start, jbk.max_steps):
        logs = {"train_loss_total": float(step)}
        jbk.on_step(step, start, {"w": np.zeros(2)}, dict(logs))
        pbk.on_step(step, start, {"train_loss_total": torch.tensor(
            float(step))})
    jbk.finish({"w": np.zeros(2)})
    pbk.finish()

    def lines(d):
        out = []
        for line in open(os.path.join(d, "metrics.jsonl")):
            row = json.loads(line)
            row.pop("sps", None)
            out.append(row)
        return out

    assert lines(tmp_path / "p") == lines(tmp_path / "j")
    # the JAX loop writes the final state twice when the last step
    # validated; the port writes it once
    assert sorted(set(events["port"])) == sorted(set(events["jax"]))
    assert len(events["port"]) == len(set(events["port"]))
    timing = [json.loads(l) for l in open(tmp_path / "p" / "timing.jsonl")]
    assert timing == []  # no step start given


def test_accumulate_steps_matches_optax_multisteps():
    import jax.numpy as jnp
    import optax
    from refign_tpu.train.optim import make_uda_optimizer as jmake
    from refign_tpu_torch.train.optim import make_uda_optimizer as pmake
    rng = np.random.RandomState(0)
    init = {"backbone": {"w": rng.randn(3, 4).astype(np.float32),
                         "b": rng.randn(4).astype(np.float32)},
            "head": {"w": rng.randn(4, 2).astype(np.float32),
                     "b": rng.randn(2).astype(np.float32)}}
    grads = [{g: {k: rng.randn(*v.shape).astype(np.float32)
                  for k, v in init[g].items()} for g in init}
             for _ in range(4)]
    kw = dict(base_lr=0.01, weight_decay=0.05, max_steps=10,
              backbone_lr_factor=0.1, warmup_iters=1, power=1.0,
              accumulate_steps=2)
    params = {g: {k: jnp.asarray(v) for k, v in d.items()}
              for g, d in init.items()}
    tx, _ = jmake(params, **kw)
    st = tx.init(params)
    jtraj = []
    for g in grads:
        upd, st = tx.update({a: {k: jnp.asarray(v) for k, v in d.items()}
                             for a, d in g.items()}, st, params)
        params = optax.apply_updates(params, upd)
        jtraj.append(params)

    model = torch.nn.Module()
    for g, d in init.items():
        sub = torch.nn.Module()
        for k, v in d.items():
            sub.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(v.copy())))
        model.add_module(g, sub)
    opt, sched = pmake(model, **kw)
    twin = copy.deepcopy(model)
    topt, tsched = pmake(twin, **kw)
    for step, g in enumerate(grads):
        for name, p in model.named_parameters():
            a, k = name.split(".")
            p.grad = torch.from_numpy(g[a][k].copy())
        sched.set_step(step)
        opt.step()
        opt.zero_grad()
        if step == 2:
            # mid-accumulation: a twin restored from the state continues
            # the same way
            with torch.no_grad():
                for p, q in zip(twin.parameters(), model.parameters()):
                    p.copy_(q)
            topt.load_state_dict(copy.deepcopy(opt.state_dict()))
        for name, p in model.named_parameters():
            a, k = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jtraj[step][a][k]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} step {step}")
    assert opt.gradient_step == 2
    g = grads[3]
    for name, p in twin.named_parameters():
        a, k = name.split(".")
        p.grad = torch.from_numpy(g[a][k].copy())
    tsched.set_step(3)
    topt.step()
    for p, q in zip(twin.parameters(), model.parameters()):
        assert torch.equal(p, q)
    # the first and third calls leave the parameters as they were
    for a, b in ((init, jtraj[0]), (jtraj[1], jtraj[2])):
        np.testing.assert_array_equal(np.asarray(b["head"]["w"]),
                                      a["head"]["w"])
    assert np.abs(np.asarray(jtraj[3]["head"]["w"])
                  - np.asarray(jtraj[2]["head"]["w"])).max() > 1e-4


# ---------------------------------------------------------------------------
# overrides (tests/test_e2e_cli.py:277-300, test_runtime_fixes.py:47-76)
# ---------------------------------------------------------------------------

def test_apply_override_matches_jax():
    from refign_tpu.cli import _apply_override as jover
    from refign_tpu_torch.cli import _apply_override as pover
    cases = [({"trainer": None}, "trainer.max_steps", "100"),
             ({"trainer": {"max_steps": 5}}, "trainer.max_steps", "7"),
             ({"model": {"init_args": {}}}, "model.init_args.use_align",
              "false"),
             ({"data": {"init_args": {"batch_size": 4}}},
              "data.init_args.load_config", '{"train": {"A": [1, 2]}}'),
             ({"trainer": {}}, "trainer.precision", "bf16")]
    for cfg, dotted, value in cases:
        a, b = copy.deepcopy(cfg), copy.deepcopy(cfg)
        jover(a, dotted, value)
        pover(b, dotted, value)
        assert a == b
    for cfg, dotted, match in (
            ({"trainer": {"max_steps": 5}}, "trainer.max_steps.deeper",
             "not a mapping"),
            ({"trainer": {"max_steps": 10}}, "trianer.max_steps",
             "no section")):
        with pytest.raises(SystemExit, match=match):
            pover(copy.deepcopy(cfg), dotted, "1")
        with pytest.raises(SystemExit, match=match):
            jover(copy.deepcopy(cfg), dotted, "1")


def test_cli_argument_errors_and_logger_list(tmp_path):
    from refign_tpu_torch.cli import main
    p = tmp_path / "empty.yaml"
    p.write_text("trainer:\n")
    with pytest.raises(SystemExit, match="missing a value"):
        main(["fit", "--config", str(p), "--trainer.max_steps"])
    with pytest.raises(SystemExit, match="unknown argument"):
        main(["fit", "--config", str(p), "stray"])
    cfg = {
        "trainer": {"logger": [
            {"class_path": "pytorch_lightning.loggers.TensorBoardLogger",
             "init_args": {"save_dir": str(tmp_path / "logs")}}]},
        "model": {"class_path": "does.not.Exist", "init_args": {}},
        "data": {"class_path": "data_modules.CombinedDataModule",
                 "init_args": {"load_config": {}}},
    }
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match="unknown model class"):
        main(["fit", "--config", str(p), "--device", "cpu"])
