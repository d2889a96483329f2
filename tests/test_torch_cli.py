"""The port's CLI end to end on tiny trees, and its tasks against the JAX
package's: the batches, coins, learning rates and logged keys of a fit,
validation and prediction on weights carried across from a JAX state, and
UAWarpC's sparse EPE.

JAX's fit runs with its step replaced by a recorder (its train step is
held against the port's by the trajectory tests); its loader yields its
process-mode batches, made in-process.
"""
import copy
import json
import os
import random
from typing import Any, NamedTuple

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from refign_tpu_torch.data.synthetic import (make_acdc, make_cityscapes,
                                             make_megadepth)
from test_torch_data import jax_epoch, tiny_hrda_config, tiny_stage1_config

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    make_cityscapes(os.path.join(root, "Cityscapes"))
    make_acdc(os.path.join(root, "ACDC"))
    make_megadepth(os.path.join(root, "MegaDepth"), n_val_img=3)
    return str(root)


def _write(cfg, path):
    """The config as YAML, its keys in their order (the train datasets'
    order sets their loader seeds)."""
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return str(path)


def _lines(workdir):
    return [json.loads(l) for l in open(os.path.join(workdir,
                                                     "metrics.jsonl"))]


def test_cli_seg_fit_validate_test_predict(data_root, tmp_path):
    from refign_tpu_torch.cli import main
    cfg = _write(tiny_hrda_config(num_workers=2), tmp_path / "cfg.yaml")
    wd = str(tmp_path / "run")
    common = ["--config", cfg, "--data_dir", data_root, "--workdir", wd,
              "--device", "cpu"]
    assert main(["fit"] + common) == 0
    lines = _lines(wd)
    assert [l["step"] for l in lines] == [1, 2, 2]
    assert all(np.isfinite(v) for l in lines for v in l.values())
    fit_iou = lines[-1]["val_ACDC_IoU"]
    timing = [json.loads(l) for l in open(os.path.join(wd, "timing.jsonl"))]
    assert [t["step"] for t in timing] == [1, 2]
    assert os.readlink(os.path.join(wd, "checkpoints", "last")) == \
        "step_2.pt"
    # validate after the reload: the same weights and data, so the same IoU
    last = os.path.join(wd, "checkpoints", "last")
    assert main(["validate", "--ckpt_path", last] + common) == 0
    val = json.load(open(os.path.join(wd, "val_metrics.json")))
    assert val == {"val_ACDC_IoU": fit_iou}
    assert main(["test", "--ckpt_path", last] + common) == 0
    test = json.load(open(os.path.join(wd, "test_metrics.json")))
    assert list(test) == ["test_ACDC_IoU"] and np.isfinite(
        test["test_ACDC_IoU"])
    assert main(["predict", "--ckpt_path", last] + common) == 0
    for sub in ("preds", "color_preds"):
        files = sorted(os.listdir(os.path.join(wd, sub, "ACDC")))
        assert len(files) == 2
        for f in files:
            img = Image.open(os.path.join(wd, sub, "ACDC", f))
            assert img.size == (1920, 1080)
    # resuming runs on from the checkpoint's step
    assert main(["fit", "--ckpt_path", last, "--trainer.max_steps", "3",
                 "--trainer.val_every_n_steps", "10"] + common) == 0
    assert [l["step"] for l in _lines(wd)][3:] == [3, 3]


def test_cli_align_fit_validate(data_root, tmp_path):
    from refign_tpu_torch.cli import main
    cfg = _write(tiny_stage1_config(num_workers=2), tmp_path / "s1.yaml")
    wd = str(tmp_path / "run")
    common = ["--config", cfg, "--data_dir", data_root, "--workdir", wd,
              "--device", "cpu"]
    assert main(["fit"] + common) == 0
    lines = _lines(wd)
    assert [sorted(l) for l in lines[:2]] == [sorted(
        ["train_matching_loss", "loss_ss", "loss_us", "step", "lr",
         "sps"])] * 2
    assert all(np.isfinite(v) for l in lines for v in l.values())
    assert main(["validate", "--ckpt_path",
                 os.path.join(wd, "checkpoints", "last")] + common) == 0
    val = json.load(open(os.path.join(wd, "val_metrics.json")))
    assert val == {k: v for k, v in lines[-1].items() if k != "step"}
    with pytest.raises(SystemExit, match="not supported"):
        main(["predict"] + common)


def test_cli_without_a_card_raises(data_root, tmp_path):
    from refign_tpu_torch.cli import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _write(tiny_hrda_config(), tmp_path / "cfg.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["validate", "--config", cfg, "--data_dir", data_root,
              "--workdir", str(tmp_path / "run")])


# ---------------------------------------------------------------------------
# against the JAX package's tasks
# ---------------------------------------------------------------------------

def _jax_step_log_keys(jtask):
    """The keys the JAX train step logs, from an abstract trace of it."""
    import jax
    import jax.numpy as jnp
    from refign_tpu.uda.trainer import make_uda_train_step
    st, align = jax.eval_shape(jtask._init_state_impl, jax.random.PRNGKey(0))
    step = make_uda_train_step(jtask.segmentor, jtask.align_backbone,
                               jtask.align_head, jtask.tx, jtask.uda_cfg)
    img = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.uint8)
    batch = dict(image_src=img, image_trg=img, image_ref=img,
                 semantic_src=jax.ShapeDtypeStruct((1, 64, 64), jnp.uint8))
    _, logs = jax.eval_shape(
        lambda s, b, a, k: step(s, b, a, k, use_ref_as_target=False),
        st, batch, align, jax.ShapeDtypeStruct((2,), jnp.uint32))
    return sorted(logs)


def test_fit_hands_its_step_the_jax_fit_batches(data_root, tmp_path,
                                                monkeypatch):
    import refign_tpu.data.loader as JL
    import refign_tpu.tasks.seg_task as JS
    import refign_tpu.train.loop as JLoop
    from refign_tpu.config import build_task as jbuild
    from refign_tpu.train.optim import make_uda_optimizer as jmake
    import refign_tpu_torch.tasks.seg_task as PS
    from refign_tpu_torch.cli import main
    cfg = tiny_hrda_config(num_workers=0)
    cfg["trainer"].update(max_steps=3, val_every_n_steps=3)
    cfg["lr_scheduler"]["init_args"].update(warmup_iters=2, max_steps=3)
    cfg["model"]["init_args"]["backbone"]["init_args"]["model_type"] = \
        "mit_b0"

    # JAX: process-mode batches in-process, a recorder for the step
    def process_iter(self):
        yield from jax_epoch(self, self.dataset)

    monkeypatch.setattr(JL.DataLoader, "__iter__", process_iter)
    monkeypatch.setattr(JLoop, "save_checkpoint", lambda *a, **k: None)
    jtask, _ = jbuild(copy.deepcopy(cfg), data_dir=data_root)
    keys = _jax_step_log_keys(jtask)
    jrec = []

    class State(NamedTuple):
        step: Any

    def init_state(rng):
        jtask.tx, jtask.sched_fn = jmake(
            {"backbone": {"w": np.zeros((2, 2), np.float32)}},
            jtask.opt.lr, jtask.opt.weight_decay, jtask.sched.max_steps,
            warmup_iters=jtask.sched.warmup_iters, power=jtask.sched.power,
            warmup_ratio=jtask.sched.warmup_ratio)
        return State(np.zeros((), np.int32)), None

    def make_step(*a, **k):
        def step(state, batch, align_params, key, use_ref_as_target):
            jrec.append(({k: np.asarray(v) for k, v in batch.items()},
                         use_ref_as_target))
            return state, {k: 0.0 for k in keys}
        return step

    monkeypatch.setattr(jtask, "init_state", init_state)
    monkeypatch.setattr(jtask, "evaluate", lambda *a, **k: {"val_ACDC_IoU":
                                                             0.0})
    monkeypatch.setattr(JS, "make_uda_train_step", make_step)
    random.seed(0)
    np.random.seed(0)
    jtask.fit(str(tmp_path / "jax"), seed=0)

    # the port: its real step, recorded
    prec = []
    real_step = PS.train_step

    def recording_step(trainer, batch, draws):
        prec.append(({k: v.numpy().copy() for k, v in batch.items()},
                     draws.use_ref_as_target))
        return real_step(trainer, batch, draws)

    monkeypatch.setattr(PS, "train_step", recording_step)
    path = _write(cfg, tmp_path / "cfg.yaml")
    assert main(["fit", "--config", path, "--data_dir", data_root,
                 "--workdir", str(tmp_path / "port"), "--device",
                 "cpu"]) == 0
    assert len(prec) == len(jrec) == 3
    assert [c for _, c in prec] == [c for _, c in jrec]
    assert {c for _, c in prec} == {True, False}
    for i, ((pb, _), (jb, _)) in enumerate(zip(prec, jrec)):
        assert sorted(pb) == sorted(jb)
        for k in jb:
            np.testing.assert_array_equal(pb[k], jb[k].astype(pb[k].dtype),
                                          err_msg=f"step {i} {k}")
            assert pb[k].dtype == (np.int64 if k == "semantic_src"
                                   else jb[k].dtype)
    jl, pl = _lines(tmp_path / "jax"), _lines(tmp_path / "port")
    assert [sorted(l) for l in pl] == [sorted(l) for l in jl]
    for p, j in zip(pl, jl):
        assert p["step"] == j["step"]
        if "lr" in j:
            np.testing.assert_allclose(p["lr"], j["lr"], rtol=1e-6)


def to_flax(module):
    """A port module's weights as the JAX package's flax variables (the
    inverse of ``utils/jax_convert.load_jax_variables``)."""
    from refign_tpu_torch.utils.jax_convert import (
        DENSE_AS_CONV1X1_SUFFIXES, flax_location)
    out = {"params": {}, "batch_stats": {}}
    for key, t in module.state_dict().items():
        coll, path = flax_location(key, t.dim())
        arr = t.detach().float().numpy()
        if key.endswith(".weight") and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        elif key.endswith(".weight") and arr.ndim == 2:
            arr = arr.T
            if any(key.endswith(s + ".weight")
                   for s in DENSE_AS_CONV1X1_SUFFIXES):
                arr = arr[None, None]
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return out


def _jax_confmats(monkeypatch, module):
    seen = []
    real = module.iou_compute

    def capture(confmat, *a, **k):
        seen.append(np.asarray(confmat).copy())
        return real(confmat, *a, **k)

    monkeypatch.setattr(module, "iou_compute", capture)
    return seen


def test_validate_and_predict_on_jax_weights_match_jax(data_root, tmp_path,
                                                       monkeypatch):
    import types
    import refign_tpu.tasks.seg_task as JS
    from refign_tpu.config import build_task as jbuild
    from refign_tpu.data.datasets import seg_datasets as JD
    from refign_tpu_torch.config import build_task as pbuild
    from refign_tpu_torch.data.datasets import seg_datasets as PD
    from refign_tpu_torch.utils.jax_convert import load_jax_variables
    cfg = tiny_hrda_config()
    for k in ("alignment_backbone", "alignment_head"):
        del cfg["model"]["init_args"][k]
    # predictions at the trees' size (ACDC's are written at 1080x1920)
    for D in (JD.ACDC, PD.ACDC):
        monkeypatch.setattr(D, "orig_dims", (64, 128))
    ptask, _ = pbuild(copy.deepcopy(cfg), data_dir=data_root, device="cpu")
    trainer = ptask.init_state(0)
    # a JAX state from the port's student, carried back by jax_convert
    jvars = to_flax(trainer.state.student)
    jstate = types.SimpleNamespace(params=jvars["params"],
                                   batch_stats=jvars["batch_stats"])
    load_jax_variables(trainer.state.student, jvars)
    jtask, _ = jbuild(copy.deepcopy(cfg), data_dir=data_root)
    seen = _jax_confmats(monkeypatch, JS)
    jval = jtask.evaluate("val", state=jstate)
    jtask.predict(str(tmp_path / "jax"), state=jstate)

    pval = ptask.evaluate("val", trainer)
    pconf = ptask.last_confmats["ACDC"][255].numpy()
    jconf = seen[0]
    assert pconf.dtype == np.int64 and pconf.sum() == jconf.sum()
    moved = np.abs(pconf - jconf).sum() / 2
    assert moved <= 1e-3 * pconf.sum()
    if moved == 0:
        np.testing.assert_allclose(pval["val_ACDC_IoU"],
                                   jval["val_ACDC_IoU"], rtol=1e-6,
                                   atol=1e-6)
    ptask.predict(str(tmp_path / "port"), trainer)
    files = sorted(os.listdir(tmp_path / "jax" / "preds" / "ACDC"))
    assert files == sorted(os.listdir(tmp_path / "port" / "preds" / "ACDC"))
    assert len(files) == 2
    for sub in ("preds", "color_preds"):
        for f in files:
            a = np.asarray(Image.open(tmp_path / "port" / sub / "ACDC" / f))
            b = np.asarray(Image.open(tmp_path / "jax" / sub / "ACDC" / f))
            assert a.shape == b.shape == (64, 128)
            assert (a == b).mean() >= 0.999


def test_align_sparse_epe_on_jax_weights_matches_jax(data_root):
    import types
    from refign_tpu.config import build_task as jbuild
    from refign_tpu_torch.config import build_task as pbuild
    cfg = tiny_stage1_config()
    ptask, _ = pbuild(copy.deepcopy(cfg), data_dir=data_root, device="cpu")
    trainer = ptask.init_state(0)
    head, bb = to_flax(trainer.state.head), to_flax(trainer.state.backbone)
    jstate = types.SimpleNamespace(params=head["params"],
                                   batch_stats=head["batch_stats"],
                                   backbone_params=bb["params"])
    jtask, _ = jbuild(copy.deepcopy(cfg), data_dir=data_root)
    jval = jtask.evaluate("val", state=jstate)
    pval = ptask.evaluate("val", trainer)
    assert sorted(pval) == sorted(jval) and len(pval) == 6
    for k in jval:
        np.testing.assert_allclose(pval[k], jval[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
