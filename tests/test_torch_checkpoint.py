"""The port's checkpoints against the JAX package's: its own train-state
checkpoints (exact round trips, ``last`` and pruning), reference-named
checkpoint files read natively against the JAX package's converters (the
names line up when the outputs agree), and pretrained-file resolution.
"""
import copy
import os

import numpy as np
import pytest
import torch

from test_torch_data import tiny_hrda_config, tiny_stage1_config

TOL = 1e-5

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the
    parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _task(cfg, **margs):
    from refign_tpu_torch.config import build_task
    cfg = copy.deepcopy(cfg)
    cfg["model"]["init_args"].update(margs)
    task, _ = build_task(cfg, data_dir="/nonexistent", device="cpu")
    return task


def _uda_batch(seed, B=1, S=64):
    g = torch.Generator().manual_seed(seed)
    img = lambda: torch.randint(0, 256, (B, S, S, 3), dtype=torch.uint8,
                                generator=g)
    return {"image_src": img(), "image_trg": img(), "image_ref": img(),
            "semantic_src": torch.randint(0, 19, (B, S, S), generator=g)}


def _uda_step(trainer, batch, gen):
    from refign_tpu_torch.uda.trainer import draw_step, train_step
    draws = draw_step(trainer.cfg, batch, gen)
    draws.use_ref_as_target = False
    return train_step(trainer, batch, draws)


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    else:
        assert a == b, path


# ---------------------------------------------------------------------------
# own checkpoints
# ---------------------------------------------------------------------------

def test_uda_train_state_roundtrip_is_exact(tmp_path):
    from refign_tpu_torch.utils import checkpoint as ck
    task = _task(tiny_hrda_config())
    a = task.init_state(0)
    gen_a = torch.Generator().manual_seed(7)
    _uda_step(a, _uda_batch(0), gen_a)
    path = ck.save_checkpoint(str(tmp_path), ck.train_state(
        a, {"draws": gen_a}), step=1)
    assert os.path.realpath(tmp_path / "last") == path
    b = task.init_state(1)
    gen_b = torch.Generator().manual_seed(99)
    ck.load_train_state(b, ck.restore_checkpoint(str(tmp_path / "last")),
                        {"draws": gen_b})
    sa, sb = ck.train_state(a, {"draws": gen_a}), ck.train_state(
        b, {"draws": gen_b})
    _assert_tree_equal(sa, sb)
    assert b.state.step == 1 and len(sb["optimizer"]["state"]) > 0
    # the restored trainer takes the same next step (dropout and host
    # generators restored where they were)
    la = _uda_step(a, _uda_batch(1), gen_a)
    lb = _uda_step(b, _uda_batch(1), gen_b)
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    for (n, p), q in zip(a.state.student.named_parameters(),
                         b.state.student.parameters()):
        assert torch.equal(p, q), n


def test_align_train_state_roundtrip_is_exact(tmp_path):
    from refign_tpu_torch.alignment import trainer as atr
    from refign_tpu_torch.utils import checkpoint as ck
    task = _task(tiny_stage1_config())
    a = task.init_state(0)
    g = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, 256, (2, 80, 80, 3), dtype=torch.uint8,
                              generator=g)
             for k in ("image_ref", "image_trg")}
    atr.train_step(a, batch, atr.draw_align(a.cfg, 2, 80, 80, g))
    ck.save_checkpoint(str(tmp_path), ck.train_state(a), step=1)
    b = task.init_state(1)
    ck.load_train_state(b, ck.restore_checkpoint(str(tmp_path)))
    _assert_tree_equal(ck.train_state(a), ck.train_state(b))
    assert b.state.step == 1


def test_last_is_atomic_and_pruning_keeps_it(tmp_path):
    """tests/test_checkpoint_interop.py's rules: `last` always resolves to
    a live checkpoint; pruning keeps `keep` and never the file `last`
    points to; temporary files are ignored."""
    from refign_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    state = {"step": 0, "w": torch.arange(3.0)}
    d = str(tmp_path / "ckpts")
    for s in range(1, 6):
        save_checkpoint(d, dict(state, step=s), step=s)
    files = sorted(f for f in os.listdir(d) if f.startswith("step_"))
    assert files == ["step_3.pt", "step_4.pt", "step_5.pt"]
    assert os.readlink(os.path.join(d, "last")) == "step_5.pt"
    assert restore_checkpoint(os.path.join(d, "last"))["step"] == 5
    # a stale `last` (crash between save and swap) survives later saves
    # that do not move it
    last = os.path.join(d, "last")
    os.remove(last)
    os.symlink("step_3.pt", last)
    for s in (6, 7, 8, 9):
        save_checkpoint(d, dict(state, step=s), step=s, keep=2,
                        save_last=False)
    assert os.path.exists(os.path.join(d, "step_3.pt"))
    torch.testing.assert_close(restore_checkpoint(last)["w"], state["w"])
    # a temporary file of an interrupted save is ignored by the pruning
    open(os.path.join(d, ".step_10.pt.tmp.123"), "w").close()
    os.makedirs(os.path.join(d, "step_11.pt.partial"))
    save_checkpoint(d, dict(state, step=12), step=12, keep=2)
    assert os.readlink(last) == "step_12.pt"
    assert not os.path.exists(os.path.join(d, "step_3.pt"))
    assert os.path.exists(os.path.join(d, ".step_10.pt.tmp.123"))
    assert sorted(f for f in os.listdir(d) if f.endswith(".pt")) == [
        "step_12.pt", "step_9.pt"]


# ---------------------------------------------------------------------------
# reference-named files: native loading against the JAX converters
# ---------------------------------------------------------------------------

def _reference_names(sd):
    """Port state dict -> the reference's names."""
    from refign_tpu_torch.utils.checkpoint import to_reference
    return {k: v.clone() for k, v in to_reference(sd).items()}


def _flax_subset(tree, module):
    """The leaves of a converted flax tree that ``module`` holds."""
    from refign_tpu_torch.utils.jax_convert import flax_location
    out = {"params": {}, "batch_stats": {}}
    for key, t in module.state_dict().items():
        coll, path = flax_location(key, t.dim())
        src, dst = tree[coll], out[coll]
        for p in path[:-1]:
            src, dst = src[p], dst.setdefault(p, {})
        dst[path[-1]] = src[path[-1]]
    return out


def _via_jax(module, tree):
    from refign_tpu_torch.utils.jax_convert import load_jax_variables
    return load_jax_variables(copy.deepcopy(module),
                              _flax_subset(tree, module))


def _mit(seed):
    from refign_tpu_torch.models.mix_transformer import MixVisionTransformer
    m = MixVisionTransformer("mit_b0", drop_path_rate=0.0)
    m.init_weights(torch.Generator().manual_seed(seed))
    return m.eval()


def test_backbone_files_load_like_jax(tmp_path):
    import jax.numpy as jnp
    from refign_tpu.models.mix_transformer import MixVisionTransformer as JMiT
    from refign_tpu.utils.checkpoint import load_torch_backbone
    from refign_tpu_torch.models.vgg import VGG
    from refign_tpu_torch.tasks.seg_task import load_pretrained_backbone
    src = _mit(0)
    ref = _reference_names(src.state_dict())
    assert any(".mlp.dwconv.dwconv." in k for k in ref)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 64, 64, 3).astype(np.float32))
    files = {
        # an ImageNet file: bare names and a classifier
        "imagenet.pth": dict(ref, **{"head.weight": torch.zeros(5, 256),
                                     "head.bias": torch.zeros(5)}),
        # a Cityscapes SegFormer file: backbone. + a decode head
        "city.pth": {"state_dict": dict(
            {"backbone." + k: v for k, v in ref.items()},
            **{"decode_head.conv_seg.weight": torch.zeros(19, 256, 1, 1)})},
    }
    for name, content in files.items():
        path = str(tmp_path / name)
        torch.save(content, path)
        native = _mit(1)
        load_pretrained_backbone(native, path)
        tree = load_torch_backbone(path)
        with torch.no_grad():
            want = src(x)
            got = native(x)
            viajax = _via_jax(native, tree)(x)
        jout = JMiT(model_type="mit_b0", drop_path_rate=0.0).apply(
            {"params": tree["params"]}, jnp.asarray(x.numpy()))
        for g, w, v, j in zip(got, want, viajax, jout):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
            torch.testing.assert_close(v, g, rtol=TOL, atol=TOL)
            np.testing.assert_allclose(np.asarray(j), g.numpy(), rtol=TOL,
                                       atol=TOL)
    # torchvision VGG: classifier dropped, layers past the deepest level
    # the module builds are ignored (subset), a missing one raises
    vsrc = VGG("vgg11", out_indices=(2, 3, 4))
    vsrc.init_weights(torch.Generator().manual_seed(0))
    vref = dict(vsrc.state_dict(), **{
        "classifier.0.weight": torch.zeros(4, 4),
        "features.99.weight": torch.zeros(2, 2, 3, 3)})
    path = str(tmp_path / "vgg11.pth")
    torch.save(vref, path)
    native = VGG("vgg11", out_indices=(2, 3, 4))
    load_pretrained_backbone(native, path)
    tree = load_torch_backbone(path)
    xv = torch.randn(1, 32, 32, 3)
    with torch.no_grad():
        for g, w, v in zip(native(xv), vsrc(xv), _via_jax(native, tree)(xv)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
            torch.testing.assert_close(v, g, rtol=TOL, atol=TOL)
    del vref["features.0.weight"]
    torch.save(vref, path)
    with pytest.raises(KeyError, match="features.0.weight"):
        load_pretrained_backbone(VGG("vgg11", out_indices=(2, 3, 4)), path)


def _align_net(seed):
    from refign_tpu_torch.alignment.trainer import AlignmentNet
    from refign_tpu_torch.models.heads.uawarpc import UAWarpCHead
    from refign_tpu_torch.models.vgg import VGG
    g = torch.Generator().manual_seed(seed)
    bb = VGG("vgg11", out_indices=(2, 3, 4))
    head = UAWarpCHead(in_index=(0, 1), estimate_uncertainty=True)
    bb.init_weights(g)
    head.init_weights(g)
    return AlignmentNet(bb, head).eval()


def test_alignment_head_file_loads_like_jax(tmp_path):
    from refign_tpu.utils.checkpoint import load_torch_alignment_head
    from refign_tpu_torch.alignment.trainer import (AlignmentNet,
                                                    flow_and_logvar)
    from refign_tpu_torch.tasks.seg_task import SegTask
    from refign_tpu_torch.utils import checkpoint as ck
    src = _align_net(0)
    sd = {"alignment_head." + k: v for k, v in
          _reference_names(src.head.state_dict()).items()}
    sd.update({"alignment_backbone." + k: v for k, v in
               src.backbone.state_dict().items()})
    path = str(tmp_path / "uawarpc.ckpt")
    torch.save({"state_dict": sd, "epoch": 3, "hyper_parameters": {}}, path)
    native = _align_net(1)
    ck.load_state(native.head, ck.alignment_head_state(
        ck.read_reference(path)))
    tree = load_torch_alignment_head(path)
    viajax = AlignmentNet(native.backbone, _via_jax(native.head, tree))
    g = torch.Generator().manual_seed(2)
    a, b = torch.randn(1, 64, 64, 3, generator=g), torch.randn(
        1, 64, 64, 3, generator=g)
    with torch.no_grad():
        want = flow_and_logvar(AlignmentNet(native.backbone, src.head), a, b)
        got = flow_and_logvar(native, a, b)
        vj = flow_and_logvar(viajax, a, b)
    for x, y, z in zip(got, want, vj):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        torch.testing.assert_close(z, x, rtol=TOL, atol=TOL)
    # through the task's config path (the HRDA config's alignment head)
    cfg = tiny_hrda_config()
    cfg["model"]["init_args"]["alignment_head"]["init_args"][
        "pretrained"] = path
    net = _task(cfg).build_align_net(0)
    for (n, p), q in zip(net.head.state_dict().items(),
                         src.head.state_dict().values()):
        assert torch.equal(p, q), n
    assert isinstance(_task(cfg), SegTask)


def _full_uda_file(tmp_path, drop=None):
    """A reference full UDA checkpoint from a port trainer's modules."""
    task = _task(tiny_hrda_config())
    tr = task.init_state(5)
    st = tr.state
    groups = {"backbone.": st.student.backbone, "head.": st.student.head,
              "hrda_scale_attention.": st.student.scale_attention,
              "m_backbone.": st.teacher.backbone, "m_head.": st.teacher.head,
              "m_hrda_scale_attention.": st.teacher.scale_attention,
              "imnet_backbone.": st.imnet,
              "alignment_backbone.": tr.align_net.backbone,
              "alignment_head.": tr.align_net.head}
    # teacher and ImageNet copy differ from the student, so each group
    # must land in its own module
    with torch.no_grad():
        for i, m in enumerate((st.teacher, st.imnet)):
            for p in m.parameters():
                p.add_(0.01 * (i + 1))
    sd = {}
    for prefix, m in groups.items():
        if prefix != drop:
            sd.update({prefix + k: v for k, v in
                       _reference_names(m.state_dict()).items()})
    path = str(tmp_path / f"full_{drop}.ckpt")
    torch.save({"state_dict": sd}, path)
    return path, tr


def test_full_uda_file_loads_like_jax(tmp_path):
    from refign_tpu.tasks.seg_task import SegTask as JSegTask
    from refign_tpu.uda.trainer import UDATrainState as JState
    from refign_tpu.utils.checkpoint import load_torch_full_uda
    path, src = _full_uda_file(tmp_path)
    task = _task(tiny_hrda_config(), pretrained=path)
    tr = task.init_state(0)
    groups = load_torch_full_uda(path)
    empty = {"backbone": {}, "head": {}, "scale_attention": {}}
    jstate = JSegTask._load_full(None, JState(
        step=0, params=dict(empty), batch_stats={},
        teacher_params=dict(empty), teacher_batch_stats={},
        imnet_params={}, imnet_batch_stats={}, opt_state=None), groups)
    x = torch.from_numpy(np.random.RandomState(1).randn(
        1, 64, 64, 3).astype(np.float32))
    for name, params, stats in (
            ("student", jstate.params, jstate.batch_stats),
            ("teacher", jstate.teacher_params, jstate.teacher_batch_stats)):
        native = getattr(tr.state, name).eval()
        want = getattr(src.state, name).eval()
        viajax = _via_jax(native, {"params": params, "batch_stats": stats})
        with torch.no_grad():
            got = native.whole(x)
            torch.testing.assert_close(got, want.whole(x), rtol=0, atol=0)
            torch.testing.assert_close(viajax.whole(x), got, rtol=TOL,
                                       atol=TOL)
    viajax = _via_jax(tr.state.imnet, {"params": jstate.imnet_params,
                                        "batch_stats": {}})
    with torch.no_grad():
        for g, w, v in zip(tr.state.imnet(x), src.state.imnet(x), viajax(x)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
            torch.testing.assert_close(v, g, rtol=TOL, atol=TOL)
    for m, s in ((tr.align_net.head, src.align_net.head),
                 (tr.align_net.backbone, src.align_net.backbone)):
        for (n, p), q in zip(m.state_dict().items(), s.state_dict().values()):
            assert torch.equal(p, q), n


def test_full_uda_file_missing_group_raises_in_both(tmp_path):
    from refign_tpu.tasks.seg_task import SegTask as JSegTask
    from refign_tpu.uda.trainer import UDATrainState as JState
    from refign_tpu.utils.checkpoint import load_torch_full_uda
    path, _ = _full_uda_file(tmp_path, drop="m_head.")
    with pytest.raises(KeyError, match="m_head"):
        _task(tiny_hrda_config(), pretrained=path).init_state(0)
    empty = {"backbone": {}, "head": {}, "scale_attention": {}}
    with pytest.raises(KeyError, match="m_head"):
        JSegTask._load_full(None, JState(
            step=0, params=dict(empty), batch_stats={},
            teacher_params=dict(empty), teacher_batch_stats={},
            imnet_params={}, imnet_batch_stats={}, opt_state=None),
            load_torch_full_uda(path))


# ---------------------------------------------------------------------------
# pretrained resolution
# ---------------------------------------------------------------------------

def test_pretrained_tables_match_jax():
    import refign_tpu.utils.pretrained as J
    import refign_tpu_torch.utils.pretrained as P
    assert P.MIT_URLS == J.MIT_URLS
    assert P.RESNET_URLS == J.RESNET_URLS
    assert P.VGG_URLS == J.VGG_URLS
    assert P.KEYWORDS == J.KEYWORDS
    cases = ([("imagenet", "mix_transformer", m) for m in J.MIT_URLS[
        "imagenet"]] + [("cityscapes", "mix_transformer", "mit_b5")]
             + [("imagenet", "resnet", m) for m in J.RESNET_URLS]
             + [("imagenet", "vgg", m) for m in J.VGG_URLS])
    for kw, fam, mt in cases:
        assert P.keyword_to_source(kw, fam, mt) == J.keyword_to_source(
            kw, fam, mt)
    for bad in (("cityscapes", "mix_transformer", "mit_b0"),
                ("cityscapes", "vgg", "vgg16"), ("imagenet", "x", "y")):
        with pytest.raises(KeyError):
            P.keyword_to_source(*bad)


def test_missing_source_raises_without_network_and_hub_cache_resolves(
        tmp_path, monkeypatch):
    import urllib.request
    import torch.hub
    from refign_tpu_torch.utils.pretrained import (_hub_dir,
                                                   resolve_pretrained)

    calls = []

    def no_network(*a, **k):
        calls.append(a)
        raise OSError("no network")

    monkeypatch.setattr(torch.hub, "download_url_to_file", no_network)
    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "th"))
    cache = tmp_path / "th" / "hub" / "checkpoints" / "vgg16-397923af.pth"
    # a miss tries the download into the cache; its failure names the file
    with pytest.raises(RuntimeError, match=str(cache)):
        resolve_pretrained("imagenet", family="vgg", model_type="vgg16")
    assert [c[1] for c in calls] == [str(cache)]
    with pytest.raises(FileNotFoundError, match="refusing"):
        resolve_pretrained("pretrained_models/none.ckpt")
    # the failed download made the cache directory, as JAX's does
    os.makedirs(cache.parent, exist_ok=True)
    torch.save({}, cache)
    assert resolve_pretrained("imagenet", family="vgg",
                              model_type="vgg16") == str(cache)
    # a release-relative path under the hub directory
    rel = os.path.join(_hub_dir(), "pretrained_models", "mit_b0.pth")
    os.makedirs(os.path.dirname(rel))
    torch.save({}, rel)
    assert resolve_pretrained("imagenet", family="mix_transformer",
                              model_type="mit_b0") == os.path.normpath(rel)
    local = tmp_path / "w.pth"
    torch.save({}, local)
    assert resolve_pretrained(str(local)) == str(local)
