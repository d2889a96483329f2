"""The port's host data pipeline against the JAX package's: transforms,
datasets, the batch loader, the combined data module and the prefetcher.

The JAX package's data classes are numpy/PIL; importing them loads JAX, so
its loader's process pool is never forked here: its expected batches are
made in-process with ``DataLoader._index_batches()`` and
``_worker_batch((seed, epoch, b, idxs))``.  The tiny configs below are
shared with the other ``test_torch_*`` runtime files.
"""
import copy
import os
import random
import time

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from refign_tpu_torch.data.synthetic import (blob_labels, make_acdc,
                                             make_cityscapes, make_megadepth,
                                             smooth_image)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HRDA_YAML = os.path.join(REPO, "configs", "cityscapes_acdc",
                         "refign_hrda_star.yaml")
STAGE1_YAML = os.path.join(REPO, "configs", "megadepth",
                           "uawarpc_stage1.yaml")


# ---------------------------------------------------------------------------
# tiny dataset trees (refign_tpu_torch/data/synthetic.py) and configs
# ---------------------------------------------------------------------------

def tiny_hrda_config(crop=64, dims=(64, 128), batch_size=2, num_workers=0):
    """configs/cityscapes_acdc/refign_hrda_star.yaml at a tiny size: the
    trees' dims, crop 64, mit_b0 and 32-wide heads, VGG-11, slide crops of
    64 at stride 32, no pretrained files, fp32."""
    with open(HRDA_YAML) as f:
        cfg = yaml.safe_load(f)
    data = cfg["data"]["init_args"]
    data["batch_size"] = batch_size
    data["num_workers"] = num_workers
    # the trees' blobs are far below the 3000-pixel rare-class floor
    data["load_config"]["train"]["Cityscapes"]["rcs_min_pixels"] = 0
    for stage, per_ds in data["load_config"].items():
        for conf in per_ds.values():
            conf["dims"] = list(dims)
            for t in conf["transforms"]:
                if t["class_path"].endswith("RandomCrop"):
                    t["init_args"]["size"] = [crop, crop]
    m = cfg["model"]["init_args"]
    m["backbone"]["init_args"].update(model_type="mit_b0", pretrained=None)
    for k in ("head", "hrda_scale_attention"):
        m[k]["init_args"]["channels"] = 32
    m["head"]["init_args"]["embed_dims"] = 32
    m["alignment_backbone"]["init_args"].update(model_type="vgg11",
                                                pretrained=None)
    m["alignment_head"]["init_args"]["pretrained"] = None
    m["inference_crop_size"] = [dims[0], dims[0]]
    m["inference_stride"] = [dims[0] // 2, dims[0] // 2]
    cfg["trainer"].update(precision=32, max_steps=2, val_every_n_steps=2,
                          log_every_n_steps=1)
    cfg["lr_scheduler"]["init_args"].update(warmup_iters=10, max_steps=2)
    return cfg


def tiny_stage1_config(dims=(80, 80), crop=64, batch_size=2,
                       num_workers=0):
    """configs/megadepth/uawarpc_stage1.yaml at a tiny size: 80^2 loads
    cropped to 64^2 after the flow, VGG-11, val at 64x96, fp32."""
    with open(STAGE1_YAML) as f:
        cfg = yaml.safe_load(f)
    data = cfg["data"]["init_args"]
    data["batch_size"] = batch_size
    data["num_workers"] = num_workers
    train = data["load_config"]["train"]["MegaDepth"]
    train["dims"] = list(dims)
    for t in train["transforms"]:
        if t["class_path"].endswith("CenterCrop"):
            t["init_args"]["size"] = [crop, crop]
    data["load_config"]["val"]["MegaDepth"]["dims"] = [64, 96]
    m = cfg["model"]["init_args"]
    m["alignment_backbone"]["init_args"].update(model_type="vgg11",
                                                pretrained=None)
    cfg["trainer"].update(precision=32, max_steps=2, val_every_n_steps=2,
                          log_every_n_steps=1)
    return cfg


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    make_cityscapes(os.path.join(root, "Cityscapes"))
    make_acdc(os.path.join(root, "ACDC"))
    make_megadepth(os.path.join(root, "MegaDepth"), n_val_img=3)
    return str(root)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if isinstance(v, Image.Image):
        return np.asarray(v)
    return v


def assert_same(a, b, path=""):
    """Bitwise equality of two samples / batches (PIL images, numpy
    arrays, tensors, lists, dicts, scalars)."""
    a, b = _np(a), _np(b)
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), \
            f"{path}: keys {sorted(a)} vs {sorted(b)}"
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: lengths"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            f"{path}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


def seeded(fn, seed):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def _pil_sample(seed=0, h=40, w=56, pts=True):
    rng = np.random.RandomState(seed)
    s = {"image": Image.fromarray(smooth_image(rng, h, w)),
         "image_ref": Image.fromarray(smooth_image(rng, h, w)),
         "semantic": Image.fromarray(blob_labels(rng, h, w)),
         "filename": "x.png"}
    if pts:
        s["corr_pts"] = (rng.rand(20, 2) * [w, h]).astype(np.float32)
        s["corr_pts_ref"] = (rng.rand(20, 2) * [w, h]).astype(np.float32)
    return s


def _np_sample(seed=0, h=40, w=56):
    s = _pil_sample(seed, h, w)
    for k in ("image", "image_ref", "semantic"):
        s[k] = np.asarray(s[k], np.uint8)
    return s


# ---------------------------------------------------------------------------
# transforms: every class, same sample and seed -> bitwise-equal output
# ---------------------------------------------------------------------------

TRANSFORM_CASES = [
    ("Resize", dict(size=(24, 30)), "pil"),
    ("Resize", dict(size=32, img_interpolation="lanczos"), "pil"),
    ("Resize", dict(size=(30, 30), only_if_larger=True,
                    apply_keys=["image", "image_ref", "semantic"]), "pil"),
    ("RandomRotation", dict(degrees=20,
                            apply_keys=["image", "semantic"]), "pil"),
    ("ToTensor", dict(apply_keys=["image", "image_ref", "semantic",
                                  "filename"]), "pil"),
    ("RandomCrop", dict(size=(24, 24), cat_max_ratio=0.75), "np"),
    ("RandomCrop", dict(size=(24, 32)), "np"),
    ("RandomHorizontalFlip", dict(p=0.5), "np"),
    ("RandomHorizontalFlip", dict(p=1.0), "pil"),
    ("ColorJitter", dict(brightness=0.6, contrast=0.6, saturation=0.6,
                         hue=0.1, apply_keys=["image"]), "np"),
    ("ChannelShuffle", dict(apply_keys=["image_prime"]), "prime"),
    ("ConvertImageDtype", dict(apply_keys=["image", "image_ref",
                                           "semantic"]), "np"),
    ("Normalize", dict(apply_keys=["image", "image_ref"]), "float"),
    ("RandomGaussianBlur", dict(p=1.0, sigma=(0.2, 2.0),
                                apply_keys=["image"]), "np"),
    ("RandomGaussianBlur", dict(p=0.5, apply_keys=["image"]), "pil"),
    ("PadBottomRight", dict(size=(48, 64),
                            apply_keys=["image", "semantic"]), "np"),
    ("PadBottomRight", dict(same_shape_keys=["image", "image_ref"],
                            apply_keys=["image", "image_ref"]), "pad"),
    ("CenterCrop", dict(size=(24, 40)), "np"),
    ("CompositeFlow", dict(apply_keys=["image_prime"], random_alpha=0.3),
     "np"),
]


def _case_sample(kind, seed):
    if kind == "pil":
        return _pil_sample(seed)
    if kind == "prime":
        s = _np_sample(seed)
        return {"image_prime": s["image"]}
    if kind == "float":
        s = _np_sample(seed)
        return {k: (s[k].astype(np.float32) / 255.0
                    if k.startswith("image") else s[k]) for k in s}
    if kind == "pad":
        s = _np_sample(seed)
        s["image_ref"] = s["image_ref"][:30, :50]
        return s
    return _np_sample(seed)


@pytest.mark.parametrize("name,args,kind", TRANSFORM_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(TRANSFORM_CASES)])
def test_transform_matches_jax(name, args, kind):
    import refign_tpu.data.transforms as JT
    import refign_tpu_torch.data.transforms as PT
    for seed in (0, 1, 2):
        jt = getattr(JT, name)(**copy.deepcopy(args))
        pt = getattr(PT, name)(**copy.deepcopy(args))
        want = seeded(lambda: jt(_case_sample(kind, seed)), seed)
        got = seeded(lambda: pt(_case_sample(kind, seed)), seed)
        assert_same(got, want, f"{name} seed {seed}")
        # the draws left the global generators in the same state
        assert random.random() == seeded(
            lambda: (jt(_case_sample(kind, seed)), random.random())[1],
            seed)


def test_compose_and_tables_match_jax():
    import refign_tpu.data.transforms as JT
    import refign_tpu_torch.data.transforms as PT
    args = [("RandomCrop", dict(size=(24, 24), cat_max_ratio=0.75)),
            ("RandomHorizontalFlip", {}), ("ConvertImageDtype", {}),
            ("Normalize", {})]
    jc = JT.Compose([getattr(JT, n)(**a) for n, a in args])
    pc = PT.Compose([getattr(PT, n)(**a) for n, a in args])
    for seed in range(4):
        assert_same(seeded(lambda: pc(_np_sample(seed)), seed),
                    seeded(lambda: jc(_np_sample(seed)), seed))
    np.testing.assert_array_equal(PT.IMNET_MEAN, JT.IMNET_MEAN)
    np.testing.assert_array_equal(PT.IMNET_STD, JT.IMNET_STD)
    assert PT.PILLOW_INTERP == JT.PILLOW_INTERP
    public = {n for n in dir(JT) if n[0].isupper()
              and isinstance(getattr(JT, n), type)}
    assert public <= {n for n in dir(PT) if n[0].isupper()}


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def _both(name, module):
    import importlib
    j = importlib.import_module(f"refign_tpu.data.datasets.{module}")
    p = importlib.import_module(f"refign_tpu_torch.data.datasets.{module}")
    return getattr(j, name), getattr(p, name)


def _compare_dataset(jds, pds, indices, seeds=(0, 1)):
    assert len(pds) == len(jds)
    if hasattr(jds, "paths"):
        assert pds.paths == jds.paths
    for i in indices:
        for s in seeds:
            assert_same(seeded(lambda: pds[i], s), seeded(lambda: jds[i], s),
                        f"item {i} seed {s}")


def test_cityscapes_rare_class_sampling_matches_jax(trees):
    J, P = _both("Cityscapes", "seg_datasets")
    root = os.path.join(trees, "Cityscapes")
    kw = dict(stage="train", load_keys=["image", "semantic"],
              dims=(64, 128), rcs_enabled=True, rcs_min_crop_ratio=2.0,
              rcs_min_pixels=0)
    jds, pds = J(root, **kw), P(root, **kw)
    assert pds.paths == jds.paths
    assert pds.rcs_classes == jds.rcs_classes
    np.testing.assert_allclose(pds.rcs_classprob, jds.rcs_classprob,
                               rtol=0, atol=1e-12)
    assert pds.indices_with_class == jds.indices_with_class
    # the sampled class and index are draws from `random`
    for seed in range(4):
        assert_same(seeded(pds.get_rare_class_sample, seed),
                    seeded(jds.get_rare_class_sample, seed))
        assert (seeded(lambda: random.choices(pds.rcs_classes,
                                              weights=pds.rcs_classprob), seed)
                == seeded(lambda: random.choices(jds.rcs_classes,
                                                 weights=jds.rcs_classprob),
                          seed))
    kw = dict(stage="val", load_keys=["image", "semantic"], dims=(32, 64))
    _compare_dataset(J(root, **kw), P(root, **kw), [0, 1])


def test_acdc_matches_jax(trees):
    J, P = _both("ACDC", "seg_datasets")
    root = os.path.join(trees, "ACDC")
    for stage, keys in (("train", ["image", "image_ref"]),
                        ("val", ["image", "semantic"]),
                        ("predict", ["image"])):
        kw = dict(stage=stage, load_keys=keys, dims=(64, 128))
        _compare_dataset(J(root, **kw), P(root, **kw), [0, 1])


def test_darkzurich_nd_bdd_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    # Dark Zurich: train pairs from the copied list; val tree by prefix
    J, P = _both("DarkZurich", "seg_datasets")
    root = str(tmp_path / "dz")
    jds = J(root, stage="train", load_keys=["image_ref", "image"],
            dims=(32, 64))
    pds = P(root, stage="train", load_keys=["image_ref", "image"],
            dims=(32, 64))
    assert pds.paths == jds.paths and len(pds) == len(jds) > 100
    for k in ("image", "image_ref"):
        os.makedirs(os.path.dirname(jds.paths[k][0]), exist_ok=True)
        Image.fromarray(smooth_image(rng, 40, 72)).save(jds.paths[k][0])
    _compare_dataset(jds, pds, [0])
    for split in ("val",):
        img_dir = tmp_path / "dz" / "rgb_anon" / split / "night" / "GOPR1"
        ref_dir = (tmp_path / "dz" / "rgb_anon" / (split + "_ref") / "day"
                   / "GOPR1_ref")
        sem_dir = tmp_path / "dz" / "gt" / split / "night" / "GOPR1"
        for d in (img_dir, ref_dir, sem_dir):
            os.makedirs(d)
        Image.fromarray(smooth_image(rng, 40, 72)).save(
            img_dir / "GOPR1_f0_rgb_anon.png")
        Image.fromarray(smooth_image(rng, 40, 72)).save(
            ref_dir / "GOPR1_f0_ref_rgb_anon.png")
        Image.fromarray(blob_labels(rng, 40, 72)).save(
            sem_dir / "GOPR1_f0_gt_labelTrainIds.png")
    kw = dict(stage="val", load_keys=["image", "image_ref", "semantic"],
              dims=(32, 64))
    _compare_dataset(J(root, **kw), P(root, **kw), [0])
    # Nighttime Driving
    J, P = _both("NighttimeDriving", "seg_datasets")
    root = tmp_path / "nd"
    img_dir = root / "leftImg8bit" / "test" / "night"
    sem_dir = root / "gtCoarse_daytime_trainvaltest" / "test" / "night"
    os.makedirs(img_dir)
    os.makedirs(sem_dir)
    for i in range(2):
        Image.fromarray(smooth_image(rng, 40, 72)).save(
            img_dir / f"n{i}_leftImg8bit.png")
        Image.fromarray(blob_labels(rng, 40, 72)).save(
            sem_dir / f"n{i}_gtCoarse_labelTrainIds.png")
    _compare_dataset(J(str(root), dims=(32, 64)), P(str(root), dims=(32, 64)),
                     [0, 1])
    # BDD100k night: list-file driven; the first entry is written
    J, P = _both("BDD100kNight", "seg_datasets")
    root = str(tmp_path / "bdd")
    jds, pds = J(root, dims=(36, 64)), P(root, dims=(36, 64))
    assert pds.paths == jds.paths
    for k, arr in (("image", smooth_image(rng, 45, 80)),
                   ("semantic", blob_labels(rng, 45, 80))):
        os.makedirs(os.path.dirname(jds.paths[k][0]), exist_ok=True)
        Image.fromarray(arr).save(jds.paths[k][0], format="PNG")
    _compare_dataset(jds, pds, [0])


def test_robotcar_matches_jax(tmp_path):
    import h5py
    J, P = _both("RobotCar", "seg_datasets")
    rng = np.random.RandomState(4)
    root = tmp_path / "rc"
    for sub in ("training", "validation", "testing"):
        for d in ("imgs", "annos"):
            os.makedirs(root / "segmented_images" / sub / d)
        Image.fromarray(smooth_image(rng, 40, 40)).save(
            root / "segmented_images" / sub / "imgs" / "a.png")
        ids = rng.choice([0, 7, 8, 11, 21, 26, 33], (40, 40)).astype(np.uint8)
        Image.fromarray(ids).save(
            root / "segmented_images" / sub / "annos" / "a.png")
    for stage in ("train", "val", "test"):
        kw = dict(stage=stage, load_keys=["image", "semantic"], dims=(32, 32))
        _compare_dataset(J(str(root), **kw), P(str(root), **kw), [0])
    os.makedirs(root / "images")
    os.makedirs(root / "correspondence_data")
    for name in ("day1.png", "night1.png"):
        Image.fromarray(smooth_image(rng, 48, 48)).save(root / "images" / name)

    def str_to_mat(s):
        return np.array([[ord(c)] for c in s], dtype=np.uint16)

    with h5py.File(root / "correspondence_data" / "pair0.mat", "w") as f:
        f["im_i_path"] = str_to_mat("day1.png")
        f["im_j_path"] = str_to_mat("night1.png")
    kw = dict(stage="train", load_keys=["image_ref", "image"], dims=(32, 32))
    _compare_dataset(J(str(root), **kw), P(str(root), **kw), [0])


def test_megadepth_matches_jax(trees):
    J, P = _both("MegaDepth", "matching_datasets")
    root = os.path.join(trees, "MegaDepth")
    for in_mem in (True, False):
        kw = dict(stage="train", load_keys=["image_ref", "image",
                                            "image_prime"],
                  dims=(64, 64), exchange_images_with_proba=0.5,
                  store_scene_info_in_memory=in_mem)
        jds, pds = J(root, **kw), P(root, **kw)
        assert len(pds.items) == len(jds.items) == 30000
        for seed in (400, 7)[:2 if in_mem else 0]:
            jds.sample_new_items(seed)
            pds.sample_new_items(seed)
            for a, b in zip(pds.items, jds.items):
                assert_same(a, b)
        for a, b in zip(pds.items, jds.items):
            assert_same(a, b)
        _compare_dataset(jds, pds, [0, 3])
    kw = dict(stage="val", load_keys=["image_ref", "image"], dims=(48, 64))
    _compare_dataset(J(root, **kw), P(root, **kw), [0, 1])
    kw = dict(stage="train", load_keys=["image"], dims=(48, 64))
    _compare_dataset(J(root, **kw), P(root, **kw), [0, 1])
    kw = dict(stage="test", load_keys=["image_ref", "image"], dims=(48, 48))
    _compare_dataset(J(root, **kw), P(root, **kw), [0, 1])


def test_robotcar_matching_matches_jax(trees):
    J, P = _both("RobotCarMatching", "matching_datasets")
    root = os.path.join(trees, "MegaDepth", "Test")
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    src = os.path.join(root, "test1600Pairs")
    for name in os.listdir(src):
        Image.open(os.path.join(src, name)).save(
            os.path.join(root, "images", name))
    import shutil
    shutil.copy(os.path.join(root, "test1600Pairs.csv"),
                os.path.join(root, "test6511.csv"))
    kw = dict(stage="test", dims=(48, 48))
    _compare_dataset(J(root, **kw), P(root, **kw), [0, 1])


# ---------------------------------------------------------------------------
# loader and data module
# ---------------------------------------------------------------------------

def _modules(cfg, data_root):
    from refign_tpu.config import build_datamodule as jbuild
    from refign_tpu_torch.config import build_datamodule as pbuild
    return (jbuild(copy.deepcopy(cfg["data"]), data_root),
            pbuild(copy.deepcopy(cfg["data"]), data_root))


def jax_epoch(loader, ds, limit=None):
    """The JAX loader's process-mode batches of its next epoch (the first
    ``limit``), made in-process."""
    import refign_tpu.data.loader as JL
    batches = loader._index_batches()[:limit]
    epoch, loader.epoch = loader.epoch, loader.epoch + 1
    JL._WORKER_DS = ds
    try:
        out = []
        for b, idxs in enumerate(batches):
            saved = random.getstate(), np.random.get_state()
            out.append(JL._worker_batch((loader.seed, epoch, b, idxs)))
            random.setstate(saved[0])
            np.random.set_state(saved[1])
        return out
    finally:
        JL._WORKER_DS = None


@pytest.mark.parametrize("num_workers", [0, 2])
def test_train_batches_match_jax_and_ignore_workers(trees, num_workers):
    cfg = tiny_hrda_config(num_workers=num_workers)
    jdm, pdm = _modules(cfg, trees)
    jdm.setup("fit")
    pdm.setup("fit")
    jl = jdm.train_dataloaders(seed=3)
    pl = pdm.train_dataloaders(seed=3)
    assert [l.seed for l in pl] == [l.seed for l in jl] == [3, 3 + 7919]
    for jloader, ploader, jds in zip(jl, pl, jdm.datasets["train"]):
        for epoch in range(2):
            want = jax_epoch(jloader, jds)
            got = list(ploader)
            assert len(got) == len(want) == len(ploader)
            for g, w in zip(got, want):
                assert_same(g, w, f"epoch {epoch}")
        ploader.close()


def test_eval_and_stage1_batches_match_jax(trees):
    cfg = tiny_hrda_config()
    jdm, pdm = _modules(cfg, trees)
    for stage in ("validate", "test", "predict"):
        st = {"validate": "val"}.get(stage, stage)
        jdm.setup(stage)
        pdm.setup(stage)
        for jloader, ploader, jds in zip(jdm.eval_dataloaders(st),
                                         pdm.eval_dataloaders(st),
                                         jdm.datasets[st]):
            assert ploader.batch_size == jloader.batch_size
            for g, w in zip(list(ploader), jax_epoch(jloader, jds)):
                assert_same(g, w, stage)
    cfg = tiny_stage1_config(num_workers=2)
    jdm, pdm = _modules(cfg, trees)
    jdm.setup("fit")
    pdm.setup("fit")
    jloader, = jdm.train_dataloaders(seed=0)
    ploader, = pdm.train_dataloaders(seed=0)
    it = iter(ploader)
    want = jax_epoch(jloader, jdm.datasets["train"][0], limit=3)
    for b in range(3):
        assert_same(next(it), want[b], f"stage-1 batch {b}")
    ploader.close()
    for jloader, ploader, jds in zip(jdm.eval_dataloaders("val"),
                                     pdm.eval_dataloaders("val"),
                                     jdm.datasets["val"]):
        for g, w in zip(list(ploader), jax_epoch(jloader, jds)):
            assert_same(g, w, "stage-1 val")
        ploader.close()


def test_module_settings_and_drop_half_match_jax(trees):
    cfg = tiny_hrda_config()
    data = cfg["data"]["init_args"]
    data["ignore_every_second_semantic_training_batch"] = True
    data["load_config"]["train"]["Cityscapes"] = [
        data["load_config"]["train"]["Cityscapes"],
        copy.deepcopy(data["load_config"]["train"]["Cityscapes"])]
    data["batch_size"] = 3
    jdm, pdm = _modules(cfg, trees)
    for attr in ("stage_on", "batch_size", "val_batch_size",
                 "test_batch_size", "device_normalize", "normalize_settings",
                 "composite_flow_settings", "prime_photometric_settings"):
        assert getattr(pdm, attr) == getattr(jdm, attr), attr
    for stage in ("train", "val", "test", "predict"):
        for jc, pc in zip(jdm.stage_config[stage], pdm.stage_config[stage]):
            assert ([type(t).__name__ for t in pc["transforms"].transforms]
                    == [type(t).__name__ for t in jc["transforms"].transforms])
    rng = np.random.RandomState(0)
    subs = [{"image": rng.randint(0, 255, (1, 8, 8, 3), np.uint8),
             "semantic": rng.randint(0, 19, (1, 8, 8), np.uint8)}
            for _ in range(2)]
    subs.append({"image": rng.randint(0, 255, (1, 8, 8, 3), np.uint8),
                 "image_ref": rng.randint(0, 255, (1, 8, 8, 3), np.uint8)})
    tsubs = [{k: torch.from_numpy(v) for k, v in s.items()} for s in subs]
    random.seed(5)
    want = [jdm.merge_train_batch(subs) for _ in range(8)]
    random.seed(5)
    got = [pdm.merge_train_batch(tsubs) for _ in range(8)]
    assert {len(w["image_src"]) for w in want} == {1, 2}
    for g, w in zip(got, want):
        assert_same(g, w)
    got = pdm.merge_train_batch(tsubs, drop_half=False)
    assert_same(got, jdm.merge_train_batch(subs, drop_half=False))


def test_device_normalize_strips_train_stage_only(trees):
    cfg = tiny_stage1_config()
    for dn in (True, False):
        cfg["data"]["init_args"]["device_normalize"] = dn
        jdm, pdm = _modules(cfg, trees)
        for attr in ("device_normalize", "normalize_settings",
                     "composite_flow_settings",
                     "prime_photometric_settings"):
            assert getattr(pdm, attr) == getattr(jdm, attr), attr
        for stage in ("train", "val", "test"):
            for jc, pc in zip(jdm.stage_config[stage],
                              pdm.stage_config[stage]):
                assert pc["load_keys"] == jc["load_keys"]
                assert ([type(t).__name__ for t in pc["transforms"].transforms]
                        == [type(t).__name__
                            for t in jc["transforms"].transforms])


# ---------------------------------------------------------------------------
# prefetcher (tests/test_loader.py's behaviours)
# ---------------------------------------------------------------------------

def test_prefetcher_error_surfaces_on_next():
    from refign_tpu_torch.data.loader import DevicePrefetcher

    def boom():
        raise ValueError("boom")

    p = DevicePrefetcher(make_batch=boom, put=lambda b: b)
    with pytest.raises(ValueError, match="boom"):
        p.next()
    p.close()


def test_prefetcher_close_does_not_stall_on_error_with_full_queue():
    from refign_tpu_torch.data.loader import DevicePrefetcher
    calls = {"n": 0}

    def make_batch():
        calls["n"] += 1
        if calls["n"] <= 2:
            return calls["n"]
        raise ValueError("late boom")

    p = DevicePrefetcher(make_batch=make_batch, put=lambda b: b, depth=2)
    time.sleep(1.0)
    t0 = time.time()
    p.close()
    assert time.time() - t0 < 3.0
    assert not p._t.is_alive()


def test_prefetcher_next_after_close_raises_and_normal_flow():
    from refign_tpu_torch.data.loader import DevicePrefetcher
    p = DevicePrefetcher(make_batch=lambda: 42, put=lambda b: b * 2)
    assert p.next() == 84
    assert p.next() == 84
    p.close()
    with pytest.raises(RuntimeError, match="exhausted"):
        while True:
            p.next()


class _FlakyDataset:
    def __init__(self, n=8, bad=5):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError("corrupt sample")
        return {"image": np.full((4, 4, 3), i, np.uint8),
                "r": np.float32(random.random())}


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_surfaces_dataset_errors_and_stops_workers(num_workers):
    import multiprocessing
    from refign_tpu_torch.data.loader import DataLoader
    before = set(multiprocessing.active_children())
    loader = DataLoader(_FlakyDataset(), batch_size=2,
                        num_workers=num_workers)
    with pytest.raises(ValueError, match="corrupt sample"):
        for _ in loader:
            pass
    loader.close()
    loader = DataLoader(_FlakyDataset(n=12, bad=-1), batch_size=3,
                        num_workers=num_workers, shuffle=True, seed=4)
    a = [b["r"].numpy().copy() for b in loader]
    b = [b["r"].numpy().copy() for b in loader]
    assert len(a) == 4 and not np.array_equal(a, b)  # a new epoch
    loader.close()
    deadline = time.time() + 10
    while (set(multiprocessing.active_children()) - before
           and time.time() < deadline):
        time.sleep(0.1)
    assert not set(multiprocessing.active_children()) - before
