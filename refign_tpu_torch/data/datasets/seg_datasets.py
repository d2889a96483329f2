"""Semantic-segmentation datasets (host side, PIL + numpy).

Directory conventions and filename substitutions mirror the reference
datasets (data_modules/datasets/{cityscapes,acdc,darkzurich,robotcar,
nighttimedriving,bdd100knight}.py); samples are dicts of PIL images handed
to the host transform pipeline.  Rare Class Sampling reproduces
cityscapes.py:139-191.

A copy of ``refign_tpu/data/datasets/seg_datasets.py``, which the port
may not import; the split lists under ``lists/`` are copied too.
"""
from __future__ import annotations

import json
import os
import random as pyrandom

import numpy as np
from PIL import Image

from ..transforms import PILLOW_INTERP

LISTS_DIR = os.path.join(os.path.dirname(__file__), "lists")


def _as_list(v):
    return [v] if isinstance(v, str) else list(v)


def _open_rgb(path, dims):
    img = Image.open(path).convert("RGB")
    if dims is not None and img.size != dims[::-1]:
        img = img.resize(dims[::-1], PILLOW_INTERP["bilinear"])
    return img


def _open_semantic(path, dims, encode=None):
    img = Image.open(path)
    if encode is not None:
        img = encode(img)
    if dims is not None and img.size != dims[::-1]:
        img = img.resize(dims[::-1], PILLOW_INTERP["nearest"])
    return img


class _SegDataset:
    """Common loader skeleton: a dict of per-key path lists."""
    orig_dims = (1024, 2048)

    def __init__(self, root, stage, load_keys, dims, transforms):
        self.root = root
        self.stage = stage
        self.load_keys = _as_list(load_keys)
        self.dims = tuple(dims) if dims is not None else None
        self.transforms = transforms
        self.paths = {}

    def __len__(self):
        return len(next(iter(self.paths.values())))

    def _load(self, index):
        sample = {"filename": os.path.basename(self.paths["image"][index])}
        for k in self.load_keys:
            if k in ("image", "image_ref"):
                sample[k] = _open_rgb(self.paths[k][index], self.dims)
            elif k == "semantic":
                sample[k] = _open_semantic(self.paths[k][index], self.dims,
                                           getattr(self, "_encode", None))
            else:
                raise ValueError(k)
        return sample

    def __getitem__(self, index):
        sample = self._load(index)
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample


class Cityscapes(_SegDataset):
    """reference data_modules/datasets/cityscapes.py:12-191."""
    orig_dims = (1024, 2048)

    def __init__(self, root, stage="train",
                 load_keys=("image", "semantic"),
                 dims=(1024, 2048), transforms=None,
                 rcs_enabled=False, rcs_class_temp=0.01,
                 rcs_min_crop_ratio=0.5, rcs_min_pixels=3000, **kwargs):
        super().__init__(root, stage, load_keys, dims, transforms)
        split = {"train": "train", "val": "val", "test": "val",
                 "predict": "test"}[stage]
        self.split = split
        images_dir = os.path.join(root, "leftImg8bit", split)
        semantic_dir = os.path.join(root, "gtFine", split)
        if not (os.path.isdir(images_dir) and os.path.isdir(semantic_dir)):
            raise RuntimeError(f"Cityscapes not found under {root}")
        self.paths = {k: [] for k in self.load_keys}
        for city in sorted(os.listdir(images_dir)):
            for fn in sorted(os.listdir(os.path.join(images_dir, city))):
                for k in self.load_keys:
                    if k == "image":
                        self.paths[k].append(
                            os.path.join(images_dir, city, fn))
                    elif k == "semantic":
                        self.paths[k].append(os.path.join(
                            semantic_dir, city,
                            fn.replace("leftImg8bit.png",
                                       "gtFine_labelTrainIds.png")))

        self.rcs_enabled = rcs_enabled
        self.rcs_min_crop_ratio = rcs_min_crop_ratio
        self.rcs_min_pixels = rcs_min_pixels
        if rcs_enabled:
            self.rcs_classes, self.rcs_classprob = self.get_rcs_class_probs(
                root, rcs_class_temp)
            with open(os.path.join(root, "samples_with_class.json")) as f:
                swc = {int(k): v for k, v in json.load(f).items()
                       if int(k) in self.rcs_classes}
            self.indices_with_class = {}
            for c in self.rcs_classes:
                idxs = [self.paths["semantic"].index(os.path.expandvars(fp))
                        for fp, px in swc[c] if px > rcs_min_pixels]
                assert idxs, f"no samples for rare class {c}"
                self.indices_with_class[c] = idxs

    @staticmethod
    def get_rcs_class_probs(data_root, temperature):
        """Temperature-softmax of inverted class frequencies
        (reference cityscapes.py:160-191)."""
        with open(os.path.join(data_root, "sample_class_stats.json")) as f:
            stats = json.load(f)
        overall = {}
        for s in stats:
            s.pop("file")
            for c, n in s.items():
                overall[int(c)] = overall.get(int(c), 0) + n
        overall = dict(sorted(overall.items(), key=lambda kv: kv[1]))
        freq = np.array(list(overall.values()), np.float64)
        freq = 1 - freq / freq.sum()
        e = np.exp(freq / temperature - (freq / temperature).max())
        return list(overall.keys()), e / e.sum()

    def __getitem__(self, index):
        if self.rcs_enabled:
            return self.get_rare_class_sample()
        return super().__getitem__(index)

    def get_rare_class_sample(self):
        """reference cityscapes.py:139-158."""
        c = pyrandom.choices(self.rcs_classes,
                             weights=self.rcs_classprob, k=1)[0]
        index = pyrandom.choice(self.indices_with_class[c])
        sample = super().__getitem__(index)
        if self.rcs_min_crop_ratio > 0:
            for _ in range(10):
                n_class = int(np.sum(np.asarray(sample["semantic"]) == c))
                if n_class > self.rcs_min_pixels * self.rcs_min_crop_ratio:
                    break
                sample = super().__getitem__(index)
        return sample


class ACDC(_SegDataset):
    """reference data_modules/datasets/acdc.py:10-125."""
    orig_dims = (1080, 1920)

    def __init__(self, root, stage="train",
                 condition=("fog", "night", "rain", "snow"),
                 load_keys=("image_ref", "image", "semantic"),
                 dims=(1080, 1920), transforms=None, predict_on=None,
                 **kwargs):
        super().__init__(root, stage, load_keys, dims, transforms)
        split = {"train": "train", "val": "val", "test": "val",
                 "predict": predict_on or "test"}[stage]
        self.split = split
        images_dir = os.path.join(root, "rgb_anon")
        semantic_dir = os.path.join(root, "gt")
        self.paths = {k: [] for k in ("image", "image_ref", "semantic")}
        for cond in _as_list(condition):
            img_parent = os.path.join(images_dir, cond, split)
            sem_parent = os.path.join(semantic_dir, cond, split)
            for rec in sorted(os.listdir(img_parent)):
                for fn in sorted(os.listdir(os.path.join(img_parent, rec))):
                    self.paths["image"].append(
                        os.path.join(img_parent, rec, fn))
                    self.paths["image_ref"].append(os.path.join(
                        img_parent.replace(split, split + "_ref"), rec,
                        fn.replace("rgb_anon", "rgb_ref_anon")))
                    self.paths["semantic"].append(os.path.join(
                        sem_parent, rec,
                        fn.replace("rgb_anon.png", "gt_labelTrainIds.png")))


class DarkZurich(_SegDataset):
    """reference data_modules/datasets/darkzurich.py:10-146: train pairs
    from lists/zurich_dn_pair_train.csv; val/test ref matched by prefix."""
    orig_dims = (1080, 1920)

    def __init__(self, root, stage="train",
                 load_keys=("image_ref", "image"),
                 dims=(1080, 1920), transforms=None, predict_on=None,
                 **kwargs):
        super().__init__(root, stage, load_keys, dims, transforms)
        split = {"train": "train", "val": "val", "test": "val",
                 "predict": predict_on or "test"}[stage]
        self.split = split
        self.paths = {k: [] for k in ("image", "image_ref", "semantic")}
        if split == "train":
            with open(os.path.join(LISTS_DIR,
                                   "zurich_dn_pair_train.csv")) as f:
                for line in f:
                    night, day = line.strip().split(",")
                    self.paths["image"].append(os.path.join(
                        root, "rgb_anon", night + "_rgb_anon.png"))
                    self.paths["image_ref"].append(os.path.join(
                        root, "rgb_anon", day + "_rgb_anon.png"))
        else:
            img_parent = os.path.join(root, "rgb_anon", split, "night")
            sem_parent = os.path.join(root, "gt", split, "night")
            for rec in sorted(os.listdir(img_parent)):
                img_dir = os.path.join(img_parent, rec)
                for fn in sorted(os.listdir(img_dir)):
                    self.paths["image"].append(os.path.join(img_dir, fn))
                    ref_dir = (img_dir.replace(split, split + "_ref")
                               .replace("night", "day")
                               .replace(rec, rec + "_ref"))
                    if split == "val":
                        ref_fn = fn.replace("rgb_anon.png",
                                            "ref_rgb_anon.png")
                    else:
                        start = fn.split("rgb_anon.png")[0]
                        ref_fn = next(f for f in sorted(os.listdir(ref_dir))
                                      if f.startswith(start))
                    self.paths["image_ref"].append(
                        os.path.join(ref_dir, ref_fn))
                    self.paths["semantic"].append(os.path.join(
                        sem_parent, rec,
                        fn.replace("rgb_anon.png", "gt_labelTrainIds.png")))


class NighttimeDriving(_SegDataset):
    """reference nighttimedriving.py:10-89 (test-only night set)."""
    orig_dims = (1080, 1920)

    def __init__(self, root, stage="test", load_keys=("image", "semantic"),
                 dims=(1080, 1920), transforms=None, **kwargs):
        assert stage == "test"
        super().__init__(root, stage, load_keys, dims, transforms)
        img_dir = os.path.join(root, "leftImg8bit", "test", "night")
        sem_dir = os.path.join(root, "gtCoarse_daytime_trainvaltest",
                               "test", "night")
        self.paths = {k: [] for k in self.load_keys}
        for fn in sorted(os.listdir(img_dir)):
            if "image" in self.paths:
                self.paths["image"].append(os.path.join(img_dir, fn))
            if "semantic" in self.paths:
                self.paths["semantic"].append(os.path.join(
                    sem_dir, fn.replace("leftImg8bit.png",
                                        "gtCoarse_labelTrainIds.png")))


class BDD100kNight(_SegDataset):
    """reference bdd100knight.py:10-78 (test-only, list-file driven)."""
    orig_dims = (720, 1280)

    def __init__(self, root, stage="test", load_keys=("image", "semantic"),
                 dims=(720, 1280), transforms=None, **kwargs):
        assert stage == "test"
        super().__init__(root, stage, load_keys, dims, transforms)
        self.paths = {k: [] for k in self.load_keys}
        with open(os.path.join(
                LISTS_DIR,
                "images_trainval_night_correct_filenames.txt")) as f:
            for line in f:
                _, _, split, name = line.strip().split("/")
                if "image" in self.paths:
                    self.paths["image"].append(os.path.join(
                        root, "images", "10k", split, name))
                if "semantic" in self.paths:
                    self.paths["semantic"].append(os.path.join(
                        root, "labels", "sem_seg", "masks", split,
                        name.replace(".jpg", ".png")))


# RobotCar label id -> train id (reference robotcar.py:15-20)
_ROBOTCAR_ID_TO_TRAINID = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}


class RobotCar(_SegDataset):
    """reference robotcar.py:12-165: supervised segmented_images splits +
    unsupervised day-night pairs from MATLAB correspondence files."""
    orig_dims = (1024, 1024)

    def __init__(self, root, stage="train",
                 load_keys=("image_ref", "image", "semantic"),
                 dims=(1024, 1024), transforms=None, **kwargs):
        super().__init__(root, stage, load_keys, dims, transforms)
        split = {"train": "train", "val": "val", "test": "test",
                 "predict": "test"}[stage]
        self.split = split
        self.corr_mode = False
        if split == "train" and "semantic" not in self.load_keys:
            # unsupervised split: pairs come from .mat correspondence files
            self.corr_mode = True
            self.images_dir = os.path.join(root, "images")
            corr_dir = os.path.join(root, "correspondence_data")
            self.paths = {"corr_files": sorted(
                os.path.join(corr_dir, fn) for fn in os.listdir(corr_dir)
                if fn.endswith("mat"))}
        else:
            subdir = {"train": "training", "val": "validation",
                      "test": "testing"}[split]
            images_dir = os.path.join(root, "segmented_images", subdir,
                                      "imgs")
            annos_dir = os.path.join(root, "segmented_images", subdir,
                                     "annos")
            self.paths = {k: [] for k in self.load_keys if k != "image_ref"}
            for fn in sorted(os.listdir(images_dir)):
                if "image" in self.paths:
                    self.paths["image"].append(os.path.join(images_dir, fn))
                if "semantic" in self.paths:
                    self.paths["semantic"].append(
                        os.path.join(annos_dir, fn))

    @staticmethod
    def _encode(semseg):
        arr = np.asarray(semseg)
        out = np.full_like(arr, 255)
        for k, v in _ROBOTCAR_ID_TO_TRAINID.items():
            out[arr == k] = v
        return Image.fromarray(out.astype(np.uint8))

    def __getitem__(self, index):
        if not self.corr_mode:
            return super().__getitem__(index)
        import h5py
        sample = {}
        with h5py.File(self.paths["corr_files"][index], "r") as f:
            content = {k: np.array(v) for k, v in f.items()}
        im1 = "".join(chr(a[0]) for a in content["im_i_path"])
        im2 = "".join(chr(a[0]) for a in content["im_j_path"])
        sample["filename"] = im2.split("/")[-1]
        for k in self.load_keys:
            if k == "image_ref":
                sample[k] = _open_rgb(os.path.join(self.images_dir, im1),
                                      self.dims)
            elif k == "image":
                sample[k] = _open_rgb(os.path.join(self.images_dir, im2),
                                      self.dims)
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample
