"""Dense-matching datasets: MegaDepth (train/val/test) + RobotCarMatching.

Mirrors reference data_modules/datasets/megadepth.py:19-438 and
robotcarmatching.py:12-113: SfM scene_info pair sampling by overlap ratio,
3D-point -> 2D sparse correspondences, the 30k virtual train length, and
CSV-driven sparse test pairs.  Host side (numpy/PIL); sampling is
deterministic given the seed and can be re-run per epoch
(``sample_new_items``) while the device never stalls (prefetch happens in
the loader).

A copy of ``refign_tpu/data/datasets/matching_datasets.py``, which the port
may not import; the split lists under ``lists/`` are copied too.
"""
from __future__ import annotations

import csv
import os
import random as pyrandom

import numpy as np
from PIL import Image

from ..transforms import PILLOW_INTERP

LISTS_DIR = os.path.join(os.path.dirname(__file__), "lists")


def _read_pts_csv_field(field: str) -> np.ndarray:
    return np.array(list(map(float, field.split(";"))), np.float32)


class MegaDepth:
    """reference megadepth.py:19-438."""

    cfg = {
        "train_split": "train_scenes_MegaDepth.txt",
        "train_debug_split": "train_debug_scenes_MegaDepth.txt",
        "val_split": "validation_scenes_MegaDepth.txt",
        "test_split": "test_scenes_MegaDepth.txt",
        "train_debug_num_per_scene": 10,
        "train_num_per_scene": 300,
        "val_num_per_scene": 25,
        "min_overlap_ratio": 0.3,
        "max_overlap_ratio": 1.0,
    }

    def __init__(self, root, stage="train",
                 load_keys=("image_ref", "image", "image_prime"),
                 dims=None, transforms=None,
                 exchange_images_with_proba: float = 0.0,
                 store_scene_info_in_memory: bool = False,
                 debug: bool = False, **kwargs):
        self.root = root
        self.dims = tuple(dims) if dims is not None else None
        self.transforms = transforms
        self.exchange_images_with_proba = exchange_images_with_proba
        self.load_keys = ([load_keys] if isinstance(load_keys, str)
                          else list(load_keys))
        split = {"train": "train", "val": "val", "test": "test",
                 "predict": "test"}[stage]
        if debug:
            split = "train_debug"
        self.split = split

        if split == "test":
            assert "image_prime" not in self.load_keys
            self.rows = []
            with open(os.path.join(root, "Test", "test1600Pairs.csv")) as f:
                self.rows = list(csv.DictReader(f))
            self.images_dir = os.path.join(root, "Test", "test1600Pairs")
            return

        self.scene_info_path = os.path.join(root, "scene_info")
        with open(os.path.join(LISTS_DIR, self.cfg[split + "_split"])) as f:
            self.scenes = f.read().split()
        self.two_views = ("image_ref" in self.load_keys
                          and "image" in self.load_keys)
        self.store_scene_info_in_memory = (store_scene_info_in_memory
                                           or not self.two_views)
        if self.store_scene_info_in_memory:
            self.save_scene_info()
        self.items = []
        self.sample_new_items()

    # -- scene info ---------------------------------------------------------

    def _load_scene(self, scene):
        path = os.path.join(self.scene_info_path, f"{scene}.0.npz")
        if not os.path.exists(path):
            return None
        return np.load(path, allow_pickle=True)

    def save_scene_info(self):
        """Cache image paths / 2D points / overlap pairs in RAM
        (reference megadepth.py:136-172, ~35 GB for the full train set)."""
        self.images, self.points3D_id_to_2D, self.pairs = {}, {}, {}
        for scene in self.scenes:
            info = self._load_scene(scene)
            if info is None:
                continue
            valid = ((info["image_paths"] != None)        # noqa: E711
                     & (info["depth_paths"] != None))     # noqa: E711
            self.images[scene] = info["image_paths"][valid].copy()
            if self.two_views:
                self.points3D_id_to_2D[scene] = \
                    info["points3D_id_to_2D"][valid].copy()
                mat = info["overlap_matrix"][valid][:, valid]
                sel = ((mat > self.cfg["min_overlap_ratio"])
                       & (mat <= self.cfg["max_overlap_ratio"]))
                ij = np.stack(np.where(sel), -1)
                self.pairs[scene] = [(i, j, mat[i, j]) for i, j in ij]
            del info

    def sample_new_items(self, seed: int = 400):
        """Pair (re)sampling — reference-exact (megadepth.py:174-253),
        including its quirks: called ONCE from __init__ (the reference has
        no per-epoch resampling call site either) and a fresh
        RandomState(seed) per scene, so scene selections share one
        stream.  Coverage across a 400k-step run comes from the 30k
        virtual epoch length + per-epoch loader shuffle."""
        self.items = []
        num = self.cfg[self.split + "_num_per_scene"]
        for scene in self.scenes:
            if self.two_views and self.store_scene_info_in_memory:
                if scene not in self.pairs:
                    continue
                pairs = np.array(self.pairs[scene])
                if len(pairs) > num:
                    sel = np.random.RandomState(seed).choice(
                        len(pairs), num, replace=False)
                    pairs = pairs[sel]
                self.items.extend(
                    (scene, int(i), int(j), k) for i, j, k in pairs)
            elif self.two_views:
                info = self._load_scene(scene)
                if info is None:
                    continue
                valid = ((info["image_paths"] != None)    # noqa: E711
                         & (info["depth_paths"] != None))  # noqa: E711
                paths = info["image_paths"][valid]
                p3d = info["points3D_id_to_2D"][valid]
                mat = info["overlap_matrix"][valid][:, valid]
                sel = ((mat > self.cfg["min_overlap_ratio"])
                       & (mat <= self.cfg["max_overlap_ratio"]))
                pairs = np.stack(np.where(sel), -1)
                if len(pairs) > num:
                    chosen = np.random.RandomState(seed).choice(
                        len(pairs), num, replace=False)
                    pairs = pairs[chosen]
                for i1, i2 in pairs:
                    matches = np.array(
                        list(p3d[i1].keys() & p3d[i2].keys()))
                    pts1 = np.array([p3d[i1][m] for m in matches],
                                    np.float32).reshape(-1, 2)
                    pts2 = np.array([p3d[i2][m] for m in matches],
                                    np.float32).reshape(-1, 2)
                    self.items.append(dict(image_path1=paths[i1],
                                           image_path2=paths[i2],
                                           pts1=pts1, pts2=pts2))
                del info
            else:
                ids = np.arange(len(self.images.get(scene, [])))
                if len(ids) > num:
                    ids = np.random.RandomState(seed).choice(
                        ids, num, replace=False)
                self.items.extend((scene, int(i)) for i in ids)
        if "debug" in self.split:
            base = list(self.items)
            for _ in range(10):
                self.items.extend(base)
        np.random.RandomState(seed).shuffle(self.items)

    def __len__(self):
        if self.split == "train":
            return 30000  # virtual epoch length (reference megadepth.py:257)
        if self.split == "test":
            return len(self.rows)
        return len(self.items)

    # -- getitem ------------------------------------------------------------

    def _pair_bundle(self, item):
        if isinstance(item, dict):
            return item
        scene, i1, i2, _ = item
        p3d = self.points3D_id_to_2D[scene]
        matches = np.array(list(p3d[i1].keys() & p3d[i2].keys()))
        pts1 = np.array([p3d[i1][m] for m in matches],
                        np.float32).reshape(-1, 2)
        pts2 = np.array([p3d[i2][m] for m in matches],
                        np.float32).reshape(-1, 2)
        return dict(image_path1=self.images[scene][i1],
                    image_path2=self.images[scene][i2],
                    pts1=pts1, pts2=pts2)

    def _open(self, rel, pts):
        img = Image.open(os.path.join(self.root, rel)).convert("RGB")
        if self.dims is not None and img.size != self.dims[::-1]:
            w, h = img.size
            img = img.resize(self.dims[::-1], PILLOW_INTERP["lanczos"])
            pts = pts.copy()
            pts[:, 0] *= self.dims[1] / float(w)
            pts[:, 1] *= self.dims[0] / float(h)
        return img, pts

    def __getitem__(self, index):
        if self.split == "test":
            row = self.rows[index]
            scene = row["scene"] if row["scene"] != "/" else "."
            pts_trg = np.stack([_read_pts_csv_field(row["XB"]),
                                _read_pts_csv_field(row["YB"])], 1)
            pts_src = np.stack([_read_pts_csv_field(row["XA"]),
                                _read_pts_csv_field(row["YA"])], 1)
            sample = {}
            for k in self.load_keys:
                name = row["source_image" if k == "image_ref"
                           else "target_image"]
                img = Image.open(os.path.join(
                    self.images_dir, scene, name)).convert("RGB")
                if self.dims is not None and img.size != self.dims[::-1]:
                    w, h = img.size
                    img = img.resize(self.dims[::-1],
                                     PILLOW_INTERP["lanczos"])
                    p = pts_src if k == "image_ref" else pts_trg
                    p[:, 0] *= self.dims[1] / float(w)
                    p[:, 1] *= self.dims[0] / float(h)
                sample[k] = img
            sample["corr_pts"] = pts_trg
            sample["corr_pts_ref"] = pts_src
        elif self.two_views:
            bundle = self._pair_bundle(self.items[index])
            if pyrandom.random() < self.exchange_images_with_proba:
                p1, p2 = bundle["image_path2"], bundle["image_path1"]
                pts1, pts2 = bundle["pts2"], bundle["pts1"]
            else:
                p1, p2 = bundle["image_path1"], bundle["image_path2"]
                pts1, pts2 = bundle["pts1"], bundle["pts2"]
            src, pts1 = self._open(p1, pts1)
            trg, pts2 = self._open(p2, pts2)
            sample = {"image_ref": src, "image": trg,
                      "corr_pts_ref": pts1, "corr_pts": pts2,
                      "image_prime_idx": np.ones(1, np.int64)}
            if "image_prime" in self.load_keys:
                sample["image_prime"] = trg.copy()
        else:
            scene, idx = self.items[index]
            img = Image.open(os.path.join(
                self.root, self.images[scene][idx])).convert("RGB")
            if self.dims is not None and img.size != self.dims[::-1]:
                img = img.resize(self.dims[::-1], PILLOW_INTERP["lanczos"])
            sample = {"image": img}
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample


class RobotCarMatching:
    """PCK test set from test6511.csv sparse correspondences
    (reference robotcarmatching.py:12-113)."""
    orig_dims = (1024, 1024)

    def __init__(self, root, stage="test", load_keys=("image_ref", "image"),
                 dims=None, transforms=None, resize_filter="lanczos",
                 **kwargs):
        assert stage in ("test", "predict")
        self.root = root
        self.dims = tuple(dims) if dims is not None else None
        self.transforms = transforms
        self.resize_filter = resize_filter
        self.load_keys = ([load_keys] if isinstance(load_keys, str)
                          else list(load_keys))
        with open(os.path.join(root, "test6511.csv")) as f:
            self.rows = list(csv.DictReader(f))
        self.images_dir = os.path.join(root, "images")

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, index):
        row = self.rows[index]
        scene = row["scene"] if row["scene"] != "/" else "."
        pts_trg = np.stack([_read_pts_csv_field(row["XB"]),
                            _read_pts_csv_field(row["YB"])], 1)
        pts_src = np.stack([_read_pts_csv_field(row["XA"]),
                            _read_pts_csv_field(row["YA"])], 1)
        sample = {}
        for k in self.load_keys:
            name = row["source_image" if k == "image_ref"
                       else "target_image"]
            img = Image.open(os.path.join(
                self.images_dir, scene, name)).convert("RGB")
            if self.dims is not None and img.size != self.dims[::-1]:
                w, h = img.size
                img = img.resize(self.dims[::-1],
                                 PILLOW_INTERP[self.resize_filter])
                p = pts_src if k == "image_ref" else pts_trg
                p[:, 0] *= self.dims[1] / float(w)
                p[:, 1] *= self.dims[0] / float(h)
            sample[k] = img
        sample["corr_pts"] = pts_trg
        sample["corr_pts_ref"] = pts_src
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample
