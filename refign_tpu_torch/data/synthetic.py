"""Synthetic dataset trees in the real datasets' layouts, made from a seed.

For runs without the datasets: the CPU tests build tiny trees, and
``chip_smoke.py`` builds them at the datasets' own sizes (Cityscapes
1024x2048, ACDC 1080x1920, MegaDepth photographs resized to the stage's
dims).  Images are smooth (upsampled low-resolution noise), so PNG sizes
and decode times resemble photographs; labels are blobs of classes on
road, so RandomCrop's ``cat_max_ratio`` loop and rare-class sampling see
class structure.  The MegaDepth train split is full length (its virtual
30000 items need as many sampled pairs): 100 scenes of 18 images, drawn
from a few shared image files.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Sequence, Tuple

import numpy as np
from PIL import Image

LISTS_DIR = os.path.join(os.path.dirname(__file__), "datasets", "lists")
BLOB_CLASSES = (1, 2, 5, 8, 10, 11, 13, 17)
ACDC_CONDITIONS = ("fog", "night", "rain", "snow")


def smooth_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A photograph-like uint8 (h, w, 3) image: bicubic upsampling of
    low-resolution noise, plus pixel noise."""
    low = rng.randint(0, 256, (max(h // 16, 2), max(w // 16, 2), 3),
                      dtype=np.uint8)
    img = np.asarray(Image.fromarray(low).resize((w, h), Image.BICUBIC),
                     np.int16)
    img = img + rng.randint(-8, 9, img.shape).astype(np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def blob_labels(rng: np.random.RandomState, h: int, w: int,
                n_blobs: int = 6) -> np.ndarray:
    """trainIds (h, w) uint8: road (0) with elliptic blobs of other
    classes and an ignored (255) strip at the top."""
    lab = np.zeros((h, w), np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for _ in range(n_blobs):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        ry, rx = rng.randint(h // 8 + 1, h // 3 + 2), rng.randint(
            w // 8 + 1, w // 3 + 2)
        lab[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1] = \
            BLOB_CLASSES[rng.randint(len(BLOB_CLASSES))]
    lab[: max(h // 16, 1)] = 255
    return lab


def make_cityscapes(root: str, n_train: int = 4, n_val: int = 2,
                    size: Tuple[int, int] = (64, 128), seed: int = 0) -> None:
    """leftImg8bit/gtFine train and val trees, and the rare-class files
    ``samples_with_class.json`` and ``sample_class_stats.json``."""
    rng = np.random.RandomState(seed)
    stats, with_class = [], {}
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir = os.path.join(root, "leftImg8bit", split, "cityA")
        sem_dir = os.path.join(root, "gtFine", split, "cityA")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(sem_dir, exist_ok=True)
        for i in range(n):
            Image.fromarray(smooth_image(rng, *size)).save(
                os.path.join(img_dir, f"a_{i:02d}_leftImg8bit.png"))
            lab = blob_labels(rng, *size)
            sem = os.path.join(sem_dir, f"a_{i:02d}_gtFine_labelTrainIds.png")
            Image.fromarray(lab).save(sem)
            if split != "train":
                continue
            cls, cnt = np.unique(lab, return_counts=True)
            row = {"file": sem}
            for c, k in zip(cls, cnt):
                if c == 255:
                    continue
                row[str(int(c))] = int(k)
                with_class.setdefault(str(int(c)), []).append([sem, int(k)])
            stats.append(row)
    with open(os.path.join(root, "sample_class_stats.json"), "w") as f:
        json.dump(stats, f)
    with open(os.path.join(root, "samples_with_class.json"), "w") as f:
        json.dump(with_class, f)


def make_acdc(root: str, n_train: int = 4, n_val: int = 2, n_test: int = 2,
              size: Tuple[int, int] = (64, 128), seed: int = 1) -> None:
    """rgb_anon/<cond>/{train,val,test} with their ``_ref`` twins and gt
    trees, each split's images spread over the four conditions in turn."""
    rng = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        for cond in ACDC_CONDITIONS:
            for d in (os.path.join(root, "rgb_anon", cond, split),
                      os.path.join(root, "gt", cond, split)):
                os.makedirs(d, exist_ok=True)
        for i in range(n):
            cond = ACDC_CONDITIONS[i % len(ACDC_CONDITIONS)]
            img_dir = os.path.join(root, "rgb_anon", cond, split, "r0")
            ref_dir = os.path.join(root, "rgb_anon", cond, split + "_ref",
                                   "r0")
            sem_dir = os.path.join(root, "gt", cond, split, "r0")
            for d in (img_dir, ref_dir, sem_dir):
                os.makedirs(d, exist_ok=True)
            Image.fromarray(smooth_image(rng, *size)).save(
                os.path.join(img_dir, f"{cond}_{i:02d}_rgb_anon.png"))
            Image.fromarray(smooth_image(rng, *size)).save(
                os.path.join(ref_dir, f"{cond}_{i:02d}_rgb_ref_anon.png"))
            Image.fromarray(blob_labels(rng, *size)).save(os.path.join(
                sem_dir, f"{cond}_{i:02d}_gt_labelTrainIds.png"))


def _scene_list(name: str) -> Sequence[str]:
    with open(os.path.join(LISTS_DIR, name)) as f:
        return f.read().split()


def make_megadepth(root: str, n_train_scenes: int = 100, per_scene: int = 18,
                   n_val_img: int = 4, n_files: int = 6,
                   size: Tuple[int, int] = (96, 96), seed: int = 0) -> None:
    """scene_info npz files for the first ``n_train_scenes`` train scenes
    (``per_scene`` images each, every pair overlapping: 306 pairs of 18,
    of which a scene contributes 300) and one validation scene of
    ``n_val_img`` images, their images drawn from ``n_files`` shared JPEG
    files of ``size``; and the test CSV of two pairs."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "scene_info"), exist_ok=True)
    os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
    files = []
    for k in range(n_files):
        rel = f"imgs/im_{k}.jpg"
        Image.fromarray(smooth_image(rng, *size)).save(
            os.path.join(root, rel), quality=90)
        files.append(rel)
    scenes = ([(s, per_scene) for s in
               _scene_list("train_scenes_MegaDepth.txt")[:n_train_scenes]]
              + [(_scene_list("validation_scenes_MegaDepth.txt")[0],
                  n_val_img)])
    h, w = size
    for j, (scene, n_img) in enumerate(scenes):
        image_paths = np.array([files[(i + j) % n_files]
                                for i in range(n_img)] + [None],
                               dtype=object)
        depth_paths = np.array(["d"] * n_img + [None], dtype=object)
        p2d = np.array([
            {pid: (rng.rand(2) * [w - 1, h - 1]).astype(np.float32)
             for pid in range(12) if rng.rand() < 0.8}
            for _ in range(n_img)] + [None], dtype=object)
        overlap = 0.3 + 0.6 * rng.rand(n_img + 1, n_img + 1)
        overlap[np.arange(n_img + 1), np.arange(n_img + 1)] = 0
        overlap[n_img] = overlap[:, n_img] = 0
        np.savez(os.path.join(root, "scene_info", f"{scene}.0.npz"),
                 image_paths=image_paths, depth_paths=depth_paths,
                 points3D_id_to_2D=p2d,
                 overlap_matrix=overlap.astype(np.float32))
    test_dir = os.path.join(root, "Test", "test1600Pairs")
    os.makedirs(test_dir, exist_ok=True)
    for name in ("a.jpg", "b.jpg", "c.jpg"):
        Image.fromarray(smooth_image(rng, *size)).save(
            os.path.join(test_dir, name))
    with open(os.path.join(root, "Test", "test1600Pairs.csv"), "w") as f:
        out = csv.writer(f)
        out.writerow(["scene", "source_image", "target_image",
                      "XA", "YA", "XB", "YB"])
        out.writerow(["/", "a.jpg", "b.jpg", "10;20;30", "10;15;20",
                      "12;22;31", "11;14;22"])
        out.writerow(["/", "c.jpg", "a.jpg", "5;50", "7;60", "6;52",
                      "9;58"])
