"""Combined data module: config-driven multi-dataset loaders + batch merge
(counterpart of ``refign_tpu/data/module.py``).

Equivalent of the reference's CombinedDataModule
(data_modules/combined_data_module.py:31-310): parses a per-stage
``load_config`` (dataset -> conf or list of confs), builds one loader per
dataset, and merges training sub-batches into the UDA batch dict
(image_src/semantic_src/image_trg/image_ref/...).

Transforms are given as reference-style ``class_path``/``init_args`` dicts
(see ``config.py``) or already-instantiated callables.  A ``CompositeFlow``
transform entry and the prime view's photometric transforms are stripped
from the host pipeline; their settings surface as
``composite_flow_settings`` and ``prime_photometric_settings`` for the
alignment train step, which makes the prime view on the card.

``device_normalize`` (default on): the train stage's ConvertImageDtype and
Normalize are stripped, so train batches stay uint8 on the host and travel
to the card at a quarter of the fp32 bytes; the train steps normalise them
there (``uda/trainer.py:device_normalize``,
``alignment/trainer.py:device_normalize``).  Evaluation pipelines keep
both.  The JAX module's environment switch for it is not ported.
"""
from __future__ import annotations

import os
import random as pyrandom
from typing import Any, Dict, List, Optional

import torch

from . import transforms as T
from .loader import DataLoader
from .datasets.matching_datasets import MegaDepth, RobotCarMatching
from .datasets.seg_datasets import (ACDC, BDD100kNight, Cityscapes,
                                    DarkZurich, NighttimeDriving, RobotCar)

DATASETS = {
    "Cityscapes": Cityscapes,
    "ACDC": ACDC,
    "DarkZurich": DarkZurich,
    "NighttimeDriving": NighttimeDriving,
    "BDD100kNight": BDD100kNight,
    "RobotCar": RobotCar,
    "MegaDepth": MegaDepth,
    "RobotCarMatching": RobotCarMatching,
}

# reference data-dir layout (combined_data_module.py:46-55)
DATA_SUBDIRS = {
    "ACDC": "ACDC",
    "Cityscapes": "Cityscapes",
    "DarkZurich": "DarkZurich",
    "NighttimeDriving": "NighttimeDrivingTest",
    "BDD100kNight": "bdd100k",
    "RobotCar": "RobotCar",
    "MegaDepth": "MegaDepth",
    "RobotCarMatching": "RobotCar",
}


def _cat(xs):
    """Concatenate sub-batch tensors; a single one is passed through, so
    a pinned batch stays pinned."""
    return xs[0] if len(xs) == 1 else torch.cat(xs)


def _instantiate_transform(spec):
    if callable(spec):
        return spec
    class_path = spec["class_path"]
    name = class_path.split(".")[-1]
    init_args = spec.get("init_args", {})
    cls = getattr(T, name)
    return cls(**init_args)


class CombinedDataModule:

    def __init__(self, load_config: Dict[str, Any],
                 num_workers: int = 4,
                 batch_size: int = 8,
                 batch_size_divisor: int = 1,
                 data_dir: Optional[str] = None,
                 debug: bool = False,
                 ignore_every_second_semantic_training_batch: bool = False,
                 device_normalize: bool = True,
                 **kwargs):
        data_dir = data_dir or os.environ.get("DATA_DIR", "")
        self.debug = debug
        self.data_dirs = {
            k: os.path.join(data_dir,
                            ("MegaDepth_debug" if debug and k == "MegaDepth"
                             else v))
            for k, v in DATA_SUBDIRS.items()
        }
        self.num_workers = num_workers
        assert batch_size % batch_size_divisor == 0
        self.batch_size = batch_size // batch_size_divisor
        self.ignore_every_second_semantic_training_batch = \
            ignore_every_second_semantic_training_batch

        self.stage_on: Dict[str, List[str]] = {}
        self.stage_config: Dict[str, List[dict]] = {}
        self.composite_flow_settings: Optional[dict] = None
        for stage in ("train", "val", "test", "predict"):
            names, confs = [], []
            for ds, conf in (load_config.get(stage) or {}).items():
                for el in (conf if isinstance(conf, list) else [conf]):
                    names.append(ds)
                    confs.append(dict(el))
            self.stage_on[stage] = names
            self.stage_config[stage] = confs
        self.idx_to_name = {
            stage: dict(enumerate(names))
            for stage, names in self.stage_on.items()
        }
        self.train_on = self.stage_on["train"]
        self.predict_on = self.stage_on["predict"]
        if self.train_on:
            assert self.batch_size % len(self.train_on) == 0, \
                "batch size must divide evenly among train datasets"

        # build the transform pipelines; strip CompositeFlow, the prime
        # view's photometric transforms and (device_normalize) the train
        # stage's ConvertImageDtype + Normalize to the card
        self.device_normalize = bool(device_normalize)
        self.prime_photometric_settings: dict = {}
        self.normalize_settings: Optional[dict] = None
        for stage in ("train", "val", "test", "predict"):
            for conf in self.stage_config[stage]:
                specs = conf.pop("transforms", None)
                pipeline = []
                prime_stripped = False
                for spec in (specs or []):
                    t = _instantiate_transform(spec)
                    if isinstance(t, T.CompositeFlow):
                        self.composite_flow_settings = t.settings
                        prime_stripped = True
                        continue
                    if prime_stripped and isinstance(t, T.CenterCrop):
                        # reference order: crop AFTER the synthetic flow
                        # (uawarpc_stage1.yaml: CompositeFlow then
                        # CenterCrop 520 on the 750-dim batch) — the crop
                        # moves to the device alongside the flow
                        self.composite_flow_settings = dict(
                            self.composite_flow_settings or {},
                            crop_after_flow=tuple(t.size))
                        continue
                    if (getattr(t, "apply_keys", None) == ["image_prime"]
                            and isinstance(t, (T.ColorJitter,
                                               T.ChannelShuffle,
                                               T.RandomGaussianBlur))):
                        pp = self.prime_photometric_settings
                        if isinstance(t, T.ColorJitter):
                            pp["jitter"] = (t.brightness, t.contrast,
                                            t.saturation, t.hue)
                        elif isinstance(t, T.ChannelShuffle):
                            pp["channel_shuffle"] = True
                        else:
                            pp["blur"] = (t.p, t.kernel_size,
                                          t.sigma[0], t.sigma[1])
                        continue
                    if stage == "train" and isinstance(t, T.Normalize):
                        self.normalize_settings = {
                            "mean": tuple(float(v) for v in t.mean),
                            "std": tuple(float(v) for v in t.std)}
                        if self.device_normalize:
                            continue  # applied on device by the train step
                    if (stage == "train" and self.device_normalize
                            and isinstance(t, T.ConvertImageDtype)):
                        continue  # uint8 stays; device does x/255
                    pipeline.append(t)
                if prime_stripped and "load_keys" in conf:
                    conf["load_keys"] = [k for k in conf["load_keys"]
                                         if k != "image_prime"]
                conf["transforms"] = (T.Compose(pipeline) if pipeline
                                      else T.Compose([T.ToTensor()]))

        self.val_batch_size = max(
            1, self.batch_size // max(len(self.train_on), 1) // 2)
        self.test_batch_size = 1
        self.datasets: Dict[str, list] = {}

    # -- dataset / loader construction -------------------------------------

    def setup(self, stage: str):
        stages = {
            "fit": ["train", "val"], "validate": ["val"],
            "test": ["test"], "predict": ["predict"],
        }[stage]
        for st in stages:
            ds_list = []
            for name, conf in zip(self.stage_on[st], self.stage_config[st]):
                ds_list.append(DATASETS[name](
                    self.data_dirs[name], stage=st, debug=self.debug,
                    **conf))
            self.datasets[st] = ds_list

    def train_dataloaders(self, seed: int = 0):
        """``seed`` feeds the per-epoch shuffle RNG so `--seed` actually
        changes the data order (reference seed_everything semantics)."""
        per_ds_bs = self.batch_size // len(self.stage_on["train"])
        # decorrelate the per-dataset shuffle streams (reference loaders
        # draw from independent torch RNG states): with a shared seed, two
        # entries over the same file list would pair every image with
        # itself in the merged batch
        return [DataLoader(ds, per_ds_bs, shuffle=True, drop_last=True,
                           num_workers=self.num_workers,
                           seed=seed + 7919 * i)
                for i, ds in enumerate(self.datasets["train"])]

    def eval_dataloaders(self, stage: str):
        bs = self.val_batch_size if stage == "val" else self.test_batch_size
        return [DataLoader(ds, bs, shuffle=False, drop_last=False,
                           num_workers=self.num_workers)
                for ds in self.datasets[stage]]

    # -- batch merge (reference combined_data_module.py:263-310) ------------

    def merge_train_batch(self, sub_batches: List[Dict[str, Any]],
                          drop_half: bool = True) -> Dict[str, Any]:
        """``drop_half=False`` skips the random source-halving coin (used
        by the mesh-sizing probe, which needs the deterministic full
        geometry)."""
        out: Dict[str, Any] = {}
        src_x, src_y, trg, ref = [], [], [], []
        prime, prime_idx = [], []
        for sb in sub_batches:
            if "semantic" in sb:
                src_x.append(sb["image"])
                src_y.append(sb["semantic"])
            else:
                if "image" in sb:
                    trg.append(sb["image"])
                if "image_ref" in sb:
                    ref.append(sb["image_ref"])
                if "image_prime" in sb:
                    prime.append(sb["image_prime"])
                    prime_idx.append(sb.get("image_prime_idx"))
        if src_x:
            out["image_src"] = _cat(src_x)
            out["semantic_src"] = _cat(src_y)
        if trg:
            out["image_trg"] = _cat(trg)
        if ref:
            out["image_ref"] = _cat(ref)
        if prime:
            out["image_prime"] = _cat(prime)
            if prime_idx[0] is not None:
                out["prime_trg_idx"] = _cat(prime_idx).reshape(-1)
        if (self.ignore_every_second_semantic_training_batch
                and drop_half and "image_src" in out):
            # reference combined_data_module.py:301-303: the flag is only
            # valid when labels come from MORE than one loader (the
            # semi-supervised case); otherwise it would silently halve the
            # supervised batch
            assert (len(out["image_src"])
                    > self.batch_size // len(self.stage_on["train"])), \
                "can only ignore in semi-supervised case"
            if pyrandom.random() < 0.5:
                n = len(out["image_src"]) // 2
                out["image_src"] = out["image_src"][:n]
                out["semantic_src"] = out["semantic_src"][:n]
        return out
