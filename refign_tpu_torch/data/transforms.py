"""Host-side (CPU) sample transforms: PIL decode/resize + numpy tensor ops
(a copy of ``refign_tpu/data/transforms.py``, which the port may not
import: the JAX package's ``__init__`` loads JAX).

Same class names and init args as the reference's dict-transform library
(data_modules/transforms.py:120-570), so the YAML configs under
``configs/`` resolve by name, and the same draws from the process-wide
``random`` and ``np.random`` in the same order, so a batch seeded the same
way is bitwise the JAX package's.  Heavy randomised augmentation (DACS
jitter/blur, synthetic flows) runs on the card; ``CompositeFlow`` here is a
marker that the data module strips and forwards to the train step.

Samples are dicts keyed by 'image', 'image_ref', 'image_prime', 'semantic',
'corr_pts', 'corr_pts_ref', 'filename'.  PIL Images until ``ToTensor``;
after it, numpy arrays in HWC uint8 (images) / HW uint8 (semantic).
"""
from __future__ import annotations

import random as pyrandom
from typing import Sequence

import numpy as np
from PIL import Image, ImageFilter

IMNET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMNET_STD = np.array([0.229, 0.224, 0.225], np.float32)

PILLOW_INTERP = {
    "nearest": Image.NEAREST,
    "bilinear": Image.BILINEAR,
    "bicubic": Image.BICUBIC,
    "box": Image.BOX,
    "lanczos": Image.LANCZOS,
    "hamming": Image.HAMMING,
}

IMAGE_KEYS = ("image", "image_ref", "image_prime")
PASS_KEYS = ("filename", "image_prime_idx", "corr_pts", "corr_pts_ref")


def _size_of(sample, keys):
    for k in IMAGE_KEYS:
        if k in sample and (not keys or k in keys):
            v = sample[k]
            if isinstance(v, np.ndarray):
                return v.shape[1], v.shape[0]  # (w, h)
            return v.size  # PIL (w, h)
    raise ValueError("no image key in sample")


def imresize(img: Image.Image, size, interpolation="bilinear"):
    """Short-side or exact resize (reference transforms.py:57-74)."""
    if isinstance(size, Sequence) and len(size) == 1:
        size = size[0]
    if isinstance(size, int):
        w, h = img.size
        short, long = (w, h) if w <= h else (h, w)
        if short == size:
            return img
        new_short, new_long = size, int(size * long / short)
        new_w, new_h = ((new_short, new_long) if w <= h
                        else (new_long, new_short))
        return img.resize((new_w, new_h), PILLOW_INTERP[interpolation])
    new_h, new_w = size
    return img.resize((new_w, new_h), PILLOW_INTERP[interpolation])


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


class _KeyedTransform:
    def __init__(self, apply_keys="all"):
        self.apply_keys = apply_keys

    def keys(self, sample):
        if self.apply_keys == "all":
            return list(sample)
        if self.apply_keys == "none":
            return []
        return list(self.apply_keys)


class Resize(_KeyedTransform):
    """reference transforms.py:120-203."""

    def __init__(self, apply_keys="all", size=None,
                 img_interpolation="bilinear", img_only=False,
                 only_if_larger=False):
        super().__init__(apply_keys)
        self.size = size
        self.img_interpolation = img_interpolation
        self.img_only = img_only
        self.only_if_larger = only_if_larger

    def _scale_pts(self, pts, old_wh, size):
        w0, h0 = old_wh
        if isinstance(size, int):
            short, long = (w0, h0) if w0 <= h0 else (h0, w0)
            if short == size:
                return pts
            new_short, new_long = size, int(size * long / short)
            new_w, new_h = ((new_short, new_long) if w0 <= h0
                            else (new_long, new_short))
        else:
            new_h, new_w = size
        pts = pts.copy()
        pts[:, 0] *= new_w / float(w0)
        pts[:, 1] *= new_h / float(h0)
        return pts

    def __call__(self, sample):
        keys = self.keys(sample)
        pts_wh = (_size_of(sample, ["image"])
                  if "corr_pts" in keys and "image" in sample else None)
        pts_ref_wh = (_size_of(sample, ["image_ref"])
                      if "corr_pts_ref" in keys and "image_ref" in sample
                      else None)
        if self.only_if_larger:
            w, h = _size_of(sample, keys)
            ratio = min(self.size[0] / h, self.size[1] / w)
            if ratio >= 1:
                return sample
            size = (int(round(ratio * h)), int(round(ratio * w)))
        else:
            size = self.size
        for k in keys:
            if k in IMAGE_KEYS:
                sample[k] = imresize(sample[k], size,
                                     self.img_interpolation)
            elif k == "semantic":
                if not self.img_only:
                    sample[k] = imresize(sample[k], size, "nearest")
            elif k == "corr_pts" and not self.img_only:
                sample[k] = self._scale_pts(sample[k], pts_wh, size)
            elif k == "corr_pts_ref" and not self.img_only:
                sample[k] = self._scale_pts(sample[k], pts_ref_wh, size)
            elif k in PASS_KEYS:
                pass
            else:
                raise ValueError(k)
        return sample


class RandomRotation(_KeyedTransform):
    """reference transforms.py:206-247: rotate with expand=False; semantic
    fill 255; records a 'normalize_mask' of invalid (fill) regions."""

    def __init__(self, apply_keys="all", degrees=0.0, **kwargs):
        super().__init__(apply_keys)
        if isinstance(degrees, (int, float)):
            self.degrees = (-abs(float(degrees)), abs(float(degrees)))
        else:
            self.degrees = tuple(degrees)

    def __call__(self, sample):
        keys = self.keys(sample)
        angle = pyrandom.uniform(*self.degrees)
        for k in keys:
            v = sample[k]
            if k in IMAGE_KEYS:
                sample[k] = v.rotate(-angle, resample=Image.NEAREST,
                                     fillcolor=0)
            elif k == "semantic":
                sample[k] = v.rotate(-angle, resample=Image.NEAREST,
                                     fillcolor=255)
            elif k in PASS_KEYS:
                pass
            else:
                raise ValueError(k)
        w, h = _size_of(sample, keys)
        mask = Image.new("1", (w, h), 0).rotate(-angle, fillcolor=1)
        sample["normalize_mask"] = mask
        return sample


class ToTensor(_KeyedTransform):
    """PIL -> numpy (HWC uint8 images, HW uint8 semantic)."""

    def __call__(self, sample):
        for k in self.keys(sample):
            v = sample[k]
            if k in IMAGE_KEYS:
                sample[k] = np.asarray(v, np.uint8)
            elif k == "normalize_mask":
                sample[k] = np.asarray(v, bool)
            elif k == "semantic":
                sample[k] = np.asarray(v, np.uint8)
            elif k in PASS_KEYS:
                pass
            else:
                raise ValueError(k)
        return sample


class RandomCrop(_KeyedTransform):
    """reference transforms.py:282-360 incl. cat_max_ratio re-crop loop."""

    def __init__(self, apply_keys="all", size=None, ignore_index=255,
                 cat_max_ratio=1.0):
        super().__init__(apply_keys)
        self.size = size
        self.ignore_index = ignore_index
        self.cat_max_ratio = cat_max_ratio

    @staticmethod
    def get_params(img_size, output_size):
        h, w = img_size
        th, tw = output_size
        if w == tw and h == th:
            return 0, 0, h, w
        i = pyrandom.randint(0, max(h - th, 0))
        j = pyrandom.randint(0, max(w - tw, 0))
        return i, j, min(th, h), min(tw, w)

    def __call__(self, sample):
        keys = self.keys(sample)
        w, h = _size_of(sample, keys)
        params = self.get_params((h, w), self.size)
        if self.cat_max_ratio < 1.0:
            for _ in range(10):
                top, left, ch, cw = params
                seg = sample["semantic"][top:top + ch, left:left + cw]
                labels, cnt = np.unique(seg, return_counts=True)
                cnt = cnt[labels != self.ignore_index]
                if len(cnt) > 1 and cnt.max() / cnt.sum() < self.cat_max_ratio:
                    break
                params = self.get_params((h, w), self.size)
        top, left, ch, cw = params
        for k in keys:
            v = sample[k]
            if k in IMAGE_KEYS + ("semantic", "normalize_mask"):
                sample[k] = v[top:top + ch, left:left + cw]
            elif k == "corr_pts":
                p1 = sample["corr_pts_ref"].copy()
                p2 = sample["corr_pts"].copy()
                p1[:, 0] -= left
                p1[:, 1] -= top
                p2[:, 0] -= left
                p2[:, 1] -= top
                keep = ((np.round(p1[:, 0]) >= 0) & (np.round(p1[:, 0]) < cw)
                        & (np.round(p2[:, 0]) >= 0) & (np.round(p2[:, 0]) < cw)
                        & (np.round(p1[:, 1]) >= 0) & (np.round(p1[:, 1]) < ch)
                        & (np.round(p2[:, 1]) >= 0)
                        & (np.round(p2[:, 1]) < ch))
                sample["corr_pts_ref"] = p1[keep]
                sample["corr_pts"] = p2[keep]
            elif k in ("filename", "image_prime_idx", "corr_pts_ref"):
                pass
            else:
                raise ValueError(k)
        return sample


class RandomHorizontalFlip(_KeyedTransform):
    """reference transforms.py:363-390 (also flips correspondence x)."""

    def __init__(self, apply_keys="all", p=0.5):
        super().__init__(apply_keys)
        self.p = p

    def __call__(self, sample):
        keys = self.keys(sample)
        if pyrandom.random() < self.p:
            for k in keys:
                v = sample[k]
                if k in IMAGE_KEYS + ("semantic", "normalize_mask"):
                    sample[k] = v[:, ::-1].copy() if isinstance(
                        v, np.ndarray) else v.transpose(
                        Image.FLIP_LEFT_RIGHT)
                elif k in ("corr_pts", "corr_pts_ref"):
                    w, h = _size_of(sample, keys)
                    pts = v.copy()
                    pts[:, 0] = w - 1 - pts[:, 0]
                    sample[k] = pts
                elif k in ("filename", "image_prime_idx"):
                    pass
                else:
                    raise ValueError(k)
        return sample


def _np_jitter(img: np.ndarray, brightness, contrast, saturation, hue,
               order) -> np.ndarray:
    """torchvision-style jitter on float [0,1] HWC."""
    def gray(x):
        return (x @ np.array([0.299, 0.587, 0.114], np.float32))[..., None]

    for op in order:
        if op == 0 and brightness is not None:
            img = np.clip(img * brightness, 0, 1)
        elif op == 1 and contrast is not None:
            m = gray(img).mean()
            img = np.clip(img * contrast + m * (1 - contrast), 0, 1)
        elif op == 2 and saturation is not None:
            g = gray(img)
            img = np.clip(img * saturation + g * (1 - saturation), 0, 1)
        elif op == 3 and hue is not None:
            hsv = _rgb_to_hsv_np(img)
            hsv[..., 0] = (hsv[..., 0] + hue) % 1.0
            img = _hsv_to_rgb_np(hsv)
    return img


def _rgb_to_hsv_np(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0)
    sd = np.maximum(delta, 1e-12)
    rc, gc, bc = (maxc - r) / sd, (maxc - g) / sd, (maxc - b) / sd
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta == 0, 0.0, h)
    return np.stack([(h / 6.0) % 1.0, s, v], -1)


def _hsv_to_rgb_np(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = i.astype(int) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], -1)


class ColorJitter(_KeyedTransform):
    """torchvision ColorJitter semantics on uint8/float images
    (reference transforms.py:393-413)."""

    def __init__(self, apply_keys="all", brightness=0, contrast=0,
                 saturation=0, hue=0):
        super().__init__(apply_keys)
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def _factor(self, v):
        if not v:
            return None
        return pyrandom.uniform(max(0, 1 - v), 1 + v)

    def __call__(self, sample):
        for k in self.keys(sample):
            if k in IMAGE_KEYS:
                v = sample[k]
                was_uint8 = (isinstance(v, np.ndarray)
                             and v.dtype == np.uint8)
                img = np.asarray(v, np.float32)
                if was_uint8 or img.max() > 1.5:
                    img = img / 255.0
                    scale_back = True
                else:
                    scale_back = False
                order = list(range(4))
                pyrandom.shuffle(order)
                hue = (pyrandom.uniform(-self.hue, self.hue)
                       if self.hue else None)
                img = _np_jitter(img, self._factor(self.brightness),
                                 self._factor(self.contrast),
                                 self._factor(self.saturation), hue, order)
                if scale_back:
                    img = (img * 255.0).round().astype(np.uint8)
                sample[k] = img
            elif k in ("semantic", "normalize_mask") + PASS_KEYS:
                pass
            else:
                raise ValueError(k)
        return sample


class ChannelShuffle(_KeyedTransform):
    """reference transforms.py:416-435 (image_prime only)."""

    def __call__(self, sample):
        for k in self.keys(sample):
            if k == "image_prime":
                idx = list(range(3))
                pyrandom.shuffle(idx)
                v = sample[k]
                sample[k] = (v[..., idx] if isinstance(v, np.ndarray)
                             else Image.merge("RGB",
                                              [v.split()[i] for i in idx]))
            else:
                raise ValueError(k)
        return sample


class ConvertImageDtype(_KeyedTransform):
    """uint8 -> float32 (scaled); semantic -> int32
    (reference transforms.py:438-464)."""

    def __init__(self, apply_keys="all", scaling=True):
        super().__init__(apply_keys)
        self.scaling = scaling

    def __call__(self, sample):
        for k in self.keys(sample):
            v = sample[k]
            if k in IMAGE_KEYS:
                arr = np.asarray(v, np.float32)
                if self.scaling and (not isinstance(v, np.ndarray)
                                     or v.dtype == np.uint8):
                    arr = arr / 255.0
                sample[k] = arr
            elif k == "semantic":
                sample[k] = np.asarray(v, np.int32)
            elif k in PASS_KEYS + ("normalize_mask",):
                pass
            else:
                raise ValueError(k)
        return sample


class Normalize(_KeyedTransform):
    """ImageNet normalize; zeroes rotation fill via normalize_mask
    (reference transforms.py:467-495)."""

    def __init__(self, apply_keys="all", mean=None, std=None):
        super().__init__(apply_keys)
        self.mean = np.asarray(mean if mean is not None else IMNET_MEAN,
                               np.float32)
        self.std = np.asarray(std if std is not None else IMNET_STD,
                              np.float32)

    def __call__(self, sample):
        for k in self.keys(sample):
            if k in IMAGE_KEYS:
                v = (sample[k] - self.mean) / self.std
                if "normalize_mask" in sample:
                    v = np.where(np.asarray(sample["normalize_mask"],
                                            bool)[..., None], 0.0, v)
                sample[k] = v.astype(np.float32)
            elif k in ("semantic", "normalize_mask") + PASS_KEYS:
                pass
            else:
                raise ValueError(k)
        sample.pop("normalize_mask", None)
        return sample


class RandomGaussianBlur(_KeyedTransform):
    """reference transforms.py:498-519: blur with prob p, sigma U(range)."""

    def __init__(self, apply_keys="all", p=0.2, kernel_size=3,
                 sigma=(0.1, 2.0)):
        super().__init__(apply_keys)
        self.p = p
        self.kernel_size = kernel_size  # host path blurs via PIL radius;
        # kept for the device-side prime-aug settings (data/module.py)
        self.sigma = sigma if isinstance(sigma, (tuple, list)) else (
            sigma, sigma)

    def __call__(self, sample):
        for k in self.keys(sample):
            if k in IMAGE_KEYS:
                if pyrandom.random() < self.p:
                    sigma = pyrandom.uniform(*self.sigma)
                    v = sample[k]
                    if isinstance(v, np.ndarray):
                        pil = Image.fromarray(
                            v if v.dtype == np.uint8
                            else (v * 255).astype(np.uint8))
                        blurred = pil.filter(
                            ImageFilter.GaussianBlur(radius=sigma))
                        arr = np.asarray(blurred, np.uint8)
                        sample[k] = (arr if v.dtype == np.uint8
                                     else arr.astype(np.float32) / 255.0)
                    else:
                        sample[k] = v.filter(
                            ImageFilter.GaussianBlur(radius=sigma))
            elif k in ("semantic",) + PASS_KEYS:
                pass
            else:
                raise ValueError(k)
        return sample


class PadBottomRight(_KeyedTransform):
    """Zero-pad bottom/right to a target or matched size
    (reference transforms.py:522-570)."""

    def __init__(self, apply_keys="all", size=None, same_shape_keys=None,
                 ignore_index=255):
        super().__init__(apply_keys)
        self.size = size
        self.same_shape_keys = same_shape_keys
        self.ignore_index = ignore_index

    def _pad(self, arr, h, w, fill):
        ah, aw = arr.shape[:2]
        if ah == h and aw == w:
            return arr
        pad = [(0, h - ah), (0, w - aw)] + [(0, 0)] * (arr.ndim - 2)
        return np.pad(arr, pad, constant_values=fill)

    def __call__(self, sample):
        keys = self.keys(sample)
        if self.same_shape_keys is not None:
            w1, h1 = _size_of(sample, [self.same_shape_keys[0]])
            w2, h2 = _size_of(sample, [self.same_shape_keys[1]])
            h_f, w_f = max(h1, h2), max(w1, w2)
        else:
            h_f, w_f = self.size
        for k in keys:
            v = sample[k]
            if k in IMAGE_KEYS:
                sample[k] = self._pad(np.asarray(v), h_f, w_f, 0)
            elif k == "semantic":
                sample[k] = self._pad(np.asarray(v), h_f, w_f,
                                      self.ignore_index)
            elif k in PASS_KEYS:
                pass
            else:
                raise ValueError(k)
        return sample


class CenterCrop(_KeyedTransform):
    """Center crop adjusting correspondences
    (reference transforms.py:1398-1449)."""

    def __init__(self, apply_keys="all", size=None):
        super().__init__(apply_keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, sample):
        keys = self.keys(sample)
        w, h = _size_of(sample, keys)
        th, tw = self.size
        top = int(round((h - th) / 2.0))
        left = int(round((w - tw) / 2.0))
        for k in keys:
            v = sample[k]
            if k in IMAGE_KEYS + ("semantic",):
                if isinstance(v, np.ndarray):
                    sample[k] = v[top:top + th, left:left + tw]
                else:
                    sample[k] = v.crop((left, top, left + tw, top + th))
            elif k in ("corr_pts", "corr_pts_ref"):
                pts = v.copy()
                pts[:, 0] -= left
                pts[:, 1] -= top
                sample[k] = pts
            elif k in ("filename", "image_prime_idx"):
                pass
            else:
                raise ValueError(k)
        # drop out-of-crop correspondences, like RandomCrop
        if "corr_pts" in sample and "corr_pts_ref" in sample and (
                "corr_pts" in keys or "corr_pts_ref" in keys):
            p1, p2 = sample["corr_pts_ref"], sample["corr_pts"]
            keep = ((np.round(p1[:, 0]) >= 0) & (np.round(p1[:, 0]) < tw)
                    & (np.round(p2[:, 0]) >= 0) & (np.round(p2[:, 0]) < tw)
                    & (np.round(p1[:, 1]) >= 0) & (np.round(p1[:, 1]) < th)
                    & (np.round(p2[:, 1]) >= 0) & (np.round(p2[:, 1]) < th))
            sample["corr_pts_ref"] = p1[keep]
            sample["corr_pts"] = p2[keep]
        return sample


class CompositeFlow(_KeyedTransform):
    """Marker transform: synthetic prime-view generation runs on the card
    (``alignment/synthetic_flows.py``), not in the host pipeline.  The
    data module strips this from the pipeline and forwards its settings to
    the alignment trainer; as a host transform it only tags the sample so
    the collator knows a prime view is expected."""

    def __init__(self, apply_keys="all", **settings):
        super().__init__(apply_keys)
        self.settings = settings

    def __call__(self, sample):
        return sample
