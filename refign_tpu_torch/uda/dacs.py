"""DACS ClassMix and its strong augmentation on NHWC tensors (counterpart
of ``refign_tpu/uda/dacs.py``).

Every random draw of a step is made first, on the host, by
:func:`draw_dacs` from an explicit ``torch.Generator``; the functions that
compute take the drawn numbers as arguments.  So a test can hand the port
and the JAX package the same numbers, which their generators cannot give.

Semantics kept from the JAX package:

* the ClassMix candidate set is the classes present in the WHOLE source
  batch (the reference's batch-level ``unique``; a maximum over the ranks
  under a process group); each image selects the ceil(n/2) present
  classes with the highest of its uniform scores;
* the pseudo-label weight is the share of confident pixels in the whole
  target batch (a mean over the ranks under a process group);
* colour jitter with kornia 0.5.8 semantics (additive brightness, pure
  contrast scaling, HSV-S saturation scaling, hue as a fraction of the
  circle), the four ops in a per-image random order, applied to the
  denormalised mixed images when the step's jitter coin exceeds ``p``;
* Gaussian blur with sigma ~ U(0.15, 1.15) per image, an odd kernel of
  about a tenth of each side and reflect padding, when the step's blur
  coin exceeds 0.5.

The alignment step's prime view takes the torchvision-semantics jitter
:func:`color_jitter_bcsh` (multiplicative brightness, contrast and
saturation blended with the grey image, hue; the four in a random order,
an op whose strength is 0 left out), drawn by :func:`draw_jitter_bcsh`,
and the blur with an explicit ``kernel_size``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import mesh

__all__ = ["DACSDraws", "JitterFactors", "draw_dacs", "draw_jitter",
           "draw_jitter_bcsh", "color_jitter_bcsh",
           "get_class_masks", "one_mix", "color_jitter_image",
           "gaussian_blur_image", "gauss_kernel_size", "dacs_mix", "denorm",
           "renorm"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _const(values, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=x.device)


def denorm(img: torch.Tensor, mean=IMAGENET_MEAN,
           std=IMAGENET_STD) -> torch.Tensor:
    return img * _const(std, img) + _const(mean, img)


def renorm(img: torch.Tensor, mean=IMAGENET_MEAN,
           std=IMAGENET_STD) -> torch.Tensor:
    return (img - _const(mean, img)) / _const(std, img)


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JitterFactors:
    """One image's kornia-0.5.8 jitter: brightness, contrast, saturation
    and hue factors and the order of the four ops (0..3 in that list)."""
    brightness: float
    contrast: float
    saturation: float
    hue: float
    order: Tuple[int, int, int, int]


@dataclasses.dataclass
class DACSDraws:
    """Every random number of one ``dacs_mix``."""
    jitter_coin: float
    blur_coin: float
    class_scores: torch.Tensor        # (B, num_classes + 1) uniform [0, 1)
    jitter: List[JitterFactors]       # per image
    sigma: List[float]                # per image blur sigma

    def rows(self, sl: Optional[slice]) -> "DACSDraws":
        """The draws of the images ``sl`` of the batch (all for None)."""
        if sl is None:
            return self
        return dataclasses.replace(self, class_scores=self.class_scores[sl],
                                   jitter=self.jitter[sl],
                                   sigma=self.sigma[sl])


def _uniform(generator: torch.Generator, lo: float, hi: float) -> float:
    return lo + (hi - lo) * float(torch.rand((), generator=generator))


def draw_jitter(generator: torch.Generator, s: float) -> JitterFactors:
    """Factors of ``color_jitter_image`` with strength ``s``."""
    fb = _uniform(generator, max(0.0, 1 - s), min(2.0, 1 + s))
    fc = _uniform(generator, max(0.0, 1 - s), 1 + s)
    fs = _uniform(generator, max(0.0, 1 - s), 1 + s)
    fh = _uniform(generator, -s, s)
    order = tuple(int(i) for i in torch.randperm(4, generator=generator))
    return JitterFactors(fb, fc, fs, fh, order)


def draw_dacs(generator: torch.Generator, batch: int, num_classes: int = 19,
              color_jitter_s: float = 0.2, blur: bool = True) -> DACSDraws:
    """All draws of one ``dacs_mix`` of ``batch`` images, on the host."""
    jitter_coin = float(torch.rand((), generator=generator))
    blur_coin = float(torch.rand((), generator=generator)) if blur else 0.0
    scores = torch.rand((batch, num_classes + 1), generator=generator)
    jitter = [draw_jitter(generator, color_jitter_s) for _ in range(batch)]
    sigma = [_uniform(generator, 0.15, 1.15) for _ in range(batch)]
    return DACSDraws(jitter_coin, blur_coin, scores, jitter, sigma)


# ---------------------------------------------------------------------------
# ClassMix masks
# ---------------------------------------------------------------------------

def get_class_masks(scores: torch.Tensor, labels: torch.Tensor,
                    num_classes: int = 19,
                    ignore_index: int = 255) -> torch.Tensor:
    """Per-image ClassMix masks (B, H, W) float 0/1 from the source labels
    (B, H, W) and per-image class scores (B, num_classes + 1), the last
    slot for the ignore label: image b selects the ceil(n/2) classes
    present in the batch (over every rank's labels) with the highest
    scores."""
    B = labels.shape[0]
    C1 = num_classes + 1
    lab = torch.where(labels == ignore_index, num_classes, labels).long()
    present = torch.zeros(C1, dtype=torch.bool, device=labels.device)
    present[lab.reshape(-1)] = True
    present = mesh.all_reduce_max(present)
    n = present.sum()
    k = (n + n % 2) // 2
    s = torch.where(present, scores.to(labels.device, torch.float32),
                    -math.inf)
    order = torch.argsort(-s, dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(C1, device=labels.device)
                  .expand(B, C1).contiguous())
    selected = (rank < k) & present
    return torch.gather(selected, 1, lab.reshape(B, -1)).reshape(
        lab.shape).float()


def one_mix(mask: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """mask*a + (1-mask)*b with mask broadcast over trailing dims."""
    while mask.dim() < a.dim():
        mask = mask[..., None]
    return mask * a + (1.0 - mask) * b


# ---------------------------------------------------------------------------
# colour jitter (kornia 0.5.8 semantics) on one denormalised (H, W, 3) image
# ---------------------------------------------------------------------------

def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12), 0.0)
    safe = delta.clamp_min(1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, 0.0, h)
    h = torch.remainder(h / 6.0, 1.0)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    idx = torch.remainder(i.long(), 6)[..., None]

    def pick(*cands):
        return torch.gather(torch.stack(cands, dim=-1), -1, idx)[..., 0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def _adjust_hue(img: torch.Tensor, f: float) -> torch.Tensor:
    hsv = _rgb_to_hsv(img.clamp(0.0, 1.0))
    h = torch.remainder(hsv[..., 0] + f, 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def color_jitter_image(img: torch.Tensor,
                       factors: JitterFactors) -> torch.Tensor:
    """Jitter one denormalised (H, W, 3) image in [0, 1] with kornia 0.5.8
    semantics: brightness clamp(x + (fb - 1)), contrast clamp(x * fc),
    saturation scales HSV-S (no clamp), hue shifts H by fh of the circle;
    the four in ``factors.order``."""
    def brightness(x):
        return (x + (factors.brightness - 1.0)).clamp(0.0, 1.0)

    def contrast(x):
        return (x * factors.contrast).clamp(0.0, 1.0)

    def saturation(x):
        hsv = _rgb_to_hsv(x.clamp(0.0, 1.0))
        return _hsv_to_rgb(torch.stack(
            [hsv[..., 0], hsv[..., 1] * factors.saturation, hsv[..., 2]],
            dim=-1))

    def hue(x):
        return _adjust_hue(x, factors.hue)

    ops = (brightness, contrast, saturation, hue)
    for i in factors.order:
        img = ops[i](img)
    return img


# ---------------------------------------------------------------------------
# colour jitter (torchvision semantics) on one denormalised (H, W, 3) image
# ---------------------------------------------------------------------------

def draw_jitter_bcsh(generator: torch.Generator, b: float, c: float,
                     s: float, h: float) -> JitterFactors:
    """Factors of torchvision's ColorJitter(b, c, s, h): U(max(0, 1-v),
    1+v) for the first three, U(-h, h) for hue, and a random order."""
    fb = _uniform(generator, max(0.0, 1 - b), 1 + b)
    fc = _uniform(generator, max(0.0, 1 - c), 1 + c)
    fs = _uniform(generator, max(0.0, 1 - s), 1 + s)
    fh = _uniform(generator, -h, h)
    order = tuple(int(i) for i in torch.randperm(4, generator=generator))
    return JitterFactors(fb, fc, fs, fh, order)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype,
                     device=img.device)
    return (img * w).sum(-1, keepdim=True)


def color_jitter_bcsh(img: torch.Tensor, factors: JitterFactors, b: float,
                      c: float, s: float, h: float) -> torch.Tensor:
    """torchvision ColorJitter(b, c, s, h) on one denormalised (H, W, 3)
    image in [0, 1] with drawn ``factors``: brightness clamp(x * fb),
    contrast clamp(x * fc + mean(grey) * (1 - fc)), saturation
    clamp(x * fs + grey * (1 - fs)), hue a shift of fh of the circle; in
    ``factors.order``, an op with strength 0 left out."""
    def brightness(x):
        return (x * factors.brightness).clamp(0.0, 1.0)

    def contrast(x):
        mean = _grayscale(x).mean()
        return (x * factors.contrast + mean * (1.0 - factors.contrast)
                ).clamp(0.0, 1.0)

    def saturation(x):
        return (x * factors.saturation
                + _grayscale(x) * (1.0 - factors.saturation)).clamp(0.0, 1.0)

    def hue(x):
        return _adjust_hue(x, factors.hue)

    ops = [(brightness, b), (contrast, c), (saturation, s), (hue, h)]
    for i in factors.order:
        op, strength = ops[i]
        if strength:
            img = op(img)
    return img


# ---------------------------------------------------------------------------
# Gaussian blur (kornia GaussianBlur2d semantics: reflect pad, odd kernel)
# ---------------------------------------------------------------------------

def gauss_kernel_size(dim: int) -> int:
    """The reference DACS rule: an odd size of about a tenth of ``dim``."""
    return int(math.floor(math.ceil(0.1 * dim) - 0.5
                          + math.ceil(0.1 * dim) % 2))


def gaussian_blur_image(img: torch.Tensor, sigma: float,
                        kernel_size: Optional[int] = None) -> torch.Tensor:
    """Separable Gaussian blur of one (H, W, C) image, reflect padding, in
    fp32; the kernel sizes follow :func:`gauss_kernel_size` unless
    ``kernel_size`` is given."""
    H, W, C = img.shape
    x = img.float().permute(2, 0, 1)[None]          # (1, C, H, W)
    sizes = (gauss_kernel_size(H) if kernel_size is None else kernel_size,
             gauss_kernel_size(W) if kernel_size is None else kernel_size)
    for axis, k in enumerate(sizes):
        if k < 1:
            continue
        half = (k - 1) // 2
        t = torch.arange(k, dtype=torch.float32, device=img.device) \
            - (k - 1) / 2.0
        kern = torch.exp(-0.5 * torch.square(t / max(float(sigma), 1e-6)))
        kern = kern / kern.sum()
        if axis == 0:
            pad, shape = (0, 0, half, k - 1 - half), (C, 1, k, 1)
        else:
            pad, shape = (half, k - 1 - half, 0, 0), (C, 1, 1, k)
        x = F.conv2d(F.pad(x, pad, mode="reflect"),
                     kern.reshape(1, 1, *shape[2:]).expand(shape), groups=C)
    return x[0].permute(1, 2, 0)


# ---------------------------------------------------------------------------
# the whole mix (reference get_dacs_mix)
# ---------------------------------------------------------------------------

def dacs_mix(draws: DACSDraws, images_trg: torch.Tensor,
             probs_trg: torch.Tensor, images_src: torch.Tensor,
             gt_src: torch.Tensor, pseudo_label_threshold: float = 0.968,
             color_jitter_p: float = 0.2, blur: bool = True,
             psweight_ignore_top: int = 0, psweight_ignore_bottom: int = 0,
             num_classes: int = 19
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mixed images, mixed labels, mixed pixel weights).

    images_*: (B, H, W, 3) normalised fp32; probs_trg: (B, H, W, C) teacher
    probabilities; gt_src: (B, H, W) integer labels."""
    B = images_trg.shape[0]
    images_src, gt_src = images_src[:B], gt_src[:B]
    pseudo_prob = probs_trg.amax(dim=-1)
    pseudo_label = probs_trg.argmax(dim=-1).to(gt_src.dtype)
    frac_confident = mesh.mean_over_ranks(
        (pseudo_prob >= pseudo_label_threshold).float().mean())
    pseudo_weight = torch.ones(pseudo_prob.shape, device=probs_trg.device) \
        * frac_confident
    if psweight_ignore_top > 0:
        pseudo_weight[:, :psweight_ignore_top, :] = 0.0
    if psweight_ignore_bottom > 0:
        pseudo_weight[:, -psweight_ignore_bottom:, :] = 0.0

    masks = get_class_masks(draws.class_scores[:B], gt_src, num_classes)
    mixed_img = one_mix(masks, images_src, images_trg)
    mixed_lbl = torch.where(masks > 0, gt_src, pseudo_label)
    mixed_weight = one_mix(masks, torch.ones_like(pseudo_weight),
                           pseudo_weight)

    do_jitter = draws.jitter_coin > color_jitter_p
    do_blur = blur and draws.blur_coin > 0.5
    out = []
    for b in range(B):
        d = denorm(mixed_img[b])
        if do_jitter:
            d = color_jitter_image(d, draws.jitter[b])
        if do_blur:
            d = gaussian_blur_image(d, draws.sigma[b])
        out.append(renorm(d))
    return torch.stack(out), mixed_lbl, mixed_weight

