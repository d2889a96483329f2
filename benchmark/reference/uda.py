"""Plain Refign-HRDA★ UDA training step, fp32, NCHW: the EMA teacher's
pseudo-labels with Refign's align and refine, DACS ClassMix with its
strong augmentation, both HRDA student passes, the ImageNet feature
distance, a backward of each student pass and AdamW.  Written from the papers (DACS,
DAFormer, HRDA, Refign) and the upstream steps (lhoyer/DAFormer
``mmseg/models/uda/dacs.py`` and ``mmseg/models/utils/dacs_transforms.py``,
brdav/refign ``models/segmentation_model.py``: ``training_step``,
``refine``, ``align``, ``get_dacs_mix``, ``calc_feat_dist``,
``downscale_label_ratio``, ``update_momentum_encoder``), with torch's
own cross entropy, AdamW and kornia-0.5.8 colour jitter written out.

Inputs as the port takes them: NHWC images (normalised) and (B, H, W)
labels, and the step's draws (``benchmark/draws.py``).
"""
from __future__ import annotations

import copy
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .segformer import Segmentor, up
from .uawarpc import AlignmentNet, flow_and_logvar, warp

MEAN = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
STD = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
# Cityscapes' large static classes, kept by Refign's refinement mask M
STATIC = (0, 1, 2, 3, 4, 8, 9, 10)
IGNORE = 255


def denorm(x):
    return x * STD.to(x.device) + MEAN.to(x.device)


def renorm(x):
    return (x - MEAN.to(x.device)) / STD.to(x.device)


# ---------------------------------------------------------------------------
# DACS
# ---------------------------------------------------------------------------

def rgb_to_hsv(x):
    r, g, b = x.unbind(1)
    mx, _ = x.max(1)
    mn, _ = x.min(1)
    d = mx - mn
    dd = torch.where(d > 0, d, torch.ones_like(d))
    h = torch.where(mx == r, (g - b) / dd,
                    torch.where(mx == g, 2 + (b - r) / dd, 4 + (r - g) / dd))
    h = torch.where(d > 0, h, torch.zeros_like(h))
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    return torch.remainder(h / 6, 1.0), s, mx


def hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6)
    f = h * 6 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = torch.remainder(i, 6)
    sector = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
              (v, p, q)]
    out = torch.zeros((3,) + tuple(h.shape), dtype=h.dtype, device=h.device)
    for k, rgb in enumerate(sector):
        out = torch.where(i == k, torch.stack(rgb), out)
    return out.movedim(0, 1)


def kornia_jitter(x: torch.Tensor, j) -> torch.Tensor:
    """kornia 0.5.8 ColorJitter of one (1, 3, H, W) image in [0, 1]:
    additive brightness, multiplicative contrast, HSV saturation scaling,
    hue as a share of the circle, in the drawn order."""
    def brightness(y):
        return (y + (j.brightness - 1)).clamp(0, 1)

    def contrast(y):
        return (y * j.contrast).clamp(0, 1)

    def saturation(y):
        h, s, v = rgb_to_hsv(y.clamp(0, 1))
        return hsv_to_rgb(h, s * j.saturation, v)

    def hue(y):
        h, s, v = rgb_to_hsv(y.clamp(0, 1))
        return hsv_to_rgb(torch.remainder(h + j.hue, 1.0), s, v)

    ops = (brightness, contrast, saturation, hue)
    for k in j.order:
        x = ops[k](x)
    return x


def gaussian_blur(x: torch.Tensor, sigma: float, ky: int, kx: int):
    """kornia's GaussianBlur2d: a normalised Gaussian of odd size, reflect
    padding; the 2-D kernel is separable, so two 1-D passes."""
    C = x.shape[1]
    for k, vertical in ((ky, True), (kx, False)):
        t = torch.arange(k, dtype=torch.float32, device=x.device) - k // 2
        g = torch.exp(-t * t / (2 * sigma * sigma))
        g = (g / g.sum()).repeat(C, 1, 1, 1)
        if vertical:
            x = F.conv2d(F.pad(x, (0, 0, k // 2, k // 2), mode="reflect"),
                         g.view(C, 1, k, 1), groups=C)
        else:
            x = F.conv2d(F.pad(x, (k // 2, k // 2, 0, 0), mode="reflect"),
                         g.view(C, 1, 1, k), groups=C)
    return x


def blur_size(n: int) -> int:
    c = math.ceil(0.1 * n)
    return int(math.floor(c - 0.5 + c % 2))


def class_masks(scores: torch.Tensor, gt: torch.Tensor, C: int):
    """ClassMix: the classes present in the whole source batch (the ignore
    label counted as one); each image takes the ceil(n/2) of them its
    scores rank highest, and its mask is where its labels are those."""
    lab = torch.where(gt == IGNORE, torch.full_like(gt, C), gt)
    present = torch.unique(lab)
    k = (len(present) + 1) // 2
    out = []
    for b in range(gt.shape[0]):
        top = scores[b].to(gt.device)[present].topk(k).indices
        out.append(torch.isin(lab[b], present[top]))
    return torch.stack(out).float()


def dacs(d, img_trg, probs, img_src, gt_src, cfg: dict):
    """(mixed images, mixed labels, mixed pixel weights)."""
    B = img_trg.shape[0]
    conf, pseudo = probs.max(1)
    weight = (conf >= cfg["pseudo_label_threshold"]).float().mean()
    mask = class_masks(d.class_scores, gt_src[:B], cfg["num_classes"])
    m = mask[:, None]
    mixed = m * img_src[:B] + (1 - m) * img_trg
    labels = torch.where(mask > 0, gt_src[:B], pseudo)
    weights = mask + (1 - mask) * weight
    out = []
    for b in range(B):
        x = mixed[b:b + 1]
        if d.jitter_coin > cfg["color_jitter_p"]:
            x = renorm(kornia_jitter(denorm(x), d.jitter[b]))
        if cfg["blur"] and d.blur_coin > 0.5:
            x = gaussian_blur(x, d.sigma[b], blur_size(x.shape[2]),
                              blur_size(x.shape[3]))
        out.append(x)
    return torch.cat(out), labels, weights


# ---------------------------------------------------------------------------
# Refign
# ---------------------------------------------------------------------------

def refine(logits_trg, logits_ref, valid, cert, gamma: float):
    """Adaptive label refinement: the target's probabilities moved toward
    the warped reference's by eps = s * max(P, M), s the image's mean
    normalised entropy ** gamma, P the match confidence, M the static
    classes both agree are present; nothing where the warp left the
    image."""
    C = logits_trg.shape[1]
    p_trg = logits_trg.softmax(1)
    p_ref = logits_ref.softmax(1)
    ent = -(p_trg * logits_trg.log_softmax(1)).sum(1) / math.log(C)
    s = ent.mean((1, 2)).pow(gamma).view(-1, 1, 1, 1)
    static = torch.zeros(C, dtype=torch.bool, device=p_trg.device)
    static[list(STATIC)] = True
    both = static[p_trg.argmax(1)] & static[p_ref.argmax(1)]
    M = (both[:, None] & static.view(1, C, 1, 1)).float()
    eps = s * torch.maximum(cert, M) * valid[:, None].float()
    return (1 - eps) * p_trg + eps * p_ref


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def ce(logits, labels, weight=None):
    """Cross entropy per pixel (0 where ignored), weighted, averaged over
    every pixel."""
    loss = F.cross_entropy(logits, labels.long(), ignore_index=IGNORE,
                           reduction="none")
    if weight is not None:
        loss = loss * weight
    return loss.mean()


def hrda_loss(fused, hr, labels, weight, crop, hr_weight):
    H, W = labels.shape[-2:]
    oy, ox = crop
    sl = (slice(None), slice(oy, oy + H // 2), slice(ox, ox + W // 2))
    return ((1 - hr_weight) * ce(up(fused, (H, W)), labels, weight)
            + hr_weight * ce(hr, labels[sl],
                             None if weight is None else weight[sl]))


def feat_dist(feat, feat_imnet, gt, cfg: dict):
    """The ImageNet feature distance on thing-class cells: the label map
    pooled to the feature grid (a cell keeps its majority class where it
    holds at least ``fdist_scale_min_ratio``), the L2 distance of the
    features averaged over the cells of those classes."""
    C = cfg["num_classes"]
    scale = gt.shape[-1] // feat.shape[-1]
    lab = torch.where(gt == IGNORE, torch.full_like(gt, C), gt).long()
    pooled = F.avg_pool2d(F.one_hot(lab, C + 1).permute(0, 3, 1, 2).float(),
                          scale)
    ratio, cls = pooled.max(1)
    keep = (ratio >= cfg["fdist_scale_min_ratio"]) & (cls < C)
    mask = keep & torch.isin(cls, torch.tensor(cfg["fdist_classes"],
                                               device=gt.device))
    dist = torch.linalg.vector_norm(feat - feat_imnet, dim=1)
    n = mask.sum()
    mean = (dist * mask).sum() / n.clamp_min(1)
    return cfg["fdist_lambda"] * mean


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def warmup_poly(step: int, base: float, o: dict) -> float:
    """Linear warmup from base * 1e-6 over ``warmup_iters``, then
    polynomial decay to 0 at ``max_steps``."""
    w = o["warmup_iters"]
    if step < w:
        return base * (1 - (1 - step / w) * (1 - 1e-6))
    return base * (1 - (step - w) / (o["max_steps"] - w)) ** o["power"]


class UDATrainer:
    def __init__(self, cfg: dict, student: Segmentor, align: AlignmentNet):
        self.cfg, self.uda, self.o = cfg, cfg["uda"], cfg["optimizer"]
        self.student = student.train()
        self.teacher = copy.deepcopy(student).requires_grad_(False)
        for m in self.teacher.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.momentum = 0.0       # batch statistics, no update
        self.imnet = copy.deepcopy(student.backbone).requires_grad_(False)
        self.imnet.eval()
        self.align = align.eval().requires_grad_(False)
        groups: Dict[str, list] = {}
        for n, p in student.named_parameters():
            kind = "backbone" if n.startswith("backbone.") else "head"
            groups.setdefault((kind, p.dim() <= 1), []).append(p)
        self.opt = torch.optim.AdamW(
            [dict(params=ps, base=self.o["lr"] * (
                self.o["backbone_lr_factor"] if kind == "backbone" else 1.0),
                weight_decay=0.0 if flat else self.o["weight_decay"])
             for (kind, flat), ps in groups.items()],
            lr=self.o["lr"], betas=tuple(self.o["betas"]), eps=self.o["eps"])
        self.step_count = 0

    @torch.no_grad()
    def ema(self) -> None:
        a = min(1 - 1 / (self.step_count + 1), self.uda["ema_momentum"])
        for t, s in zip(self.teacher.parameters(),
                        self.student.parameters()):
            t.mul_(a).add_(s, alpha=1 - a)

    @torch.no_grad()
    def pseudo(self, trg, ref, use_ref: bool):
        """The teacher's probabilities and the images they label."""
        if use_ref:
            return self.teacher.whole(ref).softmax(1), ref
        B = trg.shape[0]
        logits = self.teacher.whole(torch.cat([trg, ref]))
        flow, logvar = flow_and_logvar(self.align, trg, ref)
        cert = 1 - torch.exp(-1 / (2 * torch.exp(logvar)))
        warped, valid = warp(logits[B:], flow, with_mask=True)
        return refine(logits[:B], warped, valid, cert,
                      self.uda["gamma"]), trg

    def step(self, batch: dict, d) -> Dict[str, torch.Tensor]:
        u = self.uda
        src, trg, ref = (batch[k].permute(0, 3, 1, 2).float()
                         for k in ("image_src", "image_trg", "image_ref"))
        gt = batch["semantic_src"]
        self.ema()
        probs, images = self.pseudo(trg, ref, d.use_ref_as_target)
        with torch.no_grad():
            mixed, labels, weights = dacs(d.dacs, images, probs, src, gt, u)
        # the source pass and its backward, then the mixed pass and its
        # own, as the upstream step does: the gradients add up to the
        # summed loss's
        self.opt.zero_grad(set_to_none=True)
        gen = torch.Generator(device=src.device).manual_seed(d.dropout_seed)
        hw = u["hr_loss_weight"]
        fused, hr, feats = self.student.hrda_train(src, d.crop_src, gen)
        loss_src = hrda_loss(fused, hr, gt, None, d.crop_src, hw)
        with torch.no_grad():
            f_imnet = self.imnet(up(src, (src.shape[2] // 2,
                                          src.shape[3] // 2)))[-1]
        loss_fd = feat_dist(feats[-1], f_imnet, gt, u)
        (loss_src + loss_fd).backward()
        del fused, hr, feats
        fused, hr, _ = self.student.hrda_train(mixed, d.crop_mix, gen)
        loss_mix = hrda_loss(fused, hr, labels, weights, d.crop_mix, hw)
        loss_mix.backward()
        total = loss_src.detach() + loss_fd.detach() + loss_mix.detach()
        for g in self.opt.param_groups:
            g["lr"] = warmup_poly(self.step_count, g["base"], self.o)
        self.opt.step()
        self.step_count += 1
        return {"train_loss_total": total,
                "train_loss_src": loss_src.detach(),
                "train_loss_featdist_src": loss_fd.detach(),
                "train_loss_uda_trg": loss_mix.detach(),
                "train_pseudo_weight": weights.mean()}

