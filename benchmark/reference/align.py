"""Plain UAWarpC training step, fp32, NCHW: the prime view (photometric
augmentation and a synthetic flow of the image it derives from), the
frozen VGG pyramids, the three head passes, the warp-supervision and
W-bipath probabilistic losses with the adaptive weights, one backward and
Adam.  Written from the Refign paper (Sec. 3.2), its supplement, and the
upstream brdav/refign ``models/alignment_model.py`` (``training_step``,
the adaptive weighting), ``models/losses`` (the multi-scale Huber NLL, the
W-bipath composition), ``data_modules/transforms.py`` (RandomHomography,
RandomTPS, RandomAffineTPS, torchvision's ColorJitter and GaussianBlur,
the centre crop after the flow), GLU-Net / DGC-Net's TPS, with torch's
Adam and ``F.grid_sample``.

Inputs as the port takes them: uint8 NHWC image pairs and the step's
draws (``benchmark/draws.py``).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .uawarpc import (VGG, UAWarpCHead, lands_inside, pixel_grid, pyramids,
                      scaled, up, warp)

MEAN = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
STD = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)


# ---------------------------------------------------------------------------
# the prime view
# ---------------------------------------------------------------------------

def grey(x):
    """torchvision's rgb_to_grayscale."""
    return (0.2989 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2])[:, None]


def torchvision_jitter(x, j, strengths):
    """torchvision ColorJitter with drawn factors, an op of strength 0
    left out (this step never shifts hue)."""
    def brightness(y):
        return (y * j.brightness).clamp(0, 1)

    def contrast(y):
        m = grey(y).mean()
        return (j.contrast * y + (1 - j.contrast) * m).clamp(0, 1)

    def saturation(y):
        return (j.saturation * y + (1 - j.saturation) * grey(y)).clamp(0, 1)

    ops = (brightness, contrast, saturation, None)
    for k in j.order:
        if strengths[k]:
            if ops[k] is None:
                raise ValueError("the benchmark's cells shift no hue")
            x = ops[k](x)
    return x


def torchvision_blur(x, sigma: float, k: int):
    t = torch.linspace(-(k // 2), k // 2, k, device=x.device)
    g = torch.exp(-0.5 * (t / sigma) ** 2)
    g = g / g.sum()
    w = (g[:, None] * g[None, :]).expand(x.shape[1], 1, k, k)
    return F.conv2d(F.pad(x, (k // 2,) * 4, mode="reflect"), w,
                    groups=x.shape[1])


def photometric(x, d, a: dict):
    """One normalised (1, 3, H, W) image: jitter, channel shuffle, blur in
    its [0, 1] space."""
    y = x * STD.to(x.device) + MEAN.to(x.device)
    if d.jitter is not None:
        y = torchvision_jitter(y, d.jitter, a["prime_jitter"])
    if d.perm is not None:
        y = y[:, list(d.perm)]
    if d.blur_sigma is not None:
        y = torchvision_blur(y, d.blur_sigma, int(a["prime_blur"][1]))
    return (y - MEAN.to(x.device)) / STD.to(x.device)


def inclusive_grid(H, W, device):
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, H, device=device),
                            torch.linspace(-1, 1, W, device=device),
                            indexing="ij")
    return xs, ys


def homography(theta, H, W, device):
    """The 4-point DLT of the corners (-1,-1), (-1,1), (1,-1), (1,1) moved
    to theta = (x'0..3, y'0..3), on the [-1, 1] grid."""
    x = np.array([-1., -1., 1., 1.])
    y = np.array([-1., 1., -1., 1.])
    xp, yp = np.array(theta[:4]), np.array(theta[4:])
    A = np.zeros((8, 8))
    rhs = np.zeros(8)
    for i in range(4):
        A[2 * i] = [x[i], y[i], 1, 0, 0, 0, -x[i] * xp[i], -y[i] * xp[i]]
        A[2 * i + 1] = [0, 0, 0, x[i], y[i], 1, -x[i] * yp[i],
                        -y[i] * yp[i]]
        rhs[2 * i], rhs[2 * i + 1] = xp[i], yp[i]
    h = np.append(np.linalg.solve(A, rhs), 1.0).tolist()
    gx, gy = inclusive_grid(H, W, device)
    k = h[6] * gx + h[7] * gy + h[8]
    return torch.stack([(h[0] * gx + h[1] * gy + h[2]) / k,
                        (h[3] * gx + h[4] * gy + h[5]) / k])


def _u(d2):
    d2 = torch.where(d2 == 0, torch.ones_like(d2), d2)
    return d2 * torch.log(d2)


def tps(theta, H, W, device):
    """Thin-plate spline through the 3 x 3 control grid moved to theta
    (x then y, x slowest), on the [-1, 1] grid."""
    axis = np.linspace(-1, 1, 3)
    px, py = np.repeat(axis, 3), np.tile(axis, 3)
    n = len(px)
    d2 = (px[:, None] - px[None]) ** 2 + (py[:, None] - py[None]) ** 2
    d2 = np.where(d2 == 0, 1.0, d2)
    P = np.stack([np.ones(n), px, py], 1)
    L = np.block([[d2 * np.log(d2), P], [P.T, np.zeros((3, 3))]])
    q = np.array(theta).reshape(2, n)
    coef = np.linalg.solve(L, np.concatenate([q, np.zeros((2, 3))], 1).T)
    coef = torch.tensor(coef, dtype=torch.float32, device=device)
    gx, gy = inclusive_grid(H, W, device)
    U = _u((gx[..., None] - torch.tensor(px, dtype=torch.float32,
                                         device=device)) ** 2
           + (gy[..., None] - torch.tensor(py, dtype=torch.float32,
                                           device=device)) ** 2)
    out = [coef[n, c] + coef[n + 1, c] * gx + coef[n + 2, c] * gy
           + (U * coef[:n, c]).sum(-1) for c in range(2)]
    return torch.stack(out)


def affine(params, H, W, device):
    """A = R(rot) R(sh)^T diag(l1, l2) R(sh) and (tx, ty), on the pixel
    centres of the [-1, 1] square."""
    rot, sh, l1, l2, tx, ty = params

    def R(a):
        return np.array([[math.cos(a), -math.sin(a)],
                         [math.sin(a), math.cos(a)]])
    A = (R(rot) @ R(sh).T @ np.diag([l1, l2]) @ R(sh)).tolist()
    xs = (torch.arange(W, device=device) * 2 + 1) / W - 1
    ys = (torch.arange(H, device=device) * 2 + 1) / H - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([A[0][0] * gx + A[0][1] * gy + tx,
                        A[1][0] * gx + A[1][1] * gy + ty])


def outside_to_sentinel(m, where):
    inside = (where.abs() < 1).all(0)
    return torch.where(inside, m, torch.full_like(m, -1e10))


def afftps(params, theta, H, W, device):
    """The affine mapping (-1e10 where it leaves the square) sampled at
    the TPS mapping's points, -1e10 where those leave it."""
    aff = outside_to_sentinel(affine(params, H, W, device),
                              affine(params, H, W, device))
    t = tps(theta, H, W, device)
    m = F.grid_sample(aff[None], t.permute(1, 2, 0)[None], mode="bilinear",
                      padding_mode="zeros", align_corners=True)[0]
    return outside_to_sentinel(m, t)


def synthetic_flow(f, H, W, device):
    """One draw's (2, H, W) pixel flow."""
    if f.kind == "hom":
        m = homography(f.theta, H, W, device)
    elif f.kind == "tps":
        m = tps(f.theta, H, W, device)
    elif f.kind == "afftps":
        m = afftps(f.affine, f.theta, H, W, device)
    else:
        raise ValueError(f"no {f.kind!r} flows in the benchmark")
    px = torch.stack([(m[0] + 1) * (W - 1) / 2, (m[1] + 1) * (H - 1) / 2])
    return px - pixel_grid(H, W, device)[0]


def prime_view(draws, ref, trg, a: dict, crop):
    """The prime image, its flow and its supervision mask, cut to the
    centre crop: the base image warped by its synthetic flow; the mask is
    where the warp sampled inside, or, where under a tenth of the whole
    flow lands inside the image, where it lands inside."""
    B, _, H, W = ref.shape
    top, left, th, tw = crop
    images, flows, masks = [], [], []
    for b in range(B):
        x = (trg if draws.prime_trg_idx[b] else ref)[b:b + 1]
        x = photometric(x, draws.photometric[b], a)
        flow = synthetic_flow(draws.flows[b], H, W, x.device)[None]
        warped, inside = warp(x, flow, with_mask=True)
        lands = lands_inside(flow)
        mask = lands if lands.sum() < 0.1 * H * W else inside
        sl = (slice(None), slice(None), slice(top, top + th),
              slice(left, left + tw))
        images.append(warped[sl])
        flows.append(flow[sl])
        masks.append(mask[:, top:top + th, left:left + tw])
    return torch.cat(images), torch.cat(flows), torch.cat(masks)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def shrink_mask(mask, size):
    if tuple(mask.shape[-2:]) == tuple(size):
        return mask
    return torch.floor(up(mask[:, None].float(), size)[:, 0]).bool()


def level_nll(flow, logvar, gt, mask):
    """Huber flow error (2 x smooth L1, summed over x and y) as a
    Gaussian negative log-likelihood of the log-variance, averaged over
    the mask (0 on an empty mask)."""
    size = flow.shape[-2:]
    err = 2 * F.smooth_l1_loss(flow, up(gt, size), reduction="none",
                               beta=1.0).sum(1)
    if logvar.shape[1] == 2:
        logvar = torch.logsumexp(logvar, 1)
    else:
        logvar = logvar[:, 0]
    nll = 0.5 * torch.exp(-logvar) * err + logvar + math.log(2 * math.pi)
    m = shrink_mask(mask, size).float()
    n = m.sum()
    return torch.where(n > 0, (nll * m).sum() / n.clamp_min(1),
                       torch.zeros_like(n))


def warp_supervision(levels, gt, mask):
    return sum(level_nll(f, u, gt, mask) for f, u in levels)


def wbipath(levels_a, levels_b, gt, mask):
    """W-bipath: the flow prime -> j composed with j -> i, warped by the
    former (detached), against the known flow prime -> i."""
    H, W = gt.shape[-2:]
    total = 0.0
    for (fa, ua), (fb, ub) in zip(levels_a, levels_b):
        h, w = fa.shape[-2:]
        wf = scaled(fa, w / W, h / H).detach()
        comp = fa + warp(fb, wf)
        unc = torch.cat([ua, warp(ub, wf)], 1)
        m = lands_inside(wf) & shrink_mask(mask, (h, w))
        total = total + level_nll(comp, unc, gt, m)
    return total


def adaptive_weights(ss, us):
    """The reference's adaptive weighting with its ratio 0: (0, 1) where
    the unsupervised loss is larger, else (1, 100)."""
    one = torch.ones_like(ss)
    bigger = us > ss
    return (torch.where(bigger, torch.zeros_like(ss), one),
            torch.where(bigger, one, torch.full_like(us, 100.0)))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

class AlignTrainer:
    def __init__(self, cfg: dict, vgg: str):
        self.cfg, self.a, self.o = cfg, cfg["align"], cfg["optimizer"]
        self.backbone = VGG(vgg, tuple(cfg["backbone"]["out_indices"]))
        self.backbone.eval().requires_grad_(False)
        self.head = UAWarpCHead().train()
        self.opt = torch.optim.Adam(self.head.parameters(), lr=self.o["lr"],
                                    betas=tuple(self.o["betas"]),
                                    eps=self.o["eps"],
                                    weight_decay=self.o["weight_decay"])
        self.step_count = 0

    def step(self, batch: dict, d) -> Dict[str, torch.Tensor]:
        a = self.a

        def norm(x):
            x = x.permute(0, 3, 1, 2).float() / 255
            return (x - MEAN.to(x.device)) / STD.to(x.device)
        ref, trg = norm(batch["image_ref"]), norm(batch["image_trg"])
        H, W = ref.shape[-2:]
        th, tw = a["crop_after_flow"]
        top, left = int(round((H - th) / 2)), int(round((W - tw) / 2))
        with torch.no_grad():
            prime, flow, mask = prime_view(d, ref, trg, a,
                                           (top, left, th, tw))
            ref = ref[..., top:top + th, left:left + tw]
            trg = trg[..., top:top + th, left:left + tw]
            (p_ref, p_trg, p_prime), (q_ref, q_trg, q_prime) = pyramids(
                self.backbone, [ref, trg, prime])
        idx = torch.tensor(d.prime_trg_idx, device=ref.device).view(-1, 1,
                                                                     1, 1)

        def pick(a_, b_, which):
            return [torch.where(which.bool(), y, x) for x, y in zip(a_, b_)]
        p_i, q_i = pick(p_ref, p_trg, idx), pick(q_ref, q_trg, idx)
        p_j, q_j = pick(p_ref, p_trg, 1 - idx), pick(q_ref, q_trg, 1 - idx)
        p_prime, q_prime = list(p_prime), list(q_prime)
        size = (th, tw)
        prime_i = self.head(p_prime, p_i, q_prime, q_i, size)
        prime_j = self.head(p_prime, p_j, q_prime, q_j, size)
        j_i = self.head(p_j, p_i, q_j, q_i, size)
        ss = warp_supervision(prime_i, flow, mask)
        us = wbipath(prime_j, j_i, flow, mask)
        w_ss, w_us = adaptive_weights(ss.detach(), us.detach())
        loss = w_ss * ss + w_us * us
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        n = sum(self.step_count >= m for m in self.o["milestones"])
        for g in self.opt.param_groups:
            g["lr"] = self.o["lr"] * self.o["gamma"] ** n
        self.opt.step()
        self.step_count += 1
        return {"train_matching_loss": loss.detach(), "loss_ss": ss.detach(),
                "loss_us": us.detach()}
