"""Plain UAWarpC alignment network, NCHW: the VGG feature pyramid and the
uncertainty-aware coarse-to-fine matching head, written from the Refign
paper (Bruggemann et al., WACV 2023, Sec. 3.2 and its supplement), the
upstream brdav/refign ``models/heads/uawarpc.py``,
``models/matching_modules.py`` and ``models/backbones/vgg.py``, and
PDC-Net's (Truong et al., CVPR 2021) matching blocks, with torch.nn
layers and ``F.grid_sample`` for every warp.  Parameter names are those of
the upstream torch state dicts as the port keeps them.

Flows are (B, 2, h, w) pixel displacements in (x, y) order; the head
returns, coarse to fine, (flow, log-variance) of four levels, every flow
in pixels of the image.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .kernels import global_correlation, local_correlation

PATCH = 9
GRID4 = 16          # level-4 grid: 16 x 16 at 256^2
FEAT = 32

VGG_CFG = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
              "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"],
}


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def pixel_grid(h: int, w: int, device) -> torch.Tensor:
    """(1, 2, h, w): each pixel's (x, y)."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return torch.stack([xs, ys])[None]


def warp(x: torch.Tensor, flow: torch.Tensor, with_mask: bool = False):
    """Sample x at each pixel plus its flow (bilinear, corners aligned,
    zeros outside); the mask: the sample point strictly inside."""
    h, w = flow.shape[-2:]
    H, W = x.shape[-2:]
    p = pixel_grid(h, w, flow.device) + flow
    g = torch.stack([2 * p[:, 0] / max(W - 1, 1) - 1,
                     2 * p[:, 1] / max(H - 1, 1) - 1], -1)
    out = F.grid_sample(x, g, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    if not with_mask:
        return out
    return out, (g.abs() < 1).all(-1)


def lands_inside(flow: torch.Tensor) -> torch.Tensor:
    """(B, h, w): pixel plus flow within the image, borders included."""
    h, w = flow.shape[-2:]
    p = pixel_grid(h, w, flow.device) + flow
    return ((p[:, 0] >= 0) & (p[:, 0] <= w - 1) & (p[:, 1] >= 0)
            & (p[:, 1] <= h - 1))


def up(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


def scaled(flow, sx, sy):
    return torch.cat([flow[:, :1] * sx, flow[:, 1:] * sy], 1)


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------

class VGG(nn.Module):
    """torchvision's VGG ``features`` up to the last level of
    ``out_indices``; the levels are after the first conv's ReLU and after
    each pool."""

    def __init__(self, name: str, out_indices=(2, 3, 4)):
        super().__init__()
        self.layers, convs, at, cin, marks = [], {}, 0, 3, []
        for v in VGG_CFG[name]:
            if v == "M":
                self.layers.append(None)
                at += 1
                marks.append(at)
            else:
                convs[str(at)] = nn.Conv2d(cin, v, 3, padding=1)
                self.layers.append(str(at))
                at += 2
                cin = v
                if not marks:
                    marks.append(at)
        self.marks = [marks[i] for i in out_indices]
        keep = max(self.marks)
        self.features = nn.ModuleDict({k: m for k, m in convs.items()
                                       if int(k) < keep})

    def forward(self, x, levels) -> List[torch.Tensor]:
        want = [self.marks[i] for i in levels]
        outs, at = [], 0
        for layer in self.layers:
            if at >= max(want):
                break
            if layer is None:
                x = F.max_pool2d(x, 2, 2)
                at += 1
            else:
                x = F.relu(self.features[layer](x))
                at += 2
            if at in want:
                outs.append(x)
        return outs


# ---------------------------------------------------------------------------
# matching modules
# ---------------------------------------------------------------------------

def leaky(x):
    return F.leaky_relu(x, 0.1)


class CBN(nn.Module):
    """Conv (no bias) + BatchNorm, with the activation given."""

    def __init__(self, cin, cout, k, dilation=1, padding=None, act=None):
        super().__init__()
        p = dilation * (k // 2) if padding is None else padding
        self.conv = nn.Conv2d(cin, cout, k, padding=p, dilation=dilation,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


class FlowDecoder(nn.Module):
    """The residual-skip flow decoder: (2-channel output, 32 features)."""

    def __init__(self, cin):
        super().__init__()
        self.conv_0 = CBN(cin, 128, 3)
        self.conv_1 = CBN(128, 128, 3)
        self.conv_2 = CBN(128, 96, 3)
        self.conv0_skip = CBN(128, 96, 1)
        self.conv_3 = CBN(96, 64, 3)
        self.conv_4 = CBN(64, 32, 3)
        self.conv2_skip = CBN(96, 32, 1)
        self.predict_mapping = nn.Conv2d(32, 2, 3, padding=1)

    def forward(self, x):
        a = self.conv_0(x)
        b = self.conv_2(leaky(self.conv_1(leaky(a)))) + self.conv0_skip(a)
        c = self.conv_4(leaky(self.conv_3(leaky(b)))) + self.conv2_skip(b)
        feat = leaky(c)
        return self.predict_mapping(feat), feat


class Refinement(nn.Module):
    """Dilated context network on the decoder's features: a residual flow."""

    def __init__(self, cin):
        super().__init__()
        ch = [cin, 128, 128, 128, 96, 64, 32]
        layers = [CBN(ch[i], ch[i + 1], 3, d, act=leaky)
                  for i, d in enumerate((1, 2, 4, 8, 16, 1))]
        self.dc_convs = nn.Sequential(*layers,
                                      nn.Conv2d(32, 2, 3, padding=1))

    def forward(self, x):
        return self.dc_convs(x)


class Uncertainty(nn.Module):
    """Log-variance from each pixel's S x S correlation (as a little
    image), the decoder features and, where ``previous``, the coarser
    level's log-variance and flow."""

    def __init__(self, S: int, previous: bool):
        super().__init__()
        self.S = S
        self.conv_0 = CBN(1, 32, 3, padding=0, act=leaky)
        self.conv_1 = CBN(32, 32, 3, padding=0, act=leaky)
        self.conv_2 = CBN(32, 16, 3, padding=0, act=leaky)
        self.predict_uncertainty = nn.Conv2d(16, 6, 3)
        self.pred_conv_0 = CBN(6 + FEAT + (3 if previous else 0), 32, 3,
                               act=leaky)
        self.pred_conv_1 = CBN(32, 16, 3, act=leaky)
        self.predict_uncertainty_final = nn.Conv2d(16, 1, 3, padding=1)

    def forward(self, corr, feat, *previous):
        B, _, h, w = corr.shape
        S = self.S
        x = self.conv_0(corr.permute(0, 2, 3, 1).reshape(B * h * w, 1, S, S))
        if S == 16:
            x = F.max_pool2d(x, 2, 2)
        x = self.predict_uncertainty(self.conv_2(self.conv_1(x)))
        x = x.reshape(B, h, w, 6).permute(0, 3, 1, 2)
        x = torch.cat([x, feat, *previous], 1)
        return self.predict_uncertainty_final(
            self.pred_conv_1(self.pred_conv_0(x)))


def correlation_relu_l2(corr: torch.Tensor) -> torch.Tensor:
    return F.normalize(F.relu(corr), dim=1)


def mutual_matching(corr: torch.Tensor) -> torch.Tensor:
    """NC-Net's soft mutual nearest neighbours on (B, source, Ht, Wt)."""
    best_src = corr.amax(1, keepdim=True)
    best_trg = corr.amax((2, 3), keepdim=True)
    return corr * (corr / (best_src + 1e-5)) * (corr / (best_trg + 1e-5))


def l2n(x):
    return F.normalize(x, dim=1)


class UAWarpCHead(nn.Module):
    """Coarse to fine: a global correlation at 16 x 16 of the 256^2
    pyramid, then local correlations at its 32 x 32 level, at 1/8 and at
    1/4 of the image, each level's decoder refining the upsampled flow,
    with a log-variance chained through the levels."""

    def __init__(self):
        super().__init__()
        local = PATCH * PATCH + 2 + 1
        self.decoder4 = FlowDecoder(GRID4 ** 2)
        self.decoder3 = FlowDecoder(local)
        self.decoder2 = FlowDecoder(local)
        self.decoder1 = FlowDecoder(local + 2)
        self.refinement_module_adaptive = Refinement(FEAT)
        self.refinement_module_finest = Refinement(FEAT)
        self.reduce = nn.Conv2d(FEAT, 2, 1)
        self.estimate_uncertainty_components4 = Uncertainty(GRID4, False)
        for lvl in (3, 2, 1):
            setattr(self, f"estimate_uncertainty_components{lvl}",
                    Uncertainty(PATCH, True))

    def forward(self, trg, src, trg256, src256, size):
        """Pyramids (1/4, 1/8 of the image; 32^2 and 16^2 of 256^2) of
        the target and the source; the flows map the target onto the
        source."""
        t1, t2 = map(l2n, trg)
        s1, s2 = map(l2n, src)
        t3, t4 = map(l2n, trg256)
        s3, s4 = map(l2n, src256)
        H, W = float(size[0]), float(size[1])
        log_diag = 2 * math.log(math.hypot(H, W) / math.hypot(256., 256.))
        um = [getattr(self, f"estimate_uncertainty_components{i}")
              for i in (4, 3, 2, 1)]

        # level 4: mutual-matching global correlation -> a mapping
        corr4 = correlation_relu_l2(mutual_matching(
            global_correlation(s4, t4)))
        nmap, x4 = self.decoder4(corr4)
        g = GRID4
        mapping = (nmap + 1) * (g - 1) / 2
        flow4 = (mapping - pixel_grid(g, g, nmap.device)) * (256. / g)
        u4 = um[0](corr4, x4) + 2 * math.log(256. / g)

        # level 3: 32 x 32 of the 256^2 pyramid
        h3, w3 = t3.shape[-2:]
        f = up(flow4, (h3, w3))
        u = up(u4, (h3, w3))
        corr3 = correlation_relu_l2(local_correlation(
            t3, warp(s3, scaled(f, w3 / 256., h3 / 256.)), PATCH))
        res, x3 = self.decoder3(torch.cat([corr3, f, u], 1))
        res = res + self.refinement_module_adaptive(x3)
        u3 = um[1](corr3, x3, u, f) + log_diag
        flow3 = scaled(res + f, W / 256., H / 256.)

        # level 2: 1/8 of the image
        h2, w2 = t2.shape[-2:]
        f = up(flow3, (h2, w2))
        u = up(u3, (h2, w2))
        corr2 = correlation_relu_l2(local_correlation(
            t2, warp(s2, scaled(f, w2 / W, h2 / H)), PATCH))
        res, x2 = self.decoder2(torch.cat([corr2, f, u], 1))
        u2 = um[2](corr2, x2, u, f)
        flow2 = res + f

        # level 1: 1/4 of the image, with the level-2 features
        h1, w1 = t1.shape[-2:]
        f = up(flow2, (h1, w1))
        u = up(u2, (h1, w1))
        feat2 = self.reduce(up(x2, (h1, w1)))
        corr1 = correlation_relu_l2(local_correlation(
            t1, warp(s1, scaled(f, w1 / W, h1 / H)), PATCH))
        res, x1 = self.decoder1(torch.cat([corr1, f, feat2, u], 1))
        res = res + self.refinement_module_finest(x1)
        u1 = um[3](corr1, x1, u, f)
        flow1 = res + f
        return [(scaled(flow4, W / 256., H / 256.), u4 + log_diag),
                (flow3, u3), (flow2, u2), (flow1, u1)]


class AlignmentNet(nn.Module):
    def __init__(self, vgg: str = "vgg16"):
        super().__init__()
        self.backbone = VGG(vgg)
        self.head = UAWarpCHead()


def area256(x):
    return F.adaptive_avg_pool2d(x, (256, 256))


def pyramids(vgg: VGG, images: List[torch.Tensor]):
    """Each image set's pyramid at the image size (1/4, 1/8) and at 256^2
    (1/8, 1/16), one backbone call for each size over all sets."""
    n = [x.shape[0] for x in images]
    full = vgg(torch.cat(images), (-3, -2))
    small = vgg(torch.cat([area256(x) for x in images]), (-2, -1))

    def split(levels):
        return list(zip(*[lv.split(n) for lv in levels]))
    return split(full), split(small)


def flow_and_logvar(net: AlignmentNet, trg: torch.Tensor, src: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The finest flow target -> source and its log-variance, at the image
    size."""
    H, W = trg.shape[-2:]
    (p_src, p_trg), (q_src, q_trg) = pyramids(net.backbone, [src, trg])
    flow, logvar = net.head(list(p_trg), list(p_src), list(q_trg),
                            list(q_src), (H, W))[-1]
    return up(flow, (H, W)), up(logvar, (H, W))
