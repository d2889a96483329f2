"""Plain Refign-HRDA★ segmentor, NCHW: the MiT encoder (SegFormer), the
DAFormer decoder, the SegFormer head as HRDA's scale attention, and HRDA's
multi-resolution forwards, written from the papers' and the upstream
repositories' definitions (NVlabs/SegFormer ``mix_transformer.py``,
lhoyer/DAFormer ``daformer_head.py``, lhoyer/HRDA ``hrda_encoder_decoder.py``
and ``hrda_head.py``, brdav/refign ``models/hrda.py``) with torch.nn
layers.  Parameter names are those of the upstream torch state dicts as
the port keeps them, so one set of weights loads into both.

Randomness: in training, drop path and Dropout2d draw their keep masks
from the generator passed in, in forward order, each as one
``bernoulli_`` over an fp32 tensor of the mask's shape (drop path (B, 1,
1, 1) per block branch with a rate above 0, dropout (B, 1, 1, C)), the
protocol by which the benchmark hands the port and the reference the same
masks.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .kernels import attention, dwconv3x3_gelu

MIT = {
    # embed dims, heads, depths; every model: mlp ratio 4, sr 8/4/2/1
    "mit_b0": ([32, 64, 160, 256], [1, 2, 5, 8], [2, 2, 2, 2]),
    "mit_b1": ([64, 128, 320, 512], [1, 2, 5, 8], [2, 2, 2, 2]),
    "mit_b2": ([64, 128, 320, 512], [1, 2, 5, 8], [3, 4, 6, 3]),
    "mit_b5": ([64, 128, 320, 512], [1, 2, 5, 8], [3, 6, 40, 3]),
}
SR_RATIOS = (8, 4, 2, 1)


def keep_mask(shape, rate: float, gen: torch.Generator,
              device) -> torch.Tensor:
    return torch.empty(shape, device=device).bernoulli_(1.0 - rate,
                                                        generator=gen)


def up(x: torch.Tensor, size) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


# ---------------------------------------------------------------------------
# MiT
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, sr: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr
        self.scale = (dim // heads) ** -0.5
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr > 1:
            self.sr = nn.Conv2d(dim, dim, sr, stride=sr)
            self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        h = self.heads
        q = self.q(x).reshape(B, N, h, C // h).transpose(1, 2)
        if self.sr_ratio > 1:
            y = self.sr(x.transpose(1, 2).reshape(B, C, H, W))
            y = self.norm(y.flatten(2).transpose(1, 2))
        else:
            y = x
        kv = self.kv(y).reshape(B, -1, 2, h, C // h).permute(2, 0, 3, 1, 4)
        out = attention(q, kv[0], kv[1], self.scale)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, 1, 3, 3))
        self.bias = nn.Parameter(torch.empty(dim))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, _ = x.shape
        y = self.fc1(x).transpose(1, 2).reshape(B, -1, H, W)
        y = dwconv3x3_gelu(y, self.dwconv.weight, self.dwconv.bias)
        return self.fc2(y.flatten(2).transpose(1, 2))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, sr: int, drop_path: float):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, sr)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)

    def _dropped(self, y, gen):
        if gen is None or self.drop_path == 0.0:
            return y
        keep = keep_mask((y.shape[0], 1, 1, 1), self.drop_path, gen,
                         y.device)
        return y * keep.reshape(-1, 1, 1) / (1.0 - self.drop_path)

    def forward(self, x, H, W, gen=None):
        x = x + self._dropped(self.attn(self.norm1(x), H, W), gen)
        return x + self._dropped(self.mlp(self.norm2(x), H, W), gen)


class PatchEmbed(nn.Module):
    def __init__(self, k: int, stride: int, cin: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, k, stride=stride, padding=k // 2)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        x = self.proj(x)
        H, W = x.shape[-2:]
        return self.norm(x.flatten(2).transpose(1, 2)), H, W


class MiT(nn.Module):
    """Returns the four stages' NCHW maps (1/4 .. 1/32).  ``gen``: draw
    drop path from it (training); None: no drop path."""

    def __init__(self, model: str, drop_path_rate: float):
        super().__init__()
        dims, heads, depths = MIT[model]
        self.embed_dims = dims
        rates = torch.linspace(0, drop_path_rate, sum(depths),
                               device="cpu").tolist()
        at, cin = 0, 3
        for s in range(4):
            k, stride = (7, 4) if s == 0 else (3, 2)
            setattr(self, f"patch_embed{s + 1}",
                    PatchEmbed(k, stride, cin, dims[s]))
            setattr(self, f"block{s + 1}", nn.ModuleList(
                Block(dims[s], heads[s], SR_RATIOS[s], rates[at + i])
                for i in range(depths[s])))
            setattr(self, f"norm{s + 1}", nn.LayerNorm(dims[s], eps=1e-6))
            at += depths[s]
            cin = dims[s]

    def forward(self, x, gen=None) -> List[torch.Tensor]:
        outs = []
        for s in range(1, 5):
            t, H, W = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                t = blk(t, H, W, gen)
            t = getattr(self, f"norm{s}")(t)
            x = t.transpose(1, 2).reshape(t.shape[0], -1, H, W)
            outs.append(x)
        return outs


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------

class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU: mmseg's ConvModule."""

    def __init__(self, cin, cout, k, dilation=1, groups=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=dilation * (k // 2),
                              dilation=dilation, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class SepConvBN(nn.Module):
    """mmseg's DepthwiseSeparableConvModule."""

    def __init__(self, cin, cout, dilation):
        super().__init__()
        self.depthwise_conv = ConvBN(cin, cin, 3, dilation, groups=cin)
        self.pointwise_conv = ConvBN(cin, cout, 1)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class Embed(nn.Module):
    """The per-pixel linear embedding (mmseg MLP)."""

    def __init__(self, cin, dim):
        super().__init__()
        self.proj = nn.Linear(cin, dim)

    def forward(self, x):
        return self.proj(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def dropout2d(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    if gen is None or rate == 0.0:
        return x
    keep = keep_mask((x.shape[0], 1, 1, x.shape[1]), rate, gen, x.device)
    return x * keep.permute(0, 3, 1, 2) / (1.0 - rate)


class ASPP(nn.Module):
    def __init__(self, cin, ch, dilations=(1, 6, 12, 18)):
        super().__init__()
        self.aspp_modules = nn.ModuleList(
            ConvBN(cin, ch, 1) if d == 1 else SepConvBN(cin, ch, d)
            for d in dilations)
        self.bottleneck = ConvBN(len(dilations) * ch, ch, 3)

    def forward(self, x):
        return self.bottleneck(torch.cat([m(x) for m in self.aspp_modules],
                                         1))


class DAFormerHead(nn.Module):
    def __init__(self, dims, classes, ch, dropout):
        super().__init__()
        self.dropout = dropout
        self.embed_layers = nn.ModuleList(Embed(d, ch) for d in dims)
        self.fuse_layer = ASPP(4 * ch, ch)
        self.conv_seg = nn.Conv2d(ch, classes, 1)

    def forward(self, feats, gen=None):
        size = feats[0].shape[-2:]
        x = torch.cat([up(e(f), size) for e, f in
                       zip(self.embed_layers, feats)], 1)
        x = dropout2d(self.fuse_layer(x), self.dropout, gen)
        return self.conv_seg(x)


class SegFormerHead(nn.Module):
    def __init__(self, dims, classes, ch, dropout):
        super().__init__()
        self.dropout = dropout
        for i, d in enumerate(dims):
            setattr(self, f"linear_c{i + 1}", Embed(d, ch))
        self.linear_fuse = ConvBN(4 * ch, ch, 1)
        self.linear_pred = nn.Conv2d(ch, classes, 1)

    def forward(self, feats, gen=None):
        size = feats[0].shape[-2:]
        x = torch.cat([up(getattr(self, f"linear_c{i}")(feats[i - 1]), size)
                       for i in (4, 3, 2, 1)], 1)
        x = dropout2d(self.linear_fuse(x), self.dropout, gen)
        return self.linear_pred(x)


# ---------------------------------------------------------------------------
# HRDA
# ---------------------------------------------------------------------------

def slide_boxes(size, crop, stride) -> List[Tuple[int, int, int, int]]:
    """mmseg's slide grid: (y1, y2, x1, x2), the last row and column
    moved in to end at the border."""
    (H, W), (ch, cw), (sh, sw) = size, crop, stride
    ny = max(H - ch + sh - 1, 0) // sh + 1
    nx = max(W - cw + sw - 1, 0) // sw + 1
    boxes = []
    for i in range(ny):
        for j in range(nx):
            y2, x2 = min(i * sh + ch, H), min(j * sw + cw, W)
            boxes.append((max(y2 - ch, 0), y2, max(x2 - cw, 0), x2))
    return boxes


def fold(logits: torch.Tensor, boxes, size, B: int) -> torch.Tensor:
    """Each crop's logits (crop-major rows) added at its box, divided by
    how many boxes cover each pixel."""
    out = logits.new_zeros((B, logits.shape[1]) + tuple(size))
    count = logits.new_zeros((1, 1) + tuple(size))
    for i, (y1, y2, x1, x2) in enumerate(boxes):
        out[:, :, y1:y2, x1:x2] += logits[i * B:(i + 1) * B]
        count[:, :, y1:y2, x1:x2] += 1
    return out / count


class Segmentor(nn.Module):
    """MiT + DAFormer + the SegFormer scale attention, HRDA output stride
    ``os``."""

    def __init__(self, model: str, classes: int, channels: int,
                 att_channels: int, drop_path: float, dropout: float,
                 os: int = 4):
        super().__init__()
        self.os = os
        self.backbone = MiT(model, drop_path)
        dims = self.backbone.embed_dims
        self.head = DAFormerHead(dims, classes, channels, dropout)
        self.scale_attention = SegFormerHead(dims, classes, att_channels,
                                             dropout)

    def hrda_train(self, x: torch.Tensor, crop: Tuple[int, int], gen=None):
        """HRDA training forward on the LR half-size image and the HR crop
        at ``crop``: (fused logits at 1/os, the HR logits at the crop's
        size, the LR features)."""
        B, _, H, W = x.shape
        ch, cw = H // 2, W // 2
        oy, ox = crop
        feats = self.backbone(torch.cat([up(x, (ch, cw)),
                                         x[:, :, oy:oy + ch, ox:ox + cw]]),
                              gen)
        seg = self.head(feats, gen)
        lr_feats = [f[:B] for f in feats]
        att = torch.sigmoid(self.scale_attention(lr_feats, gen))
        lr_seg, hr_seg = seg[:B], seg[B:]
        # the attention lives only inside the crop, on the LR grid
        s = 2 * self.os
        inside = torch.zeros_like(att[:1, :1])
        inside[..., oy // s:(oy + ch) // s, ox // s:(ox + cw) // s] = 1
        att = att * inside
        gh, gw = lr_seg.shape[-2:]
        big = (2 * gh, 2 * gw)
        placed = torch.zeros((B, hr_seg.shape[1]) + big, dtype=hr_seg.dtype,
                             device=hr_seg.device)
        ty, tx = oy // self.os, ox // self.os
        placed[..., ty:ty + hr_seg.shape[2], tx:tx + hr_seg.shape[3]] = \
            hr_seg
        fused = up(att, big) * placed + up((1 - att) * lr_seg, big)
        return fused, up(hr_seg, (ch, cw)), lr_feats

    def hrda_eval(self, x: torch.Tensor) -> torch.Tensor:
        """HRDA inference at 1/os: the LR pass and the HR slide crops
        (half size, half overlap) in one batch, crops folded, fused by
        the scale attention."""
        B, _, H, W = x.shape
        ch, cw = H // 2, W // 2
        boxes = slide_boxes((H, W), (ch, cw), (ch // 2, cw // 2))
        rows = [up(x, (ch, cw))] + [x[:, :, a:b, c:d]
                                    for a, b, c, d in boxes]
        feats = self.backbone(torch.cat(rows))
        seg = self.head(feats)
        att = torch.sigmoid(self.scale_attention([f[:B] for f in feats]))
        o = self.os
        hr = fold(seg[B:], [(a // o, b // o, c // o, d // o)
                            for a, b, c, d in boxes], (H // o, W // o), B)
        big = hr.shape[-2:]
        return up(att, big) * hr + up((1 - att) * seg[:B], big)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        return up(self.hrda_eval(x), x.shape[-2:])


def slide_inference(whole, img: torch.Tensor, crop, stride) -> torch.Tensor:
    """The outer slide: every crop of the grid in one batch, folded."""
    B, _, H, W = img.shape
    boxes = slide_boxes((H, W), crop, stride)
    crops = torch.cat([img[:, :, a:b, c:d] for a, b, c, d in boxes])
    return fold(whole(crops), boxes, (H, W), B)
