"""Encoder-decoder segmentor with HRDA multi-resolution inference, NHWC
(counterpart of ``refign_tpu/models/segmentor.py``).

* plain path: head(backbone(x)) + bilinear upsample;
* HRDA eval: one LR pass of the half-resolution image plus the HR slide
  crops (crop = LR size, stride = crop/2), all in ONE backbone batch
  ([LR rows, then crops], crop-major), folded with a visit-count average and
  fused by the sigmoid scale attention;
* HRDA train: the LR pass of the half-resolution image and ONE HR crop
  at a host-side integer offset in one backbone batch, the scale attention
  masked to the crop, the HR logits inserted at the offset;
* sliding-window inference: every crop of the grid in one batch, then
  folded back.

Under an active evaluation row spread (``parallel/mesh.py:compute_mesh``,
the JAX ``shard_rows`` of ``refign_tpu/models/segmentor.py:189``), each
rank runs its share of the row stack (HRDA's LR rows and crops, or the
rows of a plain forward, e.g. the slide crops) and the head logits (and
the scale attention of the LR rows) are reassembled on every rank before
the fold.

BatchNorm follows the module's mode (batch statistics in train mode, as
the EMA teacher's ``whole`` runs them); dropout and drop-path draw from a
generator where one is passed (``logits``, ``logits_and_features``,
``hrda_train``) and are off in ``whole``.  ``forward(x, method=...)``
dispatches to a method, so ``torch.func.functional_call`` can run any of
them on other parameters.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import interpolate
from ..parallel import mesh
from ..utils.profiling import span


def compute_slide_boxes(img_size: Tuple[int, int],
                        crop_size: Tuple[int, int],
                        stride: Tuple[int, int]
                        ) -> List[Tuple[int, int, int, int]]:
    """Slide-crop boxes (y1, y2, x1, x2), the reference grid rule."""
    h_img, w_img = img_size
    h_crop, w_crop = crop_size
    h_stride, w_stride = stride
    h_grids = max(h_img - h_crop + h_stride - 1, 0) // h_stride + 1
    w_grids = max(w_img - w_crop + w_stride - 1, 0) // w_stride + 1
    boxes = []
    for hi in range(h_grids):
        for wi in range(w_grids):
            y1, x1 = hi * h_stride, wi * w_stride
            y2, x2 = min(y1 + h_crop, h_img), min(x1 + w_crop, w_img)
            y1, x1 = max(y2 - h_crop, 0), max(x2 - w_crop, 0)
            boxes.append((y1, y2, x1, x2))
    return boxes


def fold_crops(crop_logits: torch.Tensor, boxes, img_size: Tuple[int, int],
               batch: int) -> torch.Tensor:
    """Add per-crop logits (n_crops*B, ch, cw, C), crop-major, back onto the
    full grid and average by visit count.  The count matrix depends only on
    the box grid and is built on the host."""
    h_img, w_img = img_size
    C = crop_logits.shape[-1]
    preds = crop_logits.new_zeros((batch, h_img, w_img, C))
    count = np.zeros((1, h_img, w_img, 1), np.float32)
    for (y1, y2, x1, x2) in boxes:
        count[:, y1:y2, x1:x2, :] += 1.0
    for i, (y1, y2, x1, x2) in enumerate(boxes):
        preds[:, y1:y2, x1:x2, :] += crop_logits[i * batch:(i + 1) * batch]
    return preds / torch.from_numpy(count).to(preds.device, preds.dtype)


class Segmentor(nn.Module):
    """backbone + head (+ HRDA scale attention)."""

    def __init__(self, backbone: nn.Module, head: nn.Module,
                 scale_attention: Optional[nn.Module] = None,
                 hrda_output_stride: int = 4):
        super().__init__()
        self.backbone = backbone
        self.head = head
        self.scale_attention = scale_attention
        self.hrda_output_stride = hrda_output_stride

    def logits(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.head(self.backbone(x, generator), generator)

    def logits_and_features(self, x: torch.Tensor,
                            generator: Optional[torch.Generator] = None
                            ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Head logits at the head's resolution and the backbone features
        (``refign_tpu/models/segmentor.py:103-108``)."""
        feats = self.backbone(x, generator)
        return self.head(feats, generator), feats

    def hrda_train(self, x: torch.Tensor, crop_offset: Tuple[int, int],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        """HRDA training forward (``refign_tpu/models/segmentor.py:
        112-168``).  ``crop_offset`` (oy, ox): host integers, each divisible
        by 2*hrda_output_stride, in [0, H/2].  Returns the fused logits
        (B, H/os, W/os, C), the HR logits upsampled to the crop
        (B, H/2, W/2, C) and the LR features."""
        os_ = self.hrda_output_stride
        B, H, W, _ = x.shape
        ch, cw = H // 2, W // 2
        oy, ox = int(crop_offset[0]), int(crop_offset[1])
        if oy % (2 * os_) or ox % (2 * os_) or not (
                0 <= oy <= H - ch and 0 <= ox <= W - cw):
            raise ValueError(f"crop offset {(oy, ox)} must be divisible by "
                             f"{2 * os_} and keep the {ch}x{cw} crop inside")
        lr_x = interpolate(x, (ch, cw), mode="bilinear", align_corners=False)
        hr_x = x[:, oy:oy + ch, ox:ox + cw]
        both_feats = self.backbone(torch.cat([lr_x, hr_x], dim=0),
                                   generator)
        lr_feats = [f[:B] for f in both_feats]
        both_seg = self.head(both_feats, generator)
        lr_seg, hr_seg = both_seg[:B], both_seg[B:]

        att = torch.sigmoid(self.scale_attention(lr_feats, generator))
        # attention only inside the crop, on the LR grid (scale 2*os)
        gh, gw = lr_seg.shape[1:3]
        y1, x1 = oy // (2 * os_), ox // (2 * os_)
        y2, x2 = y1 + ch // (2 * os_), x1 + cw // (2 * os_)
        mask = torch.zeros((1, gh, gw, 1), dtype=att.dtype, device=att.device)
        mask[:, y1:y2, x1:x2] = 1.0
        att = att * mask

        lr_seg = (1.0 - att) * lr_seg
        up_lr_seg = interpolate(lr_seg, (2 * gh, 2 * gw), mode="bilinear",
                                align_corners=False)
        up_att = interpolate(att, (2 * gh, 2 * gw), mode="bilinear",
                             align_corners=False)
        # the HR logits placed at the crop on the fused grid, zero elsewhere
        hh, hw = hr_seg.shape[1:3]
        ty, tx = oy // os_, ox // os_
        inserted = F.pad(hr_seg.to(up_lr_seg.dtype),
                         (0, 0, tx, 2 * gw - tx - hw, ty, 2 * gh - ty - hh))
        fused = up_att * inserted + up_lr_seg
        hr_logits = interpolate(hr_seg, (ch, cw), mode="bilinear",
                                align_corners=False)
        return fused, hr_logits, lr_feats

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """Eval logits upsampled to the input resolution."""
        if self.scale_attention is not None:
            logits = self.hrda_eval(x)
        else:
            logits = mesh.shard_rows(self.logits, x)
        return interpolate(logits, x.shape[1:3], mode="bilinear",
                           align_corners=False)

    def hrda_eval(self, x: torch.Tensor) -> torch.Tensor:
        """HRDA inference forward: LR full pass + HR slide crops, count-mat
        fold, sigmoid scale-attention fusion.  Output at H/os."""
        os_ = self.hrda_output_stride
        B, H, W, _ = x.shape
        ch, cw = H // 2, W // 2
        lr_x = interpolate(x, (ch, cw), mode="bilinear", align_corners=False)
        boxes = compute_slide_boxes((H, W), (ch, cw), (ch // 2, cw // 2))
        both = torch.cat([lr_x] + [x[:, y1:y2, x1:x2]
                                   for (y1, y2, x1, x2) in boxes], dim=0)
        if mesh.active_mesh():
            both_seg, att = self._spread_rows(both, B)
        else:
            both_feats = self.backbone(both)
            both_seg = self.head(both_feats)
            att = torch.sigmoid(self.scale_attention(
                [f[:B] for f in both_feats]))
        lr_seg, crop_seg = both_seg[:B], both_seg[B:]

        lr_seg = (1.0 - att) * lr_seg
        gh, gw = lr_seg.shape[1:3]
        up_lr_seg = interpolate(lr_seg, (2 * gh, 2 * gw), mode="bilinear",
                                align_corners=False)
        up_att = interpolate(att, (2 * gh, 2 * gw), mode="bilinear",
                             align_corners=False)
        scaled_boxes = [(y1 // os_, y2 // os_, x1 // os_, x2 // os_)
                        for (y1, y2, x1, x2) in boxes]
        hr_seg = fold_crops(crop_seg, scaled_boxes, (H // os_, W // os_), B)
        return up_att * hr_seg + up_lr_seg

    def _spread_rows(self, both: torch.Tensor, B: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``hrda_eval``'s head logits of every row and the scale attention
        of its first ``B`` (LR) rows, each rank running its share of the
        rows (a rank with none runs one for the shapes), reassembled on
        every rank."""
        n = both.shape[0]
        lo, hi = mesh.row_share(n)
        feats = self.backbone(both[lo:hi] if hi > lo else both[:1])
        seg = self.head(feats)[:hi - lo]
        n_lr = max(0, min(B, hi) - lo)
        att = torch.sigmoid(self.scale_attention(
            [f[:max(n_lr, 1)] for f in feats]))[:n_lr]
        return (mesh.gather_rows(seg, n, lo),
                mesh.gather_rows(att, B, min(lo, B)))

    def forward(self, x: torch.Tensor, *args, method: str = "whole",
                **kwargs):
        return getattr(self, method)(x, *args, **kwargs)


def slide_inference(whole_fn: Callable[[torch.Tensor], torch.Tensor],
                    img: torch.Tensor, crop_size: Tuple[int, int],
                    stride: Tuple[int, int]) -> torch.Tensor:
    """Batched sliding-window inference: ``whole_fn`` maps (N, ch, cw, 3)
    to (N, ch, cw, C) logits; img is (B, H, W, 3).  Spans
    (``utils/profiling.py``): ``slide.frame`` over ``slide.crops``,
    ``slide.forward`` and ``slide.fold``."""
    with span("slide.frame"):
        B, H, W, _ = img.shape
        with span("slide.crops"):
            boxes = compute_slide_boxes((H, W), crop_size, stride)
            crops = torch.cat([img[:, y1:y2, x1:x2]
                               for (y1, y2, x1, x2) in boxes], dim=0)
        with span("slide.forward"):
            logits = whole_fn(crops)
        with span("slide.fold"):
            return fold_crops(logits, boxes, (H, W), B)
