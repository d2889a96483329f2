"""Cityscapes 19-class palette + mask colorization
(reference helpers/utils.py:6-56; a copy of
``refign_tpu/utils/palette.py``)."""
from __future__ import annotations

import numpy as np
from PIL import Image

# Cityscapes trainId colors, flat [r,g,b]*19 (reference helpers/utils.py:6-13)
CITYSCAPES_PALETTE = [
    128, 64, 128, 244, 35, 232, 70, 70, 70, 102, 102, 156, 190, 153, 153,
    153, 153, 153, 250, 170, 30, 220, 220, 0, 107, 142, 35, 152, 251, 152,
    70, 130, 180, 220, 20, 60, 255, 0, 0, 0, 0, 142, 0, 0, 70,
    0, 60, 100, 0, 80, 100, 0, 0, 230, 119, 11, 32,
]

_ZERO_PAD = 256 * 3 - len(CITYSCAPES_PALETTE)
FULL_PALETTE = CITYSCAPES_PALETTE + [0] * _ZERO_PAD


def colorize_mask(mask) -> Image.Image:
    """trainId mask (H, W) uint8 / PIL 'P' -> palettized color image."""
    if isinstance(mask, np.ndarray):
        mask = Image.fromarray(mask.astype(np.uint8))
    new_mask = mask.convert("P")
    new_mask.putpalette(FULL_PALETTE)
    return new_mask
