"""Image resizing on NHWC tensors (counterpart of ``refign_tpu/ops/resize.py``).

The JAX package re-implements ``torch.nn.functional.interpolate``'s
coordinate rules; here the torch op itself runs, on the NCHW view of the
NHWC tensor (channels_last memory), and the result is permuted back.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["interpolate", "adaptive_avg_pool"]


def interpolate(x: torch.Tensor, size: Tuple[int, int],
                mode: str = "bilinear",
                align_corners: Optional[bool] = None) -> torch.Tensor:
    """``F.interpolate`` on NHWC: 'bilinear' (align_corners required),
    'nearest' (legacy torch rule) or 'area'."""
    size = (int(size[0]), int(size[1]))
    if mode == "nearest" or mode == "area":
        if align_corners is not None:
            raise ValueError(f"mode '{mode}' takes no align_corners")
    elif mode == "bilinear":
        if align_corners is None:
            raise ValueError("bilinear requires align_corners")
    else:
        raise ValueError(f"unsupported mode: {mode}")
    if mode != "nearest" and not x.is_floating_point():
        raise TypeError(
            f"interpolate mode '{mode}' requires a floating dtype, got "
            f"{x.dtype}; use mode='nearest' for integer label maps")
    if tuple(x.shape[1:3]) == size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode=mode,
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


def adaptive_avg_pool(x: torch.Tensor,
                      out_size: Union[int, Tuple[int, int]]) -> torch.Tensor:
    """torch.nn.AdaptiveAvgPool2d on NHWC, computed in fp32."""
    if isinstance(out_size, int):
        out_size = (out_size, out_size)
    y = F.adaptive_avg_pool2d(x.float().permute(0, 3, 1, 2), out_size)
    return y.permute(0, 2, 3, 1).to(x.dtype)
