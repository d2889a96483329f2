"""Head input-transform helpers (counterpart of
``refign_tpu/models/heads/base.py``)."""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ...ops.resize import interpolate


def transform_inputs(inputs: Sequence[torch.Tensor],
                     in_index: Union[int, Sequence[int]],
                     input_transform: Optional[str] = None):
    """Select/merge multi-level NHWC features for a decode head."""
    if input_transform == "resize_concat":
        sel = [inputs[i] for i in in_index]
        target = sel[0].shape[1:3]
        up = [interpolate(x, target, mode="bilinear", align_corners=False)
              for x in sel]
        return torch.cat(up, dim=-1)
    if input_transform == "multiple_select":
        return [inputs[i] for i in in_index]
    if isinstance(in_index, (list, tuple)):
        if len(in_index) != 1:
            raise ValueError(f"expected one input index, got {in_index}")
        return inputs[in_index[0]]
    return inputs[in_index]
