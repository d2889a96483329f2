"""Precision policy helpers (counterpart of ``refign_tpu/parallel/mesh.py``;
the mesh and row-sharding helpers have nothing to do on one card)."""
from __future__ import annotations

import torch
from torch import nn


def cast_floating(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the floating PARAMETERS of ``module`` to ``dtype`` in place.

    Buffers (BatchNorm running statistics) stay fp32, as the JAX package
    leaves ``batch_stats`` fp32; ``module.to(dtype)`` would round them too.
    """
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module
