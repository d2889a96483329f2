"""Precision policy helpers (counterpart of ``refign_tpu/parallel/mesh.py``;
the mesh and row-sharding helpers have nothing to do on one card).

Two ways to run a module in a compute dtype:

* :func:`cast_floating` casts the parameters themselves, in place: the
  frozen inference and alignment networks hold bf16 parameters;
* :func:`apply_cast` runs a module on bf16 COPIES of its fp32 master
  parameters through ``torch.func.functional_call``: the cast is part of
  the graph, so gradients reach the fp32 masters in fp32 (the train step's
  bf16 compute, ``refign_tpu/uda/trainer.py:140-142``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.func import functional_call


def cast_floating(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the floating PARAMETERS of ``module`` to ``dtype`` in place.

    Buffers (BatchNorm running statistics) stay fp32, as the JAX package
    leaves ``batch_stats`` fp32; ``module.to(dtype)`` would round them too.
    """
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module


def cast_params(module: nn.Module, dtype: torch.dtype
                ) -> Dict[str, torch.Tensor]:
    """``module``'s floating parameters cast to ``dtype`` (differentiable
    copies), by name; buffers are left to the module."""
    return {n: p.to(dtype) for n, p in module.named_parameters()
            if p.is_floating_point()}


def apply_cast(module: nn.Module, dtype: Optional[torch.dtype], *args,
               params: Optional[Dict[str, torch.Tensor]] = None,
               **kwargs):
    """``module(*args, **kwargs)`` on its parameters cast to ``dtype``
    (or on ``params``, a cast made once and reused); fp32 or None runs the
    module as it is."""
    if params is None:
        if dtype is None or dtype == torch.float32:
            return module(*args, **kwargs)
        params = cast_params(module, dtype)
    return functional_call(module, params, args, kwargs)
