"""Load the JAX package's flax variables into a port module.

The inverse of ``refign_tpu/utils/torch_convert.py:convert_state_dict``
(whose key rules are copied here; the port imports nothing of the JAX
package).  Each key of the module's ``state_dict`` names its flax leaf:

* numeric components fuse into their parent (``block1.0`` -> ``block1_0``);
* ``weight`` of rank 4: HWIO kernel -> OIHW;
* ``weight`` of rank 2: Dense (in, out) kernel -> Linear (out, in); for
  ``mlp.fc1``/``mlp.fc2`` the flax kernel is a (1, 1, in, out) conv kernel;
* ``weight`` of rank 1 -> ``scale`` (LayerNorm, BatchNorm);
* ``running_mean``/``running_var`` -> ``batch_stats`` ``mean``/``var``.
"""
from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch
from torch import nn

DENSE_AS_CONV1X1_SUFFIXES = (".mlp.fc1", ".mlp.fc2")


def _fuse_numeric(parts):
    out = []
    for p in parts:
        if p.isdigit() and out:
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    return out


def flax_location(key: str, ndim: int) -> Tuple[str, Tuple[str, ...]]:
    """(collection, path) of the flax leaf that holds state_dict ``key``."""
    parts = key.split(".")
    leaf = parts[-1]
    path = tuple(_fuse_numeric(parts[:-1]))
    if leaf == "weight":
        return "params", path + (("scale",) if ndim == 1 else ("kernel",))
    if leaf == "bias":
        return "params", path + ("bias",)
    if leaf == "running_mean":
        return "batch_stats", path + ("mean",)
    if leaf == "running_var":
        return "batch_stats", path + ("var",)
    raise ValueError(f"no flax counterpart for state_dict key {key}")


def _count_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def load_jax_variables(module: nn.Module,
                       variables: Mapping[str, Any]) -> nn.Module:
    """Fill ``module``'s state_dict from ``{"params": ..., "batch_stats":
    ...}`` (nested dicts of arrays, as the JAX package's ``init`` returns).

    Strict both ways: every state_dict entry must find its leaf with the
    right shape, and every flax leaf must be used."""
    new = {}
    for key, t in module.state_dict().items():
        coll, path = flax_location(key, t.dim())
        node = variables[coll]
        for p in path:
            if p not in node:
                raise KeyError(f"{key}: flax {coll}/{'/'.join(path)} missing")
            node = node[p]
        arr = np.asarray(node)
        if key.endswith(".weight") and t.dim() == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif key.endswith(".weight") and t.dim() == 2:
            if any(key.endswith(s + ".weight")
                   for s in DENSE_AS_CONV1X1_SUFFIXES):
                arr = arr.reshape(arr.shape[-2:])
            arr = arr.T
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} from flax, "
                             f"{tuple(t.shape)} in the module")
        new[key] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            t.dtype)
    n_flax = sum(_count_leaves(variables.get(c, {}))
                 for c in ("params", "batch_stats"))
    if n_flax != len(new):
        raise ValueError(f"flax tree has {n_flax} leaves, module state_dict "
                         f"{len(new)}")
    module.load_state_dict(new)
    return module


def load_alignment_params(net: nn.Module,
                          align_params: Mapping[str, Any]) -> nn.Module:
    """Fill an ``AlignmentNet`` from the JAX package's alignment trees
    ``{"backbone": params, "head": params, "head_stats": batch_stats}``
    (the layout of ``align_params`` in the UDA train step)."""
    load_jax_variables(net.backbone, {"params": align_params["backbone"]})
    load_jax_variables(net.head, {"params": align_params["head"],
                                  "batch_stats": align_params["head_stats"]})
    return net
