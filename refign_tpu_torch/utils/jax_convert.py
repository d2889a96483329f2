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

``load_uda_state`` carries a whole JAX ``UDATrainState`` across (student,
teacher, ImageNet copy, step, and the optax Adam moments and count into the
torch AdamW state), and ``load_align_state`` a JAX ``AlignTrainState``
(head, frozen backbone, step, Adam); the optax state is read by its field
names, so nothing of optax is imported.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

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


def _leaf(tree, path, what: str):
    node = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            raise KeyError(f"{what}: flax {'/'.join(path)} missing")
        node = node[p]
    return node


def _as_torch(key: str, node, t: torch.Tensor) -> torch.Tensor:
    """The flax leaf of state_dict ``key`` in the layout and dtype of
    ``t``."""
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
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(t.dtype)


def params_like(module: nn.Module, tree: Mapping[str, Any]
                ) -> Dict[str, torch.Tensor]:
    """A params-shaped flax tree (gradients, Adam moments) on ``module``'s
    parameter names, in their layouts.  Leaves that are not arrays (optax's
    masked-out nodes) are skipped."""
    out = {}
    for key, p in module.named_parameters():
        _, path = flax_location(key, p.dim())
        node = _leaf(tree, path, key)
        if hasattr(node, "shape"):
            out[key] = _as_torch(key, node, p.detach())
    return out


def load_jax_variables(module: nn.Module,
                       variables: Mapping[str, Any]) -> nn.Module:
    """Fill ``module``'s state_dict from ``{"params": ..., "batch_stats":
    ...}`` (nested dicts of arrays, as the JAX package's ``init`` returns).

    Strict both ways: every state_dict entry must find its leaf with the
    right shape, and every flax leaf must be used."""
    new = {}
    for key, t in module.state_dict().items():
        coll, path = flax_location(key, t.dim())
        new[key] = _as_torch(key, _leaf(variables[coll], path, key), t)
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


def _adam_states(opt_state):
    """The optax ``ScaleByAdamState`` nodes (fields count, mu, nu) inside an
    optax state, found by their field names."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return [opt_state]
    if isinstance(opt_state, Mapping):
        children = list(opt_state.values())
    elif isinstance(opt_state, (tuple, list)):
        children = list(opt_state)
    else:
        return []
    return [s for c in children for s in _adam_states(c)]


def load_uda_state(trainer, state) -> None:
    """Carry a JAX ``UDATrainState`` (``refign_tpu/uda/trainer.py:77-85``)
    into a port ``UDATrainer``: the student's and the teacher's parameters
    and BatchNorm statistics, the ImageNet copy's parameters, the step, and
    the AdamW state from the optax Adam moments and count (one
    ``scale_by_adam`` per parameter group, as ``make_uda_optimizer``
    chains them)."""
    ts = trainer.state
    load_jax_variables(ts.student, {"params": state.params,
                                    "batch_stats": state.batch_stats or {}})
    load_jax_variables(ts.teacher, {
        "params": state.teacher_params,
        "batch_stats": state.teacher_batch_stats or {}})
    if ts.imnet is not None:
        load_jax_variables(ts.imnet, {
            "params": state.imnet_params,
            "batch_stats": state.imnet_batch_stats or {}})
    ts.step = int(np.asarray(state.step))
    _load_adam(ts.optimizer, ts.student, state.opt_state)


def _load_adam(opt: torch.optim.Optimizer, module: nn.Module,
               opt_state) -> None:
    """Every optax ``scale_by_adam`` moment and count in ``opt_state`` (on
    ``module``'s parameter names) into the torch Adam / AdamW state of
    ``opt``'s parameters."""
    names = {id(p): n for n, p in module.named_parameters()}
    moments = {}
    for adam in _adam_states(opt_state):
        count = int(np.asarray(adam.count))
        mu = params_like(module, adam.mu)
        nu = params_like(module, adam.nu)
        for key in mu:
            moments[key] = (count, mu[key], nu[key])
    for group in opt.param_groups:
        for p in group["params"]:
            key = names[id(p)]
            if key not in moments:
                raise KeyError(f"{key}: no Adam moments in the optax state")
            count, mu, nu = moments[key]
            opt.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu.to(p.device, p.dtype),
                "exp_avg_sq": nu.to(p.device, p.dtype)}


def load_align_state(trainer, state) -> None:
    """Carry a JAX ``AlignTrainState`` (``refign_tpu/alignment/
    trainer.py:101-106``) into a port ``AlignTrainer``: the head's
    parameters and BatchNorm statistics, the frozen backbone's parameters
    (into its compute dtype), the step, and the torch Adam state from the
    optax Adam moments and count (``make_adam_optimizer``'s chain)."""
    ts = trainer.state
    load_jax_variables(ts.head, {"params": state.params,
                                 "batch_stats": state.batch_stats or {}})
    load_jax_variables(ts.backbone, {"params": state.backbone_params})
    ts.step = int(np.asarray(state.step))
    _load_adam(ts.optimizer, ts.head, state.opt_state)
