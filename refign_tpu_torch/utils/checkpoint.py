"""Checkpoints (counterpart of ``refign_tpu/utils/checkpoint.py`` and the
loaders of ``refign_tpu/utils/torch_convert.py``).

Two kinds:

1. The port's own train-state checkpoints, written with ``torch.save``
   and read with ``weights_only=True``: the parameters and BatchNorm
   statistics of every network of the train state (fp32 masters; the
   UAWarpC trainer's frozen backbone in the compute dtype it is held in),
   the optimizer state, the step and the states of the trainer's generators
   (:func:`train_state` / :func:`load_train_state`).  The student's bf16
   copies are not stored: every step makes them afresh from the masters
   (``parallel/mesh.py:apply_cast``).  ``last`` is a symlink swapped by an
   atomic rename; pruning keeps the newest ``keep`` and never the file
   ``last`` points to, and ignores temporary files.

2. Reference (Lightning / torchvision / mmseg) checkpoints, read natively
   with ``weights_only=False`` (they carry non-tensor objects): backbone
   files (``backbone.`` stripped; ``head.``, ``fc.``, ``classifier.`` and
   ``conv_seg.`` dropped), the alignment head of an AlignmentModel
   checkpoint (``alignment_head.``) and full UDA checkpoints by submodule
   group (:data:`UDA_GROUPS`).  The port's modules keep the reference's
   parameter names and layouts; the names that differ are renamed by
   :data:`RENAMES`, the one table of them.  Backbones load with the JAX
   package's ``subset_like`` semantics (the file may hold more, every
   parameter of the module must be there); heads and full-checkpoint
   groups load strictly both ways.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

# reference parameter name -> port name (substring renames; the JAX
# package's convert_state_dict is the record of the reference's names)
RENAMES: Tuple[Tuple[str, str], ...] = (
    # MiT's Mlp holds a DWConv wrapper around one conv
    # (reference mix_transformer.py:556-568); the port's DWConvGELU is the
    # conv itself
    (".dwconv.dwconv.", ".dwconv."),
)

# full UDA checkpoint: group -> reference prefix
# (reference segmentation_model.py:66-88)
UDA_GROUPS: Dict[str, str] = {
    "backbone": "backbone.", "head": "head.",
    "scale_attention": "hrda_scale_attention.",
    "m_backbone": "m_backbone.", "m_head": "m_head.",
    "m_scale_attention": "m_hrda_scale_attention.",
    "imnet_backbone": "imnet_backbone.",
    "alignment_backbone": "alignment_backbone.",
    "alignment_head": "alignment_head.",
}

BACKBONE_DROP = ("head.", "fc.", "classifier.", "conv_seg.")


# ---------------------------------------------------------------------------
# reference checkpoints
# ---------------------------------------------------------------------------

def read_reference(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's flat state dict (``state_dict`` of a
    Lightning file, ``model`` of an mmseg one, else the file itself)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    if isinstance(ckpt, dict) and "model" in ckpt:
        return ckpt["model"]
    return ckpt


def rename(key: str) -> str:
    for old, new in RENAMES:
        key = key.replace(old, new)
    return key


def to_reference(sd: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A port state dict under the reference's names (the inverse of
    :data:`RENAMES`), each key under ``prefix``."""
    out = {}
    for k, v in sd.items():
        for old, new in RENAMES:
            k = k.replace(new, old)
        out[prefix + k] = v
    return out


def _strip(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {rename(k[len(prefix):]): v for k, v in sd.items()
            if k.startswith(prefix) and not k.endswith("num_batches_tracked")}


def backbone_state(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """ImageNet/Cityscapes backbone file -> port names: ``backbone.``
    stripped where present, classifier heads dropped."""
    if any(k.startswith("backbone.") for k in sd):
        sd = _strip(sd, "backbone.")
    else:
        sd = _strip(sd, "")
    return {k: v for k, v in sd.items()
            if not any(k.startswith(p) for p in BACKBONE_DROP)}


def alignment_head_state(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """AlignmentModel checkpoint -> the UAWarpC head's state dict."""
    return _strip(sd, "alignment_head.")


def uda_groups(sd: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Full reference UDA checkpoint -> per-group state dicts (groups
    absent from the file are left out)."""
    out = {}
    for name, prefix in UDA_GROUPS.items():
        sub = _strip(sd, prefix)
        if sub:
            out[name] = sub
    return out


def load_state(module: nn.Module, sd: Mapping[str, Any],
               subset: bool = False, what: str = "") -> nn.Module:
    """Copy ``sd`` into ``module`` in the module's dtypes and devices.
    Every state-dict entry of the module must be in ``sd`` with its
    shape; with ``subset`` False, ``sd`` may hold nothing else."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{what}: checkpoint missing keys {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    extra = sorted(set(sd) - set(own))
    if extra and not subset:
        raise KeyError(f"{what}: checkpoint has unexpected keys "
                       f"{extra[:8]}{' ...' if len(extra) > 8 else ''}")
    new = {}
    for k, t in own.items():
        v = torch.as_tensor(sd[k])
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{what}: {k} has shape {tuple(v.shape)} in "
                             f"the checkpoint, {tuple(t.shape)} in the "
                             f"module")
        new[k] = v.to(t.dtype)
    module.load_state_dict(new)
    return module


# ---------------------------------------------------------------------------
# the port's own train-state checkpoints
# ---------------------------------------------------------------------------

def train_state(trainer, generators: Optional[Dict[str, torch.Generator]]
                = None) -> Dict[str, Any]:
    """The state of a ``UDATrainer`` or ``AlignTrainer`` as a dict of
    tensors and plain values: parameters and statistics of each network,
    optimizer, step, and the states of the dropout
    generator and of ``generators``."""
    st = trainer.state
    gens = dict(generators or {})
    out: Dict[str, Any] = {"step": int(st.step),
                           "optimizer": st.optimizer.state_dict()}
    if hasattr(st, "student"):
        out.update(kind="uda", student=st.student.state_dict(),
                   teacher=st.teacher.state_dict(),
                   imnet=(None if st.imnet is None
                          else st.imnet.state_dict()))
        gens["dropout"] = trainer.dropout_gen
    else:
        out.update(kind="align", head=st.head.state_dict(),
                   backbone=st.backbone.state_dict())
    out["generators"] = {k: g.get_state() for k, g in gens.items()}
    return out


def load_train_state(trainer, ckpt: Mapping[str, Any],
                     generators: Optional[Dict[str, torch.Generator]]
                     = None) -> None:
    """Restore :func:`train_state` into ``trainer`` (and ``generators``)
    in place."""
    st = trainer.state
    gens = dict(generators or {})
    if ckpt["kind"] == "uda":
        st.student.load_state_dict(ckpt["student"])
        st.teacher.load_state_dict(ckpt["teacher"])
        if st.imnet is not None:
            st.imnet.load_state_dict(ckpt["imnet"])
        gens["dropout"] = trainer.dropout_gen
    else:
        st.head.load_state_dict(ckpt["head"])
        st.backbone.load_state_dict(ckpt["backbone"])
    st.optimizer.load_state_dict(ckpt["optimizer"])
    st.step = int(ckpt["step"])
    for k, g in gens.items():
        if k in ckpt["generators"]:
            g.set_state(ckpt["generators"][k])


_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def save_checkpoint(ckpt_dir: str, state: Dict[str, Any], step: int,
                    keep: int = 3, save_last: bool = True) -> str:
    """Write ``state`` as ``step_<step>.pt``; atomically re-point
    ``last``; prune.  Returns the file's path.

    Crash-safety (resume via ``last`` is the only recovery): the file is
    written under a temporary name and renamed; ``last`` is swapped by an
    atomic rename (a crash leaves either the old or the new target, never
    a missing or dangling link); pruning never removes the file ``last``
    points to, and ignores files that are not finished checkpoints.
    """
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step}.pt"
    path = os.path.join(ckpt_dir, name)
    tmp = os.path.join(ckpt_dir, f".{name}.tmp.{os.getpid()}")
    torch.save(state, tmp)
    os.replace(tmp, path)
    last = os.path.join(ckpt_dir, "last")
    if save_last:
        link = os.path.join(ckpt_dir, f".last.tmp.{os.getpid()}")
        if os.path.lexists(link):
            os.remove(link)
        os.symlink(name, link)
        os.replace(link, last)
    pinned = (os.path.basename(os.readlink(last))
              if os.path.islink(last) else None)
    steps = sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                os.listdir(ckpt_dir)) if m)
    for s in steps[:-keep] if keep > 0 else []:
        if f"step_{s}.pt" != pinned:
            os.remove(os.path.join(ckpt_dir, f"step_{s}.pt"))
    return path


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint of :func:`save_checkpoint` (``last`` or a step
    file, or the directory holding ``last``) onto the CPU."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        path = os.path.join(path, "last")
    return torch.load(os.path.realpath(path), map_location="cpu",
                      weights_only=True)
