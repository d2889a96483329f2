"""The optimizers and their learning-rate schedules (counterpart of
``refign_tpu/train/optim.py``): AdamW with warmup-poly for UDA, and Adam
with MultiStepLR for UAWarpC training.

UAWarpC (``make_adam_optimizer``): the JAX package chains
``add_decayed_weights(wd)``, ``scale_by_adam`` and the schedule, so the
decay is L2 added to the gradient before the moments, the order of
``torch.optim.Adam``'s ``weight_decay``; every parameter decays.  The
schedule is MultiStepLR counted in updates: base_lr * gamma^n, n the
milestones at or below the update count.

UDA:

The JAX package chains ``optax.scale_by_adam`` (eps outside the square
root, bias-corrected moments), ``add_decayed_weights(wd)`` and
``scale_by_learning_rate(schedule)`` per parameter group:
``p <- p - lr_t * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` with the
schedule read at the update count t = 0, 1, ...  ``torch.optim.AdamW`` does
the same update (its decoupled decay ``p <- p * (1 - lr * wd)`` uses the
same p), so the port uses it and sets each group's learning rate from the
schedule at the update count before every step.

Groups: head/backbone x weight/bias, backbone groups at
``backbone_lr_factor`` times the learning rate, no decay on parameters of
rank <= 1.  The schedule is the linear warmup + polynomial decay of each
group's OWN base rate with a shared ``min_lr`` floor, computed in fp32 as
the JAX schedule is.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["warmup_poly_lr", "param_group_label", "make_uda_optimizer",
           "WarmupPolyLR", "multistep_lr", "MultiStepLR",
           "make_adam_optimizer"]


def warmup_poly_lr(step: int, base_lr: float, max_steps: int,
                   warmup_iters: int = 1500, warmup_ratio: float = 1e-6,
                   power: float = 0.9, min_lr: float = 0.0) -> float:
    """LinearWarmupPolynomialLR at update count ``step`` (the JAX
    ``warmup_poly_schedule``, in fp32)."""
    f = np.float32
    step = f(step)
    if step < warmup_iters:
        warm_k = (f(1.0) - step / f(warmup_iters)) * f(1.0 - warmup_ratio)
        return float(f(base_lr) * (f(1.0) - warm_k))
    coeff = (f(1.0) - (step - f(warmup_iters))
             / f(float(max_steps - warmup_iters))) ** f(power)
    return float(f(base_lr - min_lr) * coeff + f(min_lr))


def param_group_label(name: str, p: torch.Tensor) -> str:
    """head/backbone x weight/bias: parameters of rank <= 1 (biases, norm
    scales) are 'bias' and take no weight decay."""
    kind = "backbone" if name.startswith("backbone") else "head"
    return kind + ("_bias" if p.dim() <= 1 else "_weight")


class WarmupPolyLR:
    """Sets every group's learning rate for update count ``step``: the
    warmup-poly schedule of the group's own base rate."""

    def __init__(self, optimizer: torch.optim.Optimizer, max_steps: int,
                 warmup_iters: int = 1500, warmup_ratio: float = 1e-6,
                 power: float = 0.9, min_lr: float = 0.0):
        self.optimizer = optimizer
        self.kw = dict(max_steps=max_steps, warmup_iters=warmup_iters,
                       warmup_ratio=warmup_ratio, power=power, min_lr=min_lr)

    def set_step(self, step: int) -> List[float]:
        lrs = []
        for g in self.optimizer.param_groups:
            g["lr"] = warmup_poly_lr(step, g["base_lr"], **self.kw)
            lrs.append(g["lr"])
        return lrs


def make_uda_optimizer(model: nn.Module, base_lr: float,
                       weight_decay: float, max_steps: int,
                       backbone_lr_factor: float = 0.1,
                       warmup_iters: int = 1500, power: float = 0.9,
                       warmup_ratio: float = 1e-6, min_lr: float = 0.0,
                       betas=(0.9, 0.999), eps: float = 1e-8
                       ) -> Tuple[torch.optim.AdamW, WarmupPolyLR]:
    """AdamW over ``model``'s trainable parameters in the 4 groups, and
    its schedule.  Each group keeps its ``label`` and ``base_lr``."""
    groups: Dict[str, List[torch.Tensor]] = {
        k: [] for k in ("head_weight", "head_bias", "backbone_weight",
                        "backbone_bias")}
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups[param_group_label(name, p)].append(p)
    param_groups = []
    for label, params in groups.items():
        if not params:
            continue
        factor = backbone_lr_factor if label.startswith("backbone") else 1.0
        param_groups.append(dict(
            params=params, label=label, base_lr=base_lr * factor,
            lr=base_lr * factor,
            weight_decay=0.0 if label.endswith("_bias") else weight_decay))
    opt = torch.optim.AdamW(param_groups, lr=base_lr, betas=betas, eps=eps)
    sched = WarmupPolyLR(opt, max_steps, warmup_iters=warmup_iters,
                         warmup_ratio=warmup_ratio, power=power,
                         min_lr=min_lr)
    return opt, sched


def multistep_lr(step: int, base_lr: float, milestones: Sequence[int],
                 gamma: float = 0.5) -> float:
    """MultiStepLR at update count ``step`` (the JAX
    ``multistep_schedule``, in fp32): base_lr * gamma^n, n the number of
    milestones <= step."""
    n = sum(int(step >= m) for m in milestones)
    f = np.float32
    return float(f(base_lr) * f(gamma ** n))


class MultiStepLR:
    """Sets every group's learning rate for update count ``step``."""

    def __init__(self, optimizer: torch.optim.Optimizer, base_lr: float,
                 milestones: Sequence[int], gamma: float = 0.5):
        self.optimizer = optimizer
        self.base_lr = base_lr
        self.milestones = tuple(milestones)
        self.gamma = gamma

    def set_step(self, step: int) -> float:
        lr = multistep_lr(step, self.base_lr, self.milestones, self.gamma)
        for g in self.optimizer.param_groups:
            g["lr"] = lr
        return lr


def make_adam_optimizer(params: Iterable[torch.Tensor], base_lr: float,
                        milestones: Sequence[int], gamma: float = 0.5,
                        weight_decay: float = 0.0, betas=(0.9, 0.999),
                        eps: float = 1e-8
                        ) -> Tuple[torch.optim.Adam, MultiStepLR]:
    """Adam with L2 ``weight_decay`` on every parameter, and MultiStepLR
    (uawarpc_stage{1,2}.yaml)."""
    opt = torch.optim.Adam(list(params), lr=base_lr, betas=betas, eps=eps,
                           weight_decay=weight_decay)
    return opt, MultiStepLR(opt, base_lr, milestones, gamma)
