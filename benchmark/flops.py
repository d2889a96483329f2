"""Model operations of a step, counted once per cell by
``torch.utils.flop_counter.FlopCounterMode`` over the benchmark's own
frozen plain model on the ``meta`` device, at the cell's shapes: the
products and convolutions of the forward (and of the backward, where the
step trains).  The plain model recomputes nothing, so the count is the
model's work whatever implements the step (the port's remat recomputes
part of its forward in the backward, which the count leaves out)."""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import FlopCounterMode


def count(fn: Callable[[], None]) -> float:
    """The products and convolutions ``fn`` runs."""
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def backward_of(outputs) -> None:
    """Run the backward of a forward's outputs (any nesting of tensors)."""
    flat = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            if o.requires_grad:
                flat.append(o)
        elif isinstance(o, (list, tuple)):
            for x in o:
                walk(x)
    walk(outputs)
    torch.autograd.backward(flat, [torch.ones_like(t) for t in flat])
