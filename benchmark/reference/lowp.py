"""The control's precision: the plain reference with the inputs of every
matrix product and convolution rounded to float8 (e4m3, one scale per
tensor that maps its largest magnitude to 448), the step below the
configurations' bfloat16.  The products themselves and everything else
stay fp32.  Gradients pass the rounding unchanged (straight through)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

F8_MAX = 448.0


class _RoundF8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().float().clamp_min(1e-30)
        scale = F8_MAX / amax
        q = (x.float() * scale).to(torch.float8_e4m3fn).float() / scale
        return q.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def round_f8(x):
    if isinstance(x, torch.Tensor) and x.is_floating_point() \
            and x.numel() > 0:
        return _RoundF8.apply(x)
    return x


_PRODUCTS = {F.linear, F.conv2d, torch.conv2d, torch.matmul, torch.bmm,
             torch.mm, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.bmm, torch.Tensor.mm}


class Float8Products(TorchFunctionMode):
    """Within the block, round the two operands of each product to fp8."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = (round_f8(args[0]), round_f8(args[1])) + tuple(args[2:])
            if "weight" in kwargs:
                kwargs = dict(kwargs, weight=round_f8(kwargs["weight"]))
        elif func is torch.einsum:
            args = (args[0],) + tuple(round_f8(a) for a in args[1:])
        return func(*args, **kwargs)
