"""Core NN layers on NHWC tensors, with the JAX package's numerics.

Counterpart of ``refign_tpu/nn/layers.py``.  Every layer takes and returns
NHWC (channels-last) tensors.  Parameters are created empty; the model that
owns them fills them from an explicit ``torch.Generator`` with the init
helpers below, or loads them (``utils/jax_convert.py``).

Numerics kept from the JAX package:

* ``TorchLayerNorm`` on bf16 folds the whole transform into one fp32 FMA
  (``y = x*s + t``), as ``refign_tpu/nn/layers.py:126-136`` does; without
  a gradient it is one launch of kernel K5.
* ``TorchBatchNorm`` keeps its running statistics in fp32 and, on bf16
  input, applies the fp32 fold ``y = x*a + b``
  (``refign_tpu/nn/layers.py:248-260``).  In train mode it normalises with
  the batch statistics (biased variance as E[x^2]-E[x]^2) and updates the
  running ones with the unbiased variance.  Inside a sharded pass of a
  process group (``parallel/mesh.py:sharded_pass``) it is sync-BN: the
  per-channel means of x and x^2 are averaged over the ranks (JAX's
  ``axis_name`` pmean) by a sum whose backward sums the gradients over the
  ranks, and the unbiased variance counts the global batch.  ``groups =
  G > 1`` normalises each of G row groups along axis 0 with its own
  statistics and gives the running ones the G updates in group order
  (``refign_tpu/nn/layers.py:157-220``): G serial calls in one, the
  folded UAWarpC step's three head passes.
* ``DropPath`` and ``Dropout2d`` draw from an explicit ``torch.Generator``
  passed to them in train mode, where a rate > 0 needs one; in a sharded
  pass they draw the global batch's masks and keep this rank's rows.
* :func:`remat_call` recomputes a module in the backward (non-reentrant
  checkpoint) and updates its BatchNorm running statistics once, in the
  forward, as JAX's ``nn.remat`` returns ``batch_stats`` once; sync-BN's
  recompute replays the forward's reduced statistics instead of reducing
  again.  ``policy="dots"`` keeps the outputs of the convolutions and of
  the matrix products without batch dimensions and recomputes the rest
  (JAX's ``dots_with_no_batch_dims_saveable``, which keeps only the
  products: the port keeps the convolutions too, cuDNN's share of the
  work).
* ``gelu`` is the exact erf form; ``leaky_relu`` has slope 0.1, as in
  the matching modules.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.dilated_dwconv import dilated_dwconv3x3
from ..ops.layer_norm import layer_norm, layer_norm_reference
from ..parallel import mesh

__all__ = [
    "gelu", "leaky_relu", "Linear", "TorchLayerNorm", "TorchBatchNorm",
    "TorchConv", "conv2d", "ConvBNReLU", "MLPEmbed", "DropPath", "Dropout2d",
    "normal_", "uniform_", "kaiming_normal_fanout_", "torch_default_init_",
    "init_convs_torch_default_", "init_convs_kaiming_fanout_",
    "grouped_bn", "remat_call", "REMAT_POLICIES",
]


# ---------------------------------------------------------------------------
# initializers drawing from an explicit generator (same rules as the JAX
# package's initializers; the numbers differ, as JAX keys and torch
# generators do)
# ---------------------------------------------------------------------------

def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator) * std)


def uniform_(t: torch.Tensor, bound: float,
             generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)


def kaiming_normal_fanout_(weight: torch.Tensor,
                           generator: torch.Generator,
                           groups: int = 1) -> None:
    """N(0, sqrt(2/fan_out)), fan_out = kh*kw*O/groups (OIHW weight)."""
    o, _, kh, kw = weight.shape
    normal_(weight, math.sqrt(2.0 / (kh * kw * o // groups)), generator)


def torch_default_init_(weight: torch.Tensor, bias: Optional[torch.Tensor],
                        generator: torch.Generator) -> None:
    """torch's Linear/Conv2d default: U(+-1/sqrt(fan_in)) for both."""
    fan_in = weight[0].numel()
    bound = 1.0 / math.sqrt(fan_in)
    uniform_(weight, bound, generator)
    if bias is not None:
        uniform_(bias, bound, generator)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch's default."""
    return F.gelu(x, approximate="none")


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    """LeakyReLU with the matching modules' slope 0.1
    (``refign_tpu/nn/layers.py:100-101``)."""
    return F.leaky_relu(x, negative_slope)


class Linear(nn.Module):
    """Dense layer over the last axis, ``weight`` (out, in) as in torch.

    Parameters start empty; the owning model initializes them."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class TorchLayerNorm(nn.Module):
    """LayerNorm over the last axis (``refign_tpu/nn/layers.py:105-141``).

    fp32: normalize, then affine.  bf16: one fp32 FMA ``x*s + t`` with
    ``s = rsqrt(var+eps)*scale`` and ``t = bias - mean*rsqrt(var+eps)*scale``
    (variance as E[x^2]-E[x]^2, clamped at 0), then a cast to bf16
    (``ops/layer_norm.py``): in one launch of K5 where no gradient flows,
    else as the composite of torch ops that autograd differentiates.
    """

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def _takes_kernel(self, x: torch.Tensor) -> bool:
        """K5 normalises bf16 x where no gradient flows."""
        return x.dtype == torch.bfloat16 and not (
            torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, self.weight, self.bias)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._takes_kernel(x):
            return layer_norm(x.contiguous(), self.weight, self.bias,
                              self.eps)
        if x.dtype == torch.bfloat16:
            return layer_norm_reference(x, self.weight, self.bias, self.eps)
        x32 = x.float()
        w = self.weight.float()
        b = self.bias.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * w + b).to(x.dtype)


class TorchBatchNorm(nn.Module):
    """BatchNorm2d on NHWC (``refign_tpu/nn/layers.py:144-264``): the
    running statistics in eval mode, the batch's in train mode.  Running
    stats stay fp32 whatever the parameter dtype.  In train mode the
    statistics are over (N, H, W) in fp32, the variance E[x^2]-E[x]^2,
    and the running stats take ``(1-m)*ra + m*stat`` with the unbiased
    variance; ``update_stats = False`` keeps them as they are (the EMA
    teacher's batch-statistics forward, whose updates the JAX step
    discards).  ``groups`` G > 1 (train mode): axis 0 holds G calls' rows,
    group by group; each group takes its own statistics, and the running
    stats the G updates in group order."""

    momentum = 0.1

    def __init__(self, num_features: int, eps: float = 1e-5,
                 groups: int = 1):
        super().__init__()
        self.eps = eps
        self.groups = groups
        self.update_stats = True
        # remat_call's bookkeeping of the reduced statistics: recorded in
        # the forward (into every active, possibly nested, call's list),
        # replayed by the recompute
        self.sync_records: list = []
        self.sync_replay: Optional[list] = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _synced(self, mean: torch.Tensor, mean_sq: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The means of x and x^2 ((C,) or (G, C)) averaged over the ranks
        (every rank's share has the same count)."""
        cached = self.sync_replay.pop(0) if self.sync_replay else None
        total = mesh.sum_over_ranks(torch.stack([mean, mean_sq]), cached)
        for record in self.sync_records:
            record.append(total.detach())
        total = total / mesh.world_size()
        return total[0], total[1]

    def _batch_stats(self, xs: torch.Tensor, G: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-channel statistics of the fp32 input: (C,) each for one
        group, (G, C) for xs (G, N/G, ..., C) of G groups."""
        lead = 0 if G == 1 else 1
        n = xs.numel() // (G * xs.shape[-1])
        sync = mesh.reducing()
        if sync:
            n *= mesh.world_size()
        if n < 2:
            # torch.nn.BatchNorm2d's rule: one value has no variance
            raise ValueError(f"BatchNorm in train mode needs more than one "
                             f"value per channel, got input "
                             f"{tuple(xs.shape)} in {G} groups")
        axes = tuple(range(lead, xs.dim() - 1))
        mean = xs.mean(axes)
        mean_sq = (xs * xs).mean(axes)
        if sync:
            mean, mean_sq = self._synced(mean, mean_sq)
        var = mean_sq - mean.square()
        if self.update_stats:
            m = self.momentum
            with torch.no_grad():
                unbiased = var * (n / (n - 1))
                ra_m, ra_v = self.running_mean, self.running_var
                # one update a group, in group order
                for mg, vg in ([(mean, unbiased)] if G == 1
                               else zip(mean, unbiased)):
                    ra_m = (1 - m) * ra_m + m * mg
                    ra_v = (1 - m) * ra_v + m * vg
                self.running_mean.copy_(ra_m)
                self.running_var.copy_(ra_v)
        return mean, var

    def _fold(self, mean: torch.Tensor, var: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The bf16 arm's per-channel fp32 ``a``, ``c`` of ``x*a + c``."""
        a = self.weight.float() * torch.rsqrt(var + self.eps)
        return a, self.bias.float() - mean * a

    def eval_fold(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``a``, ``c`` of the eval-mode bf16 arm, for a kernel that
        applies them itself (``ops.dilated_dwconv``)."""
        return self._fold(self.running_mean.float(),
                          self.running_var.float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        G = self.groups if self.training else 1
        if G > 1:
            if x.shape[0] % G:
                raise ValueError(f"BatchNorm of {G} groups got {x.shape[0]} "
                                 f"rows")
            x32 = x32.unflatten(0, (G, x.shape[0] // G))
        if self.training:
            mean, var = self._batch_stats(x32, G)
            if G > 1:  # (G, 1, ..., 1, C): each group's per-channel values
                bshape = (G,) + (1,) * (x.dim() - 1) + (x.shape[-1],)
                mean, var = mean.reshape(bshape), var.reshape(bshape)
        else:
            mean = self.running_mean.float()
            var = self.running_var.float()
        if x.dtype == torch.bfloat16:
            a, c = self._fold(mean, var)
            y = x32 * a + c
        else:
            w = self.weight.float()
            b = self.bias.float()
            y = (x32 - mean) * torch.rsqrt(var + self.eps) * w + b
        return (y if G == 1 else y.flatten(0, 1)).to(x.dtype)


@contextlib.contextmanager
def _bn_groups(bns, groups):
    """Within the block, the BatchNorm layers ``bns`` take ``groups``
    (one value each)."""
    saved = [m.groups for m in bns]
    for m, g in zip(bns, groups):
        m.groups = g
    try:
        yield
    finally:
        for m, g in zip(bns, saved):
            m.groups = g


def grouped_bn(module: nn.Module, groups: int):
    """Within the block, every BatchNorm of ``module`` normalises ``groups``
    row groups, each on its own statistics (the JAX step's
    ``head.clone(bn_groups=...)``)."""
    bns = [m for m in module.modules() if isinstance(m, TorchBatchNorm)]
    return _bn_groups(bns, [groups] * len(bns))


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class TorchConv(nn.Module):
    """torch.nn.Conv2d on NHWC tensors, OIHW ``weight``.

    An NHWC-contiguous tensor permuted to NCHW is an NCHW tensor in
    channels_last memory format, so ``F.conv2d`` runs on that view and the
    result is permuted back without a copy."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int]] = 0,
                 dilation: Union[int, Tuple[int, int]] = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                     self.stride, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


def conv2d(in_channels: int, out_channels: int,
           kernel_size: Union[int, Tuple[int, int]] = 3,
           stride: Union[int, Tuple[int, int]] = 1,
           padding: Union[int, Tuple[int, int]] = 0,
           dilation: Union[int, Tuple[int, int]] = 1,
           groups: int = 1, bias: bool = True) -> TorchConv:
    """torch.nn.Conv2d equivalent on NHWC (see TorchConv)."""
    return TorchConv(in_channels, out_channels, kernel_size, stride, padding,
                     dilation, groups, bias)


def init_convs_torch_default_(module: nn.Module,
                              generator: torch.Generator) -> None:
    """torch's Conv2d default on every conv of ``module``, in module order:
    U(+-1/sqrt(fan_in)) weight and bias (the JAX ``TorchConv`` default,
    ``refign_tpu/nn/layers.py:40-55``); BN keeps ones/zeros."""
    for m in module.modules():
        if isinstance(m, TorchConv):
            torch_default_init_(m.weight, m.bias, generator)


def init_convs_kaiming_fanout_(module: nn.Module,
                               generator: torch.Generator) -> None:
    """Kaiming-normal fan-out (relu) weight and zero bias on every conv of
    ``module`` (the VGG init, ``refign_tpu/models/vgg.py:23-24``)."""
    for m in module.modules():
        if isinstance(m, TorchConv):
            kaiming_normal_fanout_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


class ConvBNReLU(nn.Module):
    """conv (+ BN) (+ activation), with the depthwise-separable option
    (``refign_tpu/nn/layers.py:394-448``).  Padding defaults to
    ``dilation*(kernel_size-1)//2``; bias 'auto' means bias iff no norm.

    A depthwise 3x3 conv with stride 1, padding = dilation and no bias runs
    through ``ops.dilated_dwconv`` (K4 on the card), which also applies an
    eval-mode BatchNorm and ReLU where no gradient flows and x is bf16;
    elsewhere the BatchNorm and activation follow the conv as they do for
    every other conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 groups: int = 1, padding: Optional[int] = None,
                 use_norm: bool = True,
                 activation: Optional[Callable] = F.relu,
                 bias: Union[str, bool] = "auto",
                 depthwise_separable: bool = False):
        super().__init__()
        if padding is None:
            padding = dilation * (kernel_size - 1) // 2
        self.activation = activation
        self.depthwise_separable = depthwise_separable
        if depthwise_separable:
            if kernel_size <= 1 or groups != 1:
                raise ValueError("depthwise_separable needs kernel_size > 1 "
                                 "and groups == 1")
            self.depthwise_conv = ConvBNReLU(
                in_channels, in_channels, kernel_size, stride, dilation,
                groups=in_channels, padding=padding, use_norm=use_norm,
                activation=activation)
            self.pointwise_conv = ConvBNReLU(
                in_channels, out_channels, 1, use_norm=use_norm,
                activation=activation)
            return
        use_bias = (not use_norm) if bias == "auto" else bool(bias)
        self.conv = conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, dilation, groups, use_bias)
        self.bn = TorchBatchNorm(out_channels) if use_norm else None
        # a depthwise 3x3, stride 1, "same" padding and no bias (the
        # DAFormer ASPP's dilated branches) runs on K4
        self.dilated_dw = (groups == in_channels == out_channels
                           and kernel_size == 3 and stride == 1
                           and padding == dilation and not use_bias)

    def _fuses_bn_relu(self, x: torch.Tensor) -> bool:
        """K4 applies the BatchNorm and ReLU itself where the BatchNorm
        is in eval mode on bf16 (its x*a + c arm), the activation is ReLU
        and no gradient flows."""
        if (self.bn is None or self.bn.training
                or self.activation is not F.relu
                or x.dtype != torch.bfloat16):
            return False
        return not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, self.conv.weight, self.bn.weight,
                                      self.bn.bias)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.depthwise_separable:
            return self.pointwise_conv(self.depthwise_conv(x))
        if self.dilated_dw:
            d = self.conv.dilation[0]
            if self._fuses_bn_relu(x):
                return dilated_dwconv3x3(x, self.conv.weight, d,
                                         self.bn.eval_fold())
            x = dilated_dwconv3x3(x, self.conv.weight, d)
        else:
            x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.activation is not None:
            x = self.activation(x)
        return x

    def init_weights(self, generator: torch.Generator) -> None:
        """mmseg ConvModule init: kaiming fan_out (relu) conv, zero bias,
        BN ones/zeros (``refign_tpu/models/heads/daformer.py:20-23``)."""
        init_convs_kaiming_fanout_(self, generator)


class MLPEmbed(nn.Module):
    """Per-pixel linear embedding, NHWC in and out
    (``refign_tpu/nn/layers.py:451-466``)."""

    def __init__(self, in_channels: int, embed_dim: int):
        super().__init__()
        self.proj = Linear(in_channels, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)

    def init_weights(self, generator: torch.Generator) -> None:
        torch_default_init_(self.proj.weight, self.proj.bias, generator)


def _keep_mask(x: torch.Tensor, shape, rate: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """0/1 keep draws with probability 1 - rate, in x's dtype; in a
    sharded pass this rank's rows of the global batch's draws."""
    if generator is None:
        raise ValueError(f"dropout at rate {rate} in train mode draws from "
                         f"an explicit generator and none was passed; put "
                         f"the module in eval mode to turn it off")
    keep = torch.empty((mesh.draw_rows(shape[0]),) + tuple(shape[1:]),
                       device=x.device)
    keep = keep.bernoulli_(1.0 - rate, generator=generator)
    return mesh.own_rows(keep, shape[0]).to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth (``refign_tpu/nn/layers.py:469-481``):
    ``x * keep / keep_prob`` with one keep draw per sample from the
    generator passed, in train mode (where a rate > 0 needs one); the
    identity in eval mode."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def mask(self, x: torch.Tensor,
             generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
        """The keep draws for ``x`` ((B, 1, ..., 1), x's dtype), or None
        where the path is the identity."""
        if not self.training or self.drop_prob == 0.0:
            return None
        return _keep_mask(x, (x.shape[0],) + (1,) * (x.dim() - 1),
                          self.drop_prob, generator)

    def apply_mask(self, x: torch.Tensor,
                   keep: Optional[torch.Tensor]) -> torch.Tensor:
        if keep is None:
            return x
        return x * keep / (1.0 - self.drop_prob)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.apply_mask(x, self.mask(x, generator))


class Dropout2d(nn.Module):
    """Channel-wise dropout on NHWC (``refign_tpu/nn/layers.py:484-496``):
    one keep draw per (sample, channel) from the generator passed,
    ``x * keep / keep_prob``, in train mode (where a rate > 0 needs one);
    the identity in eval mode."""

    def __init__(self, rate: float = 0.1):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = _keep_mask(x, (x.shape[0], 1, 1, x.shape[-1]), self.rate,
                          generator)
        return x * keep / (1.0 - self.rate)


@contextlib.contextmanager
def _recording(bns, records: dict):
    """Within the block, the BatchNorm layers ``bns`` also record the
    statistics they reduce over the ranks into ``records`` (a
    ``remat_call`` nested in another records into both)."""
    for m in bns:
        m.sync_records.append(records.setdefault(m, []))
    try:
        yield
    finally:
        for m in bns:
            m.sync_records.pop()


@contextlib.contextmanager
def _replaying(bns, records: dict):
    """Within the block, the BatchNorm layers ``bns`` leave their running
    statistics as they are and take the statistics ``records`` holds
    instead of reducing them over the ranks again."""
    saved = [(m.update_stats, m.sync_replay) for m in bns]
    for m in bns:
        m.update_stats = False
        m.sync_replay = list(records.get(m, ()))
    try:
        yield
    finally:
        for m, (flag, replay) in zip(bns, saved):
            m.update_stats = flag
            m.sync_replay = replay


# the ops whose outputs a "dots" recompute keeps (aten's forms of F.conv2d
# and of F.linear on one matrix: a product with batch dimensions is bmm)
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.aten.convolution.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


# remat_call's policies: None recomputes the whole call; "dots" keeps the
# convolutions' and the batch-free matrix products' outputs
REMAT_POLICIES = (None, "dots")


def remat_call(module: nn.Module, *args, policy: Optional[str] = None,
               params: Optional[Dict[str, torch.Tensor]] = None):
    """``module(*args)`` recomputed in the backward (non-reentrant
    checkpoint).  The module's current parameters, which under
    ``torch.func.functional_call`` are the caller's cast copies, are passed
    as inputs, so the recompute, which runs after that call has returned,
    uses the same tensors and their gradients reach the caller.  The
    recompute leaves BatchNorm running statistics alone: train-mode BN
    updates them in its forward, and a second update would count the
    batch twice.  The recompute runs in the sharded pass of the call
    (``parallel/mesh.py``), and sync-BN's recompute replays the statistics
    its forward reduced over the ranks: no second collective; it also
    keeps the BatchNorm groups of the call (``grouped_bn``).
    ``policy="dots"`` keeps the outputs of the convolutions and of the
    matrix products without batch dimensions from the forward and
    recomputes everything else, hand-written kernels included (selective
    checkpointing).  ``params`` (by name, every parameter of the module):
    run on these tensors instead (a cast made by the caller,
    ``parallel/mesh.py:cast_params``)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r} (known: "
                         f"{REMAT_POLICIES})")
    names, values = zip(*(params or dict(module.named_parameters())).items())
    n = len(args)
    bns = [m for m in module.modules() if isinstance(m, TorchBatchNorm)]
    records: dict = {}
    block = mesh.pass_block()
    # the recompute runs with the BatchNorm groups of the call
    groups = [m.groups for m in bns]
    calls = []

    def run(*a):
        ctx = (_replaying(bns, records) if calls
               else _recording(bns, records))
        calls.append(None)
        with ctx, _bn_groups(bns, groups), mesh.resume_pass(block):
            return functional_call(module, dict(zip(names, a[n:])), a[:n])

    kw = {}
    if policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _dots_policy)
    return checkpoint(run, *args, *values, use_reentrant=False, **kw)
