"""Data parallelism over ``torch.distributed`` and the precision policy
helpers (counterpart of ``refign_tpu/parallel/mesh.py``).

One process per card.  JAX gets its global-batch semantics from pjit over
a 1-D mesh; here every global reduction is an explicit collective, and the
collectives are ``all_reduce`` and ``broadcast`` only: gloo takes CUDA
tensors for these two and for nothing else, so a gloo group of ranks on one
card runs exactly the code that NCCL runs on many.  A gather of rows is an
``all_reduce(SUM)`` of a zero-filled buffer in which each rank wrote its
own rows (adding zeros is exact); a barrier is an ``all_reduce`` of one
element.

The counterparts of the JAX helpers:

* :func:`init_distributed` (``make_mesh``) reads the launcher's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) and creates the process group: NCCL on the card (rank r
  on ``cuda:LOCAL_RANK``), gloo on the CPU, or the backend the caller
  names.  NCCL failing to initialise raises;
* :func:`shard_batch` keeps this rank's rows of every array whose leading
  axis the world size divides and the whole of the others (JAX replicates
  those); :func:`shard_of` says which rows a rank holds;
* :func:`replicate` broadcasts parameters and buffers from rank 0;
* :class:`compute_mesh`, :func:`active_mesh` and :func:`shard_rows` spread
  the row stacks of an evaluation forward over the ranks and reassemble
  the result on every rank (:func:`gather_rows`).

A train pass over rows that are sharded runs inside :func:`sharded_pass`:
there BatchNorm takes its statistics over the ranks (sync-BN) and dropout
draws the global batch's masks and keeps its rows, so that the mean over
the ranks of the per-rank losses, which the averaged gradients follow, is
the single process's loss on the global batch.  Without a process group
every helper is the identity and nothing changes.

Two ways to run a module in a compute dtype:

* :func:`cast_floating` casts the parameters themselves, in place: the
  frozen inference and alignment networks hold bf16 parameters;
* :func:`apply_cast` runs a module on bf16 COPIES of its fp32 master
  parameters through ``torch.func.functional_call``: the cast is part of
  the graph, so gradients reach the fp32 masters in fp32 (the train step's
  bf16 compute, ``refign_tpu/uda/trainer.py:140-142``).
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

__all__ = ["init_distributed", "destroy_distributed", "world_size", "rank",
           "is_main", "process_device", "all_reduce_sum", "all_reduce_max",
           "barrier", "gather_rows", "mean_over_ranks",
           "masked_mean", "sum_over_ranks", "shard_of", "batch_rows",
           "shard_batch", "check_world_divides", "replicate",
           "reduce_gradients", "max_param_divergence", "sharded_pass",
           "reducing", "pass_block", "resume_pass", "draw_rows", "own_rows",
           "compute_mesh", "active_mesh",
           "row_share", "shard_rows", "cast_floating", "cast_params",
           "apply_cast"]

# the device this process's collectives run on (set by init_distributed)
_DEVICE: List[Optional[torch.device]] = [None]


def init_distributed(device="cuda", backend: Optional[str] = None,
                     env: Optional[Mapping[str, str]] = None
                     ) -> Tuple[int, int, torch.device]:
    """Create the process group from the launcher's environment (``env``,
    default ``os.environ``) and return ``(rank, world, device)``.

    Without ``WORLD_SIZE`` in the environment there is no group: rank 0 of
    1 on ``device``.  ``device`` 'cuda' puts rank r on ``cuda:LOCAL_RANK``
    (a device with an index is taken as it is); the backend is NCCL on
    the card and gloo on the CPU unless ``backend`` names one.  A group
    that exists already is reused."""
    env = os.environ if env is None else env
    dev = torch.device(device)
    if "WORLD_SIZE" not in env:
        return 0, 1, dev
    world = int(env["WORLD_SIZE"])
    r = int(env.get("RANK", 0))
    local = int(env.get("LOCAL_RANK", r))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the process group; pass "
                               "--device cpu to run it on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        addr = env.get("MASTER_ADDR", "localhost")
        port = env.get("MASTER_PORT", "29500")
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                rank=r, world_size=world)
    _DEVICE[0] = dev
    return dist.get_rank(), dist.get_world_size(), dev


def destroy_distributed() -> None:
    """Destroy the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE[0] = None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0, or a process without a group: the one that writes files."""
    return rank() == 0


def process_device() -> torch.device:
    """The device of this process's collectives (the CPU without a
    group)."""
    return _DEVICE[0] or torch.device("cpu")


# ---------------------------------------------------------------------------
# collectives (all_reduce and broadcast only)
# ---------------------------------------------------------------------------

def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, as a new tensor (``t`` itself
    without a group)."""
    if not dist.is_initialized():
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the ranks (bool as uint8)."""
    if not dist.is_initialized():
        return t
    out = t.detach().to(torch.uint8 if t.dtype == torch.bool else t.dtype,
                        copy=True)
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out.to(t.dtype)


def barrier() -> None:
    """Wait for every rank: an ``all_reduce`` of one element on this
    process's device."""
    if dist.is_initialized():
        dist.all_reduce(torch.zeros(1, device=process_device()))


def gather_rows(x: torch.Tensor, n: int, start: int) -> torch.Tensor:
    """Rows ``start:start + len(x)`` of an ``n``-row array from every rank,
    reassembled on every rank: each writes its rows into a zero-filled
    buffer and the buffers are summed (exact: the other ranks add zeros).
    The ranks' rows must not overlap."""
    if not dist.is_initialized():
        return x
    buf = x.new_zeros((n,) + tuple(x.shape[1:]))
    buf[start:start + x.shape[0]] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf


class _RankSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the gradients over the ranks
    (the gradient of the sum of every rank's loss).  ``cached``: the
    forward's value, given when a remat recompute replays it (no second
    collective)."""

    @staticmethod
    def forward(ctx, x, cached):
        if cached is not None:
            return cached.clone()
        return all_reduce_sum(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous()), None


def sum_over_ranks(x: torch.Tensor,
                   cached: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks (``x`` without a
    group)."""
    if not dist.is_initialized():
        return x
    return _RankSum.apply(x, cached)


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The mean of a value over the ranks (not differentiable).  A mean
    over a rank's equal share of a batch becomes the global mean; a value
    every rank holds alike stays as it is.  Identity without a group."""
    if not dist.is_initialized():
        return t
    return all_reduce_sum(t) / world_size()


def masked_mean(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """This rank's share of the global masked mean sum(num) / sum(den)
    over the ranks: ``world * num / sum(den)``, whose mean over the ranks
    (what averaged gradients follow) is the global mean; ``num / den``
    without a group.  ``den`` is clamped at 1."""
    return num * world_size() / all_reduce_sum(den).clamp_min(1.0)


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------

def shard_of(n: int) -> Optional[slice]:
    """This rank's rows of a global axis of ``n`` rows, or None where the
    rank holds all of them: no group, or a world size that does not divide
    ``n`` (the array is held whole, as JAX's ``shard_batch`` replicates
    it)."""
    if not dist.is_initialized():
        return None
    w = world_size()
    if n % w:
        return None
    b = n // w
    return slice(rank() * b, (rank() + 1) * b)


def _rows_of(v) -> Optional[int]:
    if isinstance(v, torch.Tensor):
        return v.shape[0] if v.dim() > 0 else None
    if isinstance(v, (list, tuple)):
        return len(v)
    return None


def batch_rows(batch: Mapping[str, Any]) -> Dict[str, int]:
    """The leading-axis length of every array (and list) of a batch."""
    return {k: n for k, v in batch.items()
            if (n := _rows_of(v)) is not None}


def shard_batch(batch: Mapping[str, Any]) -> Dict[str, Any]:
    """This rank's rows of every array whose leading axis the world size
    divides, and the whole of the others (the batch itself without a
    group)."""
    out = {}
    for k, v in batch.items():
        n = _rows_of(v)
        sl = None if n is None else shard_of(n)
        out[k] = v if sl is None else v[sl]
    return out


def check_world_divides(dims: Iterable[int]) -> None:
    """Raise unless the world size divides every batch axis in ``dims``,
    naming the largest world size that would (JAX sizes its mesh by that
    gcd; a launcher's world size is the user's explicit choice)."""
    dims = list(dims)
    w = world_size()
    bad = [d for d in dims if d % w]
    if bad:
        g = 0
        for d in dims:
            g = math.gcd(g, d)
        raise ValueError(
            f"world size {w} does not divide the batch axes {dims} "
            f"({bad} do not divide); the largest world size that divides "
            f"them all is {g}")


# ---------------------------------------------------------------------------
# parameters and gradients
# ---------------------------------------------------------------------------

def _tensors_of(modules) -> List[torch.Tensor]:
    if isinstance(modules, nn.Module):
        modules = [modules]
    out = []
    for m in modules:
        if m is None:
            continue
        out += [p.data for p in m.parameters()]
        out += [b for b in m.buffers()]
    return out


def replicate(modules) -> None:
    """Every parameter and buffer of ``modules`` (a module or a list) set
    to rank 0's values."""
    if not dist.is_initialized():
        return
    for t in _tensors_of(modules):
        dist.broadcast(t, 0)


def _buckets(tensors: Sequence[torch.Tensor], limit: int = 1 << 24):
    bucket, size = [], 0
    for t in tensors:
        if bucket and (size + t.numel() > limit
                       or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        yield bucket


def reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each gradient by its mean over the ranks: one
    ``all_reduce(SUM)`` per flat bucket of up to 16M elements, then a
    division by the world size.  A parameter without a gradient has none
    on any rank (the ranks run the same graph) and is skipped."""
    if not dist.is_initialized():
        return
    w = world_size()
    grads = [p.grad for p in params if p.grad is not None]
    for bucket in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat /= w
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def max_param_divergence(modules) -> float:
    """The largest |x - x on rank 0| over every parameter and buffer of
    ``modules``, the maximum over the ranks (0.0 without a group)."""
    if not dist.is_initialized():
        return 0.0
    worst = torch.zeros((), dtype=torch.float64, device=process_device())
    for t in _tensors_of(modules):
        if not t.is_floating_point():
            t = t.double()
        ref = t.detach().clone()
        dist.broadcast(ref, 0)
        d = (t.detach() - ref).abs().max().double() if t.numel() else None
        if d is not None:
            worst = torch.maximum(worst, d.to(worst.device))
    return float(all_reduce_max(worst))


# ---------------------------------------------------------------------------
# sharded train passes: sync-BN and global-batch draws
# ---------------------------------------------------------------------------

# the rows of one batch block a rank holds in the active sharded pass, or
# None outside one
_PASS_ROWS: List[Optional[int]] = [None]


@contextlib.contextmanager
def sharded_pass(rows: Optional[slice]):
    """Within the block, a pass over this rank's ``rows`` of the global
    batch: BatchNorm reduces its statistics over the ranks and dropout
    draws the global batch's masks.  ``rows`` None (no group, or rows held
    whole): a pass on the rank's own data, as in one process."""
    prev = _PASS_ROWS[0]
    _PASS_ROWS[0] = (None if rows is None or not dist.is_initialized()
                     else rows.stop - rows.start)
    try:
        yield
    finally:
        _PASS_ROWS[0] = prev


def reducing() -> bool:
    """True inside a sharded pass of a process group."""
    return _PASS_ROWS[0] is not None


def pass_block() -> Optional[int]:
    """The active sharded pass's rows a block, or None (for
    :func:`resume_pass`)."""
    return _PASS_ROWS[0]


@contextlib.contextmanager
def resume_pass(block: Optional[int]):
    """Within the block, the sharded pass that :func:`pass_block` read
    (a remat recompute, which runs in the backward, outside the pass)."""
    prev = _PASS_ROWS[0]
    _PASS_ROWS[0] = block
    try:
        yield
    finally:
        _PASS_ROWS[0] = prev


def draw_rows(n: int) -> int:
    """How many rows a per-row random draw of a pass over ``n`` local rows
    takes: the global batch's inside a sharded pass, else ``n``."""
    b = _PASS_ROWS[0]
    if b is None:
        return n
    if n % b:
        raise ValueError(f"a sharded pass of {b} rows a block got {n} rows")
    return n * world_size()


def own_rows(draw: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's ``n`` rows of a per-row draw made for the global batch
    (:func:`draw_rows`).  A pass's rows are blocks of the batch (HRDA's LR
    rows, then its HR crops); each rank keeps its rows of each block."""
    b = _PASS_ROWS[0]
    if b is None:
        return draw
    blocks = draw.unflatten(0, (n // b, world_size(), b))
    return blocks[:, rank()].flatten(0, 1)


# ---------------------------------------------------------------------------
# evaluation row spread
# ---------------------------------------------------------------------------

_SPREAD: List[bool] = [False]


class compute_mesh:
    """Context manager spreading the row stacks of evaluation forwards
    (:func:`shard_rows`) over the ranks of the process group, when there
    is one."""

    def __enter__(self):
        self._prev = _SPREAD[0]
        _SPREAD[0] = dist.is_initialized()
        return _SPREAD[0]

    def __exit__(self, *exc):
        _SPREAD[0] = self._prev
        return False


def active_mesh() -> bool:
    """Whether evaluation rows are spread over the ranks here."""
    return _SPREAD[0]


def row_share(n: int) -> Tuple[int, int]:
    """This rank's contiguous share ``[lo, hi)`` of ``n`` rows (sizes
    differ by at most one; a share may be empty)."""
    w, r = world_size(), rank()
    return r * n // w, (r + 1) * n // w


def shard_rows(fn: Callable[[torch.Tensor], torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for a row-wise ``fn`` (an eval forward): under an active
    :class:`compute_mesh` each rank runs its share of the rows and
    :func:`gather_rows` reassembles the result on every rank; ``fn(x)``
    otherwise.  A rank with no rows runs one for the result's shape and
    contributes nothing."""
    if not _SPREAD[0]:
        return fn(x)
    n = x.shape[0]
    lo, hi = row_share(n)
    y = fn(x[lo:hi] if hi > lo else x[:1])
    return gather_rows(y[:hi - lo], n, lo)


# ---------------------------------------------------------------------------
# precision policy
# ---------------------------------------------------------------------------

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
