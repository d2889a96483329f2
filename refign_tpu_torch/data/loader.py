"""Batching, collation and prefetch on ``torch.utils.data`` (counterpart of
``refign_tpu/data/loader.py``).

Each item of the torch ``Dataset`` here is a WHOLE batch: the sampler
yields ``(seed, epoch, b, indices)`` and a worker reseeds ``random`` and
``np.random`` from ``(seed * 1000003 + epoch * 8191 + b) mod 2**32``, then
loads and collates the batch (the JAX loader's ``_worker_batch``).  Batches
come in the JAX loader's order (``random.Random(seed + epoch).shuffle``,
then ``drop_last``), so a batch depends neither on the number of workers
nor on which worker made it, and equals the JAX loader's process-mode
batch.  With no workers the batch is made in the calling process between a
save and a restore of both global generators, so the caller's own draws
(the drop-half coin) are the same as with workers.

The JAX loader's ``thread`` mode (a TPU-host workaround that draws from
the shared global generators) is not ported.

Workers are forked and never touch CUDA: datasets hold host memory only.
On the card the loader pins its batches (``pin_memory``), and
:class:`DevicePrefetcher` copies the next batch to the card on a side
stream while the current step runs; the step's stream waits on the copy's
event before it reads the batch.

Collation stacks numpy arrays and hands them out as CPU tensors; the
ragged correspondence arrays ('corr_pts', 'corr_pts_ref') stay lists of
numpy arrays and the file names lists of strings.
"""
from __future__ import annotations

import queue
import random as pyrandom
import threading
from typing import Any, Callable, Dict, Iterator, List

import numpy as np
import torch
import torch.utils.data as tud

RAGGED_KEYS = ("corr_pts", "corr_pts_ref")


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The JAX package's ``collate``: numpy arrays stacked, numbers to one
    array, ragged keys and anything else kept as lists."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key in RAGGED_KEYS:
            out[key] = [np.asarray(v) for v in vals]
        elif isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals  # e.g. filenames
    return out


def batch_seed(seed: int, epoch: int, b: int) -> int:
    """The per-batch seed of both host generators."""
    return (seed * 1000003 + epoch * 8191 + b) % (2 ** 32)


def _as_tensors(batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                and v.dtype != object else v) for k, v in batch.items()}


class _BatchDataset(tud.Dataset):
    """torch view of a map-style dataset whose items are whole batches,
    addressed by ``(seed, epoch, b, indices)``."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getitem__(self, task):
        seed, epoch, b, idxs = task
        in_main = tud.get_worker_info() is None
        if in_main:
            saved = pyrandom.getstate(), np.random.get_state()
        mix = batch_seed(seed, epoch, b)
        pyrandom.seed(mix)
        np.random.seed(mix)
        try:
            return _as_tensors(collate([self.dataset[i] for i in idxs]))
        finally:
            if in_main:
                pyrandom.setstate(saved[0])
                np.random.set_state(saved[1])


class _EpochSampler(tud.Sampler):
    """Yields the tasks of the loader's current epoch."""

    def __init__(self):
        self.tasks: List[tuple] = []

    def __len__(self):
        return len(self.tasks)

    def __iter__(self):
        return iter(self.tasks)


def _identity(batch):
    return batch


class DataLoader:
    """Map-style loader: shuffle, batch, drop_last, worker processes.

    One ``torch.utils.data.DataLoader`` with ``batch_size=None`` over
    :class:`_BatchDataset`; its workers persist across epochs.  Batches
    are pinned for the copy to the card where there is one.  Call
    :meth:`close` to stop the workers.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, int(num_workers))
        self.seed = seed
        self.epoch = 0
        self._sampler = _EpochSampler()
        kw = {}
        if self.num_workers > 0:
            kw = dict(persistent_workers=True,
                      prefetch_factor=max(1, prefetch))
        self._torch = tud.DataLoader(
            _BatchDataset(dataset), batch_size=None, sampler=self._sampler,
            num_workers=self.num_workers, collate_fn=_identity,
            pin_memory=torch.cuda.is_available(), **kw)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (
            (n + self.batch_size - 1) // self.batch_size)

    def _index_batches(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            pyrandom.Random(self.seed + self.epoch).shuffle(idx)
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        epoch = self.epoch
        self._sampler.tasks = [(self.seed, epoch, b, idxs) for b, idxs
                               in enumerate(self._index_batches())]
        self.epoch += 1
        return iter(self._torch)

    def close(self) -> None:
        """Stop the persistent workers (they restart on the next epoch)."""
        it = getattr(self._torch, "_iterator", None)
        if it is not None and hasattr(it, "_shutdown_workers"):
            it._shutdown_workers()
        self._torch._iterator = None


class InfiniteLoader:
    """Cycles a DataLoader forever (training counts steps, not epochs)."""

    def __init__(self, loader: DataLoader):
        self.loader = loader

    def __iter__(self):
        while True:
            yield from self.loader


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


class _InFlight:
    """A batch whose copy to the card was issued on a side stream."""

    def __init__(self, batch, event: torch.cuda.Event):
        self.batch = batch
        self.event = event

    def wait(self):
        """Make the current stream wait for the copy and hand the batch's
        memory over to that stream."""
        stream = torch.cuda.current_stream()
        stream.wait_event(self.event)
        for t in _tensors(self.batch):
            if t.is_cuda:
                t.record_stream(stream)
        return self.batch


def cuda_put(device) -> Callable[[Dict[str, Any]], _InFlight]:
    """A ``put`` for :class:`DevicePrefetcher`: copies a host batch's
    tensors to ``device`` on a side stream (from pinned memory,
    ``non_blocking``) and records an event after the copies."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device=device)

    def put(batch: Dict[str, Any]) -> _InFlight:
        with torch.cuda.stream(stream):
            out = {}
            for k, v in batch.items():
                if isinstance(v, torch.Tensor):
                    if not v.is_pinned():
                        v = v.pin_memory()
                    v = v.to(device, non_blocking=True)
                out[k] = v
            event = torch.cuda.Event()
            event.record(stream)
        return _InFlight(out, event)

    return put


class DevicePrefetcher:
    """Double-buffers batches: a daemon thread makes the next host batch
    and issues its copy to the card while the current step runs.

    Args:
      make_batch: () -> host batch (e.g. merge of the per-source iterators).
      put: host batch -> device batch, or an in-flight copy
        (:func:`cuda_put`) that :meth:`next` waits for on the current
        stream.
      depth: queue depth (2 = classic double buffering).

    A producer error surfaces on :meth:`next`; :meth:`close` never stalls;
    :meth:`next` after :meth:`close` raises.
    """

    def __init__(self, make_batch, put, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def offer(item) -> bool:
            # bounded put polling the stop event: after close() a put on a
            # full queue must not block this thread forever
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                while not self._stop.is_set():
                    try:
                        item = put(make_batch())
                    except BaseException as e:  # surface on next()
                        offer(("err", e))
                        return
                    if not offer(("ok", item)):
                        return
            finally:
                try:
                    self._q.put_nowait(("end", None))
                except queue.Full:
                    pass

        self._t = threading.Thread(target=produce, daemon=True)
        self._t.start()

    def next(self):
        while True:
            try:
                kind, item = self._q.get(timeout=0.5)
            except queue.Empty:
                if not self._t.is_alive():
                    raise RuntimeError(
                        "DevicePrefetcher exhausted: producer thread has "
                        "exited (closed or errored); no further batches "
                        "will arrive")
                continue
            if kind == "err":
                raise item
            if kind == "end":
                raise RuntimeError(
                    "DevicePrefetcher exhausted: producer thread has exited "
                    "(closed or errored); no further batches will arrive")
            return item.wait() if isinstance(item, _InFlight) else item

    def close(self):
        self._stop.set()
        self._t.join(timeout=5.0)
