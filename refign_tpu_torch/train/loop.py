"""Shared fit-loop bookkeeping for SegTask / AlignTask (counterpart of
``refign_tpu/train/loop.py``).

The two tasks' loops differ only in how a step runs; the cadence — jsonl
and TensorBoard logging, steps per second, validation and checkpoint
intervals, the final checkpoint — is identical and lives here once (the
reference's Lightning callbacks: ``self.log``, ValEveryNSteps,
ModelCheckpoint(save_last)).

Beside ``metrics.jsonl`` (the JAX package's lines, key for key) the loop
writes ``timing.jsonl``: for each logged step the seconds it waited for
its batch and its wall time through the logged losses (logging reads the
losses, which waits for the card).

Under a process group every rank runs the cadence (the logs, validation
and the per-rank loader waits are collectives), and rank 0 alone writes
``metrics.jsonl``, ``timing.jsonl`` (with every rank's loader wait),
``tb/`` and the checkpoints; the others wait for each checkpoint at a
one-element barrier.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..parallel import mesh


class FitBookkeeper:
    """Owns log/val/ckpt cadence for a step-indexed training loop.

    Args:
      workdir: run directory (metrics.jsonl, timing.jsonl, tb/ under it).
      trainer_cfg: reference-schema trainer dict (max_steps,
        val_every_n_steps, log_every_n_steps, callbacks).
      sched_fn: step -> learning rate (for the lr monitor column).
      evaluate: () -> metrics dict, called at val intervals.
      save: step -> None, writes a checkpoint.
      default_max_steps: fallback when the config omits max_steps.
    """

    def __init__(self, workdir: str, trainer_cfg: Dict[str, Any],
                 sched_fn: Callable[[int], float],
                 evaluate: Callable[[], Dict[str, float]],
                 save: Callable[[int], None], default_max_steps: int):
        os.makedirs(workdir, exist_ok=True)
        cfg = trainer_cfg or {}
        self.max_steps = int(cfg.get("max_steps", default_max_steps))
        # reference-schema configs carry the cadence in trainer.callbacks
        # ValEveryNSteps.init_args.every_n_steps (helpers/callbacks.py:6-27)
        val_every = cfg.get("val_every_n_steps")
        if val_every is None:
            for cb in (cfg.get("callbacks") or []):
                if (isinstance(cb, dict) and str(cb.get(
                        "class_path", "")).endswith("ValEveryNSteps")):
                    val_every = (cb.get("init_args") or {}).get(
                        "every_n_steps")
        self.val_every = int(val_every or self.max_steps)
        self.log_every = int(cfg.get("log_every_n_steps", 50))
        self.ckpt_dir = os.path.join(workdir, "checkpoints")
        self._sched_fn = sched_fn
        self._evaluate = evaluate
        self._save = save
        self._main = mesh.is_main()
        self._logf = self._timef = self._tb = None
        if self._main:
            self._logf = open(os.path.join(workdir, "metrics.jsonl"), "a")
            self._timef = open(os.path.join(workdir, "timing.jsonl"), "a")
            from ..utils.tb_logger import TensorBoardLogger
            self._tb = TensorBoardLogger(os.path.join(workdir, "tb"))
        self._t0 = time.time()
        self._saved_step: Optional[int] = None

    def _write(self, f, row) -> None:
        if f is not None:
            f.write(json.dumps(row) + "\n")
            f.flush()

    def _checkpoint(self, step: int) -> None:
        """Rank 0 writes the checkpoint; every rank waits for it."""
        if self._main:
            self._save(step)
        mesh.barrier()

    def on_step(self, step: int, start_step: int, logs,
                t_start: Optional[float] = None,
                data_wait_s: float = 0.0) -> None:
        """Call once per step with its logs (0-d tensors or floats);
        ``t_start`` is the perf_counter time the step began waiting for
        its batch, ``data_wait_s`` how long that wait was."""
        if (step + 1) % self.log_every == 0 or step == start_step:
            logs = {k: float(v) for k, v in logs.items()}
            logs.update(step=step + 1,
                        lr=float(self._sched_fn(step)),
                        sps=(step + 1 - start_step)
                        / max(time.time() - self._t0, 1e-9))
            if t_start is not None:
                row = {"step": step + 1, "data_wait_s": data_wait_s,
                       "step_s": time.perf_counter() - t_start}
                if mesh.world_size() > 1:
                    waits = mesh.gather_rows(torch.tensor(
                        [data_wait_s], dtype=torch.float64,
                        device=mesh.process_device()),
                        mesh.world_size(), mesh.rank())
                    row["data_wait_s_ranks"] = waits.cpu().tolist()
                self._write(self._timef, row)
            if self._main:
                print(f"[fit] {json.dumps(logs)}", flush=True)
                self._write(self._logf, logs)
                self._tb.log_scalars(logs, step + 1)
        if (step + 1) % self.val_every == 0 or step + 1 == self.max_steps:
            metrics = self._evaluate()
            if self._main:
                print(f"[val] step {step + 1}: {metrics}", flush=True)
                self._write(self._logf, {"step": step + 1, **metrics})
                self._tb.log_scalars(metrics, step + 1)
            self._checkpoint(step + 1)
            self._saved_step = step + 1

    def finish(self) -> Dict[str, float]:
        """The final checkpoint (unless the last step's validation just
        wrote the same state)."""
        if self._saved_step != self.max_steps:
            self._checkpoint(self.max_steps)
        if self._main:
            self._logf.close()
            self._timef.close()
            self._tb.close()
        return {"final_step": self.max_steps}
