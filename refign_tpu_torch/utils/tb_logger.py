"""TensorBoard scalar logging (counterpart of ``refign_tpu/utils/
tb_logger.py``; the reference's TensorBoardLogger, e.g.
refign_hrda_star.yaml:165-171).

Writes through ``torch.utils.tensorboard.SummaryWriter`` when the
``tensorboard`` package imports; otherwise a no-op (the JSONL metrics log
is always written regardless).
"""
from __future__ import annotations

from typing import Dict


class TensorBoardLogger:
    def __init__(self, logdir: str):
        self.logdir = logdir
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._writer = SummaryWriter(log_dir=logdir)
        except Exception:
            self._writer = None

    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        if self._writer is None:
            return
        for k, v in scalars.items():
            try:
                self._writer.add_scalar(k, float(v), global_step=step)
            except (TypeError, ValueError):
                pass
        self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
