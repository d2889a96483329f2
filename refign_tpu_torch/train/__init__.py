"""Optimizers and learning-rate schedules (counterpart of
``refign_tpu/train``)."""
