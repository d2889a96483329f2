"""Refign UDA training (counterpart of ``refign_tpu/uda``): the train step,
DACS, the losses, the align step and the pseudo-label refinement."""
