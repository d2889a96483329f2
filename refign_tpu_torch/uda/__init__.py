"""Refign UDA pieces (counterpart of ``refign_tpu/uda``): the align step and
the pseudo-label refinement."""
