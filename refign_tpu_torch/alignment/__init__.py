"""UAWarpC alignment (counterpart of ``refign_tpu/alignment``): the
forward of the frozen alignment network."""
