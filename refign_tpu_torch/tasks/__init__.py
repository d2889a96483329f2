"""Tasks (counterpart of ``refign_tpu/tasks``): domain-adaptive
segmentation and UAWarpC alignment, each with fit / evaluate (and predict
for segmentation)."""
