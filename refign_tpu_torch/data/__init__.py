"""Host data pipeline (counterpart of ``refign_tpu/data``): transforms,
datasets, the batch loader on ``torch.utils.data`` and the combined data
module."""
