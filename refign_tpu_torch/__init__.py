"""refign-tpu in PyTorch: the Refign models for NVIDIA Hopper cards.

The package mirrors ``refign_tpu`` module by module (``nn``, ``ops``,
``models``, ``models/heads``, ``alignment``, ``uda``, ``utils``) and keeps
its NHWC layout at every public function.  The three Pallas kernels of the
JAX package (SRA attention and the fused depthwise conv in every MiT
block, the local correlation on the alignment path) are CUDA C++ kernels
under ``csrc/``, and so are the backwards of the first two (their
``custom_vjp`` in the JAX package), which the UDA train step runs; all are
built with ``nvcc`` at first use (``ops/_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def full_fp32_precision() -> None:
    """Make float32 matrix products and cuDNN convolutions run in full fp32.

    The counterpart of ``jax_default_matmul_precision="highest"`` in the
    JAX package.  cuDNN convolutions default to TF32 on the card (about
    three decimal digits), so every fp32 check on the card calls this
    first.  It is not applied at import.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

