"""The yardstick of the kernels: the card's peaks and each hand-written
kernel's least time for one launch at a given shape, counting each input
byte read once and each output byte written once.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates at 700 W.
Bound = max(bytes / memory rate, operations / peak of the input type).
The arithmetic is frozen here as the repository's kernel tables use it
(PERF.md's kernel table: K1 0.957 ms and K2 3.19 ms a 1080x1920 forward,
K3 0.0774 ms fused bf16 at the align shapes).
"""
from __future__ import annotations

from typing import Sequence

HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def peak_flops(itemsize: int) -> float:
    """bf16 products summed in fp32 are tensor-core work, fp32 ones
    CUDA-core work."""
    return BF16_TENSOR_FLOPS if itemsize == 2 else FP32_FLOPS


def _bound_s(nbytes: float, flops: float, itemsize: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops(itemsize))


def k1(shape: Sequence[int], itemsize: int) -> float:
    """SRA attention forward, (B, N, M, H), head size 64: q, k, v read, the
    output written; two products."""
    B, N, M, H = shape
    nbytes = (2 * B * N * H * 64 + 2 * B * M * H * 64) * itemsize
    return _bound_s(nbytes, 4.0 * B * H * N * M * 64, itemsize)


def k1_bwd(shape: Sequence[int], itemsize: int) -> float:
    """Its backward: q, k, v, the output gradient read, dq, dk, dv written;
    five products a head."""
    B, N, M, H = shape
    nbytes = (3 * B * N * H * 64 + 4 * B * M * H * 64) * itemsize
    return _bound_s(nbytes, 10.0 * B * H * N * M * 64, itemsize)


def k2(shape: Sequence[int], itemsize: int) -> float:
    """Depthwise 3x3 + bias + GELU, (B, S, C) on S x S: x read, y written,
    weights and bias; 9 FMAs, bias, GELU a value."""
    B, S, C = shape
    return _bound_s((2 * B * S * S * C + 10 * C) * itemsize,
                    20.0 * B * S * S * C, itemsize)


def k2_bwd(shape: Sequence[int], itemsize: int) -> float:
    """Its backward: x and g read, dx written, dw and db."""
    B, S, C = shape
    return _bound_s((3 * B * S * S * C + 20 * C) * itemsize,
                    60.0 * B * S * S * C, itemsize)


def k3(shape: Sequence[int], itemsize: int, out_itemsize: int) -> float:
    """Local correlation, (B, H, W, C, P): t and s read, the P*P volume
    written in the output type."""
    B, H, W, C, P = shape
    nbytes = 2 * B * H * W * C * itemsize + B * H * W * P * P * out_itemsize
    return _bound_s(nbytes, 2.0 * B * H * W * P * P * C, itemsize)


def k3_bwd(shape: Sequence[int], itemsize: int, out_itemsize: int,
           need_t: bool) -> float:
    """Its backward: t, s and the volume's gradient read, each wanted
    gradient written; 4 P^2 C operations a pixel."""
    B, H, W, C, P = shape
    nbytes = ((3 + need_t) * B * H * W * C * itemsize
              + B * H * W * P * P * out_itemsize)
    return _bound_s(nbytes, 4.0 * B * H * W * P * P * C, itemsize)


def bound_s(call: dict) -> float:
    """The bound of one launch described in a workload file:
    ``{"kernel": "K1", "shape": [...], "dtype": "bfloat16", ...}``."""
    k, shape = call["kernel"], call["shape"]
    size = ITEMSIZE[call.get("dtype", "bfloat16")]
    if k == "K1":
        return k1(shape, size)
    if k == "K1-bwd":
        return k1_bwd(shape, size)
    if k == "K2":
        return k2(shape, size)
    if k == "K2-bwd":
        return k2_bwd(shape, size)
    out = ITEMSIZE[call.get("out_dtype", "bfloat16")]
    if k == "K3":
        return k3(shape, size, out)
    if k == "K3-bwd":
        return k3_bwd(shape, size, out, bool(call.get("need_t", False)))
    raise KeyError(f"no bound for kernel {k!r}")
