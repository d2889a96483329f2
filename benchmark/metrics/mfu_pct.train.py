"""The whole step's share of the card's bf16 peak: model operations of
each kind of call (counted once per cell over the frozen plain model,
benchmark/flops.py) x the calls of that kind in the traced window, over
the traced window x 989 TFLOP/s."""
from benchmark import roofline


def read(res):
    t = res["trace"]
    if t is None or not t.flops:
        return None
    ops = sum(n * t.flops[k] for k, n in t.window.kinds.items())
    return 100.0 * ops / (t.window_s * roofline.BF16_TENSOR_FLOPS)
