"""The hand-written kernels' share of their roofline: the sum of each
launch's bound (benchmark/roofline.py, at the shapes of the cell's
kernel_calls) over the sum of the device time of the kernels' events in the
traced window.  Nothing where the table does not describe the window
(``Trace.kernel_count_faults``): its bound would then be wrong."""
from benchmark import roofline


def read(res):
    t = res["trace"]
    if t is None or t.kernel_count_faults():
        return None
    bound = sum(n * c["calls"] * roofline.bound_s(c)
                for k, n in t.window.kinds.items()
                for c in t.cell["kernel_calls"].get(k, []))
    spent = sum(t.family_s(f) for f in t.kernels["families"])
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
