"""The share of the traced window in which the device ran nothing: 100
minus the union of the trace's device intervals over the window."""


def read(res):
    t = res["trace"]
    if t is None or not t.events:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
