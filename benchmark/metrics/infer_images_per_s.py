"""Frames completed per second, closed loop with one frame in flight:
frames / the window's wall time (host clock)."""


def read(res):
    if res["trace"] is not None:
        return None
    w = res["window"]
    return w.units / w.seconds
