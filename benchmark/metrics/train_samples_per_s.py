"""Rows trained per second: batch rows x completed steps / the window's
wall time, which ends in a synchronize (host clock)."""


def read(res):
    if res["trace"] is not None:
        return None
    w = res["window"]
    return w.units / w.seconds
