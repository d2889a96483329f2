"""Device operations (kernels, copies, sets) in the traced window per
step."""


def read(res):
    t = res["trace"]
    if t is None or not t.events:
        return None
    return len(t.events) / t.window.calls
