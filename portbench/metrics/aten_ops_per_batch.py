"""PyTorch operators (the profiler's ``aten::`` events, nested ones
included) that the host dispatched in the traced window, per batch."""


def read(r):
    t = r["trace"]
    if t is None or not r["units"]:
        return None
    return t["aten_ops"] / r["units"]
