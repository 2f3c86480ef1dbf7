"""Two-loop kernel launches a batch (``fused.two_loop.launches``, the
program's counter, over the traced window)."""


def read(r):
    c = r["counters"]
    if "two_loop_launches" not in c or not r["units"]:
        return None
    return c["two_loop_launches"] / r["units"]
