"""Share of the traced window in which the card ran nothing: 1 - busy_s /
window_s, busy_s the union of the device's kernel and copy intervals over
all its streams, clipped to the window span (portbench/trace.py).  It
reads each cell's own name of the share (``idle_share.multistart``)."""


def read(r):
    t = r["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
