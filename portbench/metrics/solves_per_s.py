"""Solves a second: instances that end within the quality bar, over all
whole batches of the window, divided by the window's time (host clock,
from the first draw to the last batch's check).  It reads each cell's
own name of the rate too (``solves_per_s.<suffix>``)."""


def read(r):
    return r["good"] / r["window_s"]
