"""Solver iterations a second: the window's whole iterations (one a unit,
on every rank in lockstep) over its time on the host clock (rank 0's,
from the first iteration's start to the last one's end)."""


def read(r):
    return r["units"] / r["window_s"]
