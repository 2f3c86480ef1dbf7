"""Share of the traced window in which the reported card ran an NCCL
kernel: the union of the intervals of kernels named ``nccl...`` (the
all-reduces of the split solve, their wait for the other ranks
included), clipped to the window span, over its length."""

from portbench.trace import union_ns


def read(r):
    t = r["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    ivs = [(a, b) for name, a, b in t["kernels"] if "nccl" in name.lower()]
    if not ivs:
        return None
    lo, hi = t["span_ns"]
    return 100.0 * union_ns(ivs, lo, hi) * 1e-9 / t["window_s"]
