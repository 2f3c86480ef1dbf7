"""Share of its bound that the two-loop kernel (csrc/two_loop.cu) reaches:
each traced launch's bytes (the yardstick's ``args_bytes`` at the main
phase's shape: inputs read once, output written once) at 3.35 TB/s, over
the kernel's device time, both summed over its launches in the trace."""

from portbench.yardstick import HBM_BYTES_PER_S

KERNEL = "two_loop_kernel"


def read(r):
    t, x = r["trace"], r["extras"]
    if t is None or "two_loop_bytes" not in x:
        return None
    rows = [v for k, v in t["by_kernel"].items()
            if KERNEL in k and "simple" not in k]
    secs, launches = sum(v[0] for v in rows), sum(v[1] for v in rows)
    if secs <= 0:
        return None
    return 100.0 * launches * x["two_loop_bytes"] / HBM_BYTES_PER_S / secs
