"""Share of its bound that ``native_lbfgsb_batch`` reaches: the traced
batches' f64 flops (the yardstick's box count, a lower bound, from each
instance's iterations and evaluations) over the FP64 peak, or their bytes
over the memory rate, the larger, divided by the kernel's device time in
the trace (kernels named ``native_lbfgsb_batch``, which the L-BFGS
kernel's name does not contain)."""

from portbench.yardstick import native_bound_s

KERNEL = "native_lbfgsb_batch"


def read(r):
    t, x = r["trace"], r["extras"]
    if t is None or not x.get("native_flops"):
        return None
    secs = sum(v[0] for k, v in t["by_kernel"].items() if KERNEL in k)
    if secs <= 0:
        return None
    return 100.0 * native_bound_s(x["native_flops"], x["native_bytes"]) / secs
