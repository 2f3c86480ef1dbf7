"""Share of the probed ``native_lbfgs_batch`` warps' SM cycles spent on the
new direction (the s/y pair, the curvature test, the history's update
and its two-loop product), summed over the traced window's launches: the
kernel's own ``clock64`` records, from
``lbfgspp_tpu_torch.native.probe_records()``."""

from lbfgspp_tpu_torch import native


def read(r):
    recs = getattr(native, "probe_records", list)()
    total = sum(x["total"] for x in recs)
    if not recs or total <= 0:
        return None
    return 100.0 * sum(x["direction"] for x in recs) / total
