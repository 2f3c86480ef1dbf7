"""Share of the probed ``native_lbfgs_batch`` warps' SM cycles spent in the
objective's evaluations (the first and every line-search trial), summed
over the traced window's launches: the kernel's own ``clock64`` records,
from ``lbfgspp_tpu_torch.native.probe_records()``."""

from lbfgspp_tpu_torch import native


def read(r):
    recs = getattr(native, "probe_records", list)()
    total = sum(x["total"] for x in recs)
    if not recs or total <= 0:
        return None
    return 100.0 * sum(x["eval"] for x in recs) / total
