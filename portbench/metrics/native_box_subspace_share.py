"""Share of the probed ``native_lbfgsb_batch`` warps' SM cycles spent on the
subspace steps (BOXCQP over the free coordinates, with its lane-0 LU
factorizations of the middle matrix; a part of the direction's cycles),
summed over the traced window's box launches: the kernel's own ``clock64``
records, from ``lbfgspp_tpu_torch.native.probe_records()`` (the summaries
of kernel ``"lbfgsb"``)."""

from lbfgspp_tpu_torch import native


def read(r):
    recs = [x for x in getattr(native, "probe_records", list)()
            if x.get("kernel") == "lbfgsb"]
    total = sum(x["total"] for x in recs)
    if not recs or total <= 0:
        return None
    return 100.0 * sum(x["subspace"] for x in recs) / total
