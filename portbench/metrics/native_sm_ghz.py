"""The SM clock the probed ``native_lbfgs_batch`` ran at, in GHz: its warps'
SM cycles in their slots (``clock64``) over their nanoseconds there
(``%globaltimer``), both summed over the traced window's launches, from
``lbfgspp_tpu_torch.native.probe_records()``."""

from lbfgspp_tpu_torch import native


def read(r):
    recs = getattr(native, "probe_records", list)()
    ns = sum(x["busy_ns"] for x in recs)
    if not recs or ns <= 0:
        return None
    return sum(x["total"] for x in recs) / ns
