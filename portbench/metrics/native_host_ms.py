"""The program's host time a batch on the card path, before the card can
start: the mean length of the span ``lbfgspp.native.launch`` (the input
copy, the outputs, the plan and the C launch of ``native_lbfgs_batch``,
on the host's ``perf_counter_ns``) over the traced window's probed
launches, from ``lbfgspp_tpu_torch.native.probe_records()``."""

from lbfgspp_tpu_torch import native


def read(r):
    recs = getattr(native, "probe_records", list)()
    if not recs:
        return None
    return sum(x["host_ns"] for x in recs) / len(recs) / 1e6
