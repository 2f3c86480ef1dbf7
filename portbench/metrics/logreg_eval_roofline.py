"""Share of its memory bound that the split logistic regression's
evaluation reaches on the reported card: the window's evaluations times
the yardstick's bytes of one (``logreg_eval_bytes``) over 3.35 TB/s,
divided by the device time of the evaluations: the union of the card's
kernels but NCCL's inside the spans ``portbench.eval`` (which wait for
the card at both ends in a traced run)."""

from portbench.trace import union_inside_ns
from portbench.yardstick import HBM_BYTES_PER_S

SPAN = "portbench.eval"


def read(r):
    t, x = r["trace"], r["extras"]
    evals = r["counters"].get("evals", 0)
    if t is None or not evals or not x.get("eval_bytes"):
        return None
    spans = [(a, b) for name, a, b in t["spans"] if name == SPAN]
    ivs = [(a, b) for name, a, b in t["kernels"]
           if "nccl" not in name.lower()]
    secs = union_inside_ns(ivs, spans) * 1e-9
    if secs <= 0:
        return None
    return 100.0 * evals * x["eval_bytes"] / HBM_BYTES_PER_S / secs
