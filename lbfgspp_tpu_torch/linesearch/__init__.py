"""Pluggable line searches of the port.

The same registry as ``lbfgspp_tpu.linesearch``.  Every search takes the
batched unified signature

``search(fg, param, xp, drt, step_max, step0, fx0, grad0, dg0, active)``

with ``xp, drt, grad0 [B, n]``, ``fx0, dg0 [B]``, ``step0`` a [B] tensor or
a scalar, and ``active [B]`` (or None for all) the instances to search for;
the others return their starting point untouched.  The keyword ``group``
(a ``torch.distributed`` process group, default None) makes the vectors
this rank's feature block: every reduction is then an all-reduce over it.
"""

from .backtracking import backtracking
from .bracketing import bracketing
from .morethuente import morethuente
from .nocedalwright import nocedalwright
from .speculative import make_speculative, speculative

LINE_SEARCHES = {
    "backtracking": backtracking,
    "bracketing": bracketing,
    "morethuente": morethuente,
    "nocedalwright": nocedalwright,
    # batched-throughput search with no reference counterpart
    "speculative": speculative,
}


def get_line_search(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    try:
        return LINE_SEARCHES[name_or_fn]
    except KeyError:
        raise ValueError(
            f"unknown line search {name_or_fn!r}; available: "
            f"{sorted(LINE_SEARCHES)}") from None


__all__ = ["backtracking", "bracketing", "morethuente", "nocedalwright",
           "speculative", "make_speculative", "LINE_SEARCHES",
           "get_line_search"]
