"""Batched multistart solves: the main phase of ``minimize_batched``.

The port's counterpart of ``lbfgspp_tpu.batch.minimize_batched``
(batch.py:552-742) with its main-phase options.  The df64 polish and deep
phases, straggler compaction and the multi-device mesh are later slices of
the port: setting any of their options raises ``NotImplementedError``
instead of being ignored.
"""

from __future__ import annotations

from typing import Callable, Optional

from . import lbfgs
from .params import LBFGSParams
from .types import SolveResult

# Options of the JAX package's minimize_batched that no slice of the port
# has brought over yet, with the values that leave them off.
_NOT_YET_PORTED = dict(
    mesh=None, polish_iters=0, polish_params=None, polish_warm=False,
    polish_shift=False, polish_on_ls_fail="stop", polish_restarts=1,
    refine_frac=0.0, refine_iters=0, deep_frac=0.0, deep_iters=0,
    deep_selection="gnorm")


def minimize_batched(fun: Optional[Callable] = None,
                     x0s=None,
                     params: LBFGSParams = LBFGSParams(),
                     *,
                     fun_and_grad=None,
                     line_search: str = "nocedalwright",
                     drive: str = "while",
                     direction: str = "sweeps",
                     on_ls_fail: str = "stop",
                     device=None,
                     **later) -> SolveResult:
    """Solve one objective from a batch of starts ``x0s [B, n]``; every
    result field has the batch axis.

    ``drive="while"`` steps until every instance has finished;
    ``drive="fixed"`` runs exactly ``params.max_iterations`` steps (the
    same result: finished instances keep their state), with no all-done
    test between steps.  Set ``params.max_iterations``: the batch runs
    until its slowest instance stops.
    """
    for name, value in later.items():
        if name not in _NOT_YET_PORTED:
            raise TypeError(f"minimize_batched() got an unexpected keyword "
                            f"argument {name!r}")
        if value != _NOT_YET_PORTED[name]:
            raise NotImplementedError(
                f"minimize_batched({name}=...) lands in a later slice of the "
                f"port")
    if drive not in ("while", "fixed"):
        raise ValueError(f"drive must be 'while' or 'fixed', got {drive!r}")
    if drive == "fixed" and params.max_iterations == 0:
        raise ValueError("drive='fixed' requires a finite "
                         "params.max_iterations (the trip count)")
    s = lbfgs.solver(fun, params, fun_and_grad=fun_and_grad,
                     line_search=line_search, direction=direction,
                     on_ls_fail=on_ls_fail, device=device)
    state = s.init(x0s)
    state = (s.run_fixed(state, params.max_iterations) if drive == "fixed"
             else s.run(state))
    return s.finalize(state)
