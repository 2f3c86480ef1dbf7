"""Backtracking line search (Armijo / Wolfe / strong Wolfe), batched.

The port's counterpart of ``lbfgspp_tpu.linesearch.backtracking``
(LineSearchBacktracking.h): multiplicative step scaling (dec=0.5,
inc=2.1, :50-51) until the condition ``param.linesearch`` selects holds
(:85-106), a NaN objective forcing a decrease (:76).  The reference's
throws on the step range and on exhausting ``max_linesearch`` (:110-120)
become failure statuses.  Batched as :mod:`.morethuente` is: one
objective evaluation per trial for the whole batch, each instance with its
own counter, status and ``done``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..parallel import collectives as coll
from ..params import (LINESEARCH_BACKTRACKING_ARMIJO,
                      LINESEARCH_BACKTRACKING_WOLFE)
from ..types import LineSearchResult, Status, i32_like, tree_select

Tensor = torch.Tensor


class _BTCarry(NamedTuple):
    step: Tensor
    fx: Tensor
    dg: Tensor
    x: Tensor
    grad: Tensor
    it: Tensor
    done: Tensor      # met the termination condition (success)
    status: Tensor
    nfev: Tensor


def pre_checks(step0, fx0: Tensor, grad0: Tensor, drt: Tensor, active,
               group=None):
    """The checks before the first trial, shared with bracketing:
    ``(step0 [B], dg_init [B], pre_status, stopped)``.  ``dg_init`` is
    recomputed from the inputs (:60)."""
    step0 = torch.as_tensor(step0, dtype=fx0.dtype,
                            device=fx0.device).expand(fx0.shape).clone()
    invalid = step0 <= 0.0
    dg_init = coll.pdot(grad0, drt, group, "linesearch.dg_init")
    not_descent = dg_init > 0.0
    pre_status = torch.where(
        invalid, i32_like(Status.LS_INVALID_STEP, fx0),
        torch.where(not_descent, i32_like(Status.LS_NOT_DESCENT, fx0),
                    i32_like(Status.RUNNING, fx0)))
    stopped = invalid | not_descent
    if active is not None:
        stopped = stopped | ~active
    return step0, dg_init, pre_status, stopped


def run_trials(trial, c, max_linesearch: int):
    """Trials until every instance is done, has failed or has used
    ``max_linesearch``; finished instances keep their carry."""
    def searching(c):
        return (~c.done) & (c.status == Status.RUNNING) & \
            (c.it < max_linesearch)

    live = searching(c)
    while bool(live.any()):
        c = tree_select(live, trial(c), c)
        live = searching(c)
    exhausted = (~c.done) & (c.status == Status.RUNNING)
    return c, torch.where(exhausted,
                          i32_like(Status.LS_MAX_LINESEARCH, c.status),
                          c.status)


def backtracking(fg, param, xp: Tensor, drt: Tensor, step_max, step0,
                 fx0: Tensor, grad0: Tensor, dg0: Tensor,
                 active: Optional[Tensor] = None,
                 group=None) -> LineSearchResult:
    """Batched backtracking search; ``step_max`` is ignored (L-BFGS only,
    reference :32-33).  ``group``: the vectors are this rank's feature
    block; a trial's value and directional derivative take one
    all-reduce."""
    del step_max
    dec, inc = 0.5, 2.1
    step0, dg_init, pre_status, stopped = pre_checks(step0, fx0, grad0,
                                                     drt, active, group)
    test_decr = param.ftol * dg_init

    def trial(c: _BTCarry) -> _BTCarry:
        x = xp + c.step[:, None] * drt
        fx, grad, dg = coll.evaluate(
            fg, x, lambda g: torch.linalg.vecdot(g, drt)[:, None], group,
            "backtracking.trial")
        decr_fail = (fx > fx0 + c.step * test_decr) | torch.isnan(fx)
        dg = torch.where(decr_fail, c.dg, dg[:, 0])

        # Condition cascade (:76-107)
        if param.linesearch == LINESEARCH_BACKTRACKING_ARMIJO:
            met = ~decr_fail
            width = torch.full_like(fx, dec)
        else:
            curv_low = dg < param.wolfe * dg_init
            if param.linesearch == LINESEARCH_BACKTRACKING_WOLFE:
                met = (~decr_fail) & (~curv_low)
                width = torch.where(decr_fail | (~curv_low), dec, inc)
            else:  # strong Wolfe
                strong_fail = dg > -param.wolfe * dg_init
                met = (~decr_fail) & (~curv_low) & (~strong_fail)
                width = torch.where(decr_fail, dec,
                                    torch.where(curv_low, inc, dec))

        # Step-range failures, checked before scaling (:110-115)
        status = torch.where(
            met, c.status,
            torch.where(c.step < param.min_step,
                        i32_like(Status.LS_STEP_TOO_SMALL, fx0),
                        torch.where(c.step > param.max_step,
                                    i32_like(Status.LS_STEP_TOO_LARGE, fx0),
                                    c.status)))
        return _BTCarry(step=torch.where(met, c.step, c.step * width),
                        fx=fx, dg=dg, x=x, grad=grad, it=c.it + 1,
                        done=met, status=status, nfev=c.nfev + 1)

    c = _BTCarry(step=step0, fx=fx0, dg=dg0, x=xp, grad=grad0,
                 it=i32_like(0, fx0), done=stopped, status=pre_status,
                 nfev=i32_like(0, fx0))
    c, status = run_trials(trial, c, param.max_linesearch)
    return LineSearchResult(step=c.step, fx=c.fx, grad=c.grad, dg=c.dg,
                            x=c.x, status=status, nfev=c.nfev)
