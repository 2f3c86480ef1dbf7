"""Bracketing line search, batched.

The port's counterpart of ``lbfgspp_tpu.linesearch.bracketing``
(LineSearchBracketing.h): a backtracking variant that keeps an explicit
``[step_lo, step_hi]`` range, doubling while the upper end is infinite and
bisecting once it is bounded (:123).  The throw sites (:113-127) become
failure statuses.  Batched as :mod:`.backtracking` is.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..parallel import collectives as coll
from ..params import (LINESEARCH_BACKTRACKING_ARMIJO,
                      LINESEARCH_BACKTRACKING_WOLFE)
from ..types import LineSearchResult, Status, i32_like
from .backtracking import pre_checks, run_trials

Tensor = torch.Tensor


class _BRCarry(NamedTuple):
    step: Tensor
    fx: Tensor
    dg: Tensor
    x: Tensor
    grad: Tensor
    step_lo: Tensor
    step_hi: Tensor
    it: Tensor
    done: Tensor
    status: Tensor
    nfev: Tensor


def bracketing(fg, param, xp: Tensor, drt: Tensor, step_max, step0,
               fx0: Tensor, grad0: Tensor, dg0: Tensor,
               active: Optional[Tensor] = None,
               group=None) -> LineSearchResult:
    """Batched bracketing search; ``step_max`` is ignored (L-BFGS only).
    ``group`` as in :func:`.backtracking.backtracking`."""
    del step_max
    step0, dg_init, pre_status, stopped = pre_checks(step0, fx0, grad0,
                                                     drt, active, group)
    test_decr = param.ftol * dg_init

    def trial(c: _BRCarry) -> _BRCarry:
        x = xp + c.step[:, None] * drt
        fx, grad, dg = coll.evaluate(
            fg, x, lambda g: torch.linalg.vecdot(g, drt)[:, None], group,
            "bracketing.trial")
        decr_fail = (fx > fx0 + c.step * test_decr) | ~torch.isfinite(fx)
        dg = torch.where(decr_fail, c.dg, dg[:, 0])

        # Range / condition update (:79-111)
        if param.linesearch == LINESEARCH_BACKTRACKING_ARMIJO:
            met = ~decr_fail
            hi_to_step = decr_fail
            lo_to_step = torch.zeros_like(decr_fail)
        else:
            curv_low = dg < param.wolfe * dg_init
            lo_to_step = (~decr_fail) & curv_low
            if param.linesearch == LINESEARCH_BACKTRACKING_WOLFE:
                met = (~decr_fail) & (~curv_low)
                hi_to_step = decr_fail
            else:  # strong Wolfe
                strong_fail = dg > -param.wolfe * dg_init
                met = (~decr_fail) & (~curv_low) & (~strong_fail)
                hi_to_step = decr_fail | ((~decr_fail) & (~curv_low) &
                                          strong_fail)
        step_hi = torch.where(hi_to_step, c.step, c.step_hi)
        step_lo = torch.where(lo_to_step, c.step, c.step_lo)

        # Failure checks after the update (:113-120)
        status = torch.where(
            met, c.status,
            torch.where(
                step_lo > step_hi, i32_like(Status.LS_BRACKET_INVERTED, fx0),
                torch.where(
                    c.step < param.min_step,
                    i32_like(Status.LS_STEP_TOO_SMALL, fx0),
                    torch.where(c.step > param.max_step,
                                i32_like(Status.LS_STEP_TOO_LARGE, fx0),
                                c.status))))

        # Next trial: double while unbounded, else bisect (:123)
        new_step = torch.where(torch.isinf(step_hi), 2.0 * c.step,
                               step_lo / 2.0 + step_hi / 2.0)
        return _BRCarry(
            step=torch.where(met, c.step, new_step), fx=fx, dg=dg, x=x,
            grad=grad, step_lo=torch.where(met, c.step_lo, step_lo),
            step_hi=torch.where(met, c.step_hi, step_hi), it=c.it + 1,
            done=met, status=status, nfev=c.nfev + 1)

    zero = torch.zeros_like(fx0)
    c = _BRCarry(step=step0, fx=fx0, dg=dg0, x=xp, grad=grad0,
                 step_lo=zero, step_hi=torch.full_like(fx0, float("inf")),
                 it=i32_like(0, fx0), done=stopped, status=pre_status,
                 nfev=i32_like(0, fx0))
    c, status = run_trials(trial, c, param.max_linesearch)
    return LineSearchResult(step=c.step, fx=c.fx, grad=c.grad, dg=c.dg,
                            x=c.x, status=status, nfev=c.nfev)
