"""Nocedal-Wright strong-Wolfe line search, batched.

The port's counterpart of ``lbfgspp_tpu.linesearch.nocedalwright``
(LineSearchNocedalWright.h, "Numerical Optimization" Algorithms 3.5/3.6):
an expansion-factor-2 bracketing phase, then a zoom phase with safeguarded
quadratic interpolation.  Exhaustion returns the best-so-far point; the
reference's numerical-failure throws become ``LS_NUMERICAL``.

Batched semantics: each instance carries its own phase (0 bracketing,
1 zoom, 2 finished), trial counter and status.  Every trial evaluates the
objective once for the whole batch, at each instance's own trial step (the
bracketing step, or the interpolated zoom step), and applies the update of
each instance's phase; finished instances keep their carry.  That is what
``vmap`` of the JAX search's ``lax.while_loop``/``lax.cond`` does, with one
objective evaluation per trial instead of one per branch, and ``nfev``
counts per instance exactly as the JAX search does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..params import LINESEARCH_BACKTRACKING_STRONG_WOLFE
from ..parallel import collectives as coll
from ..types import LineSearchResult, Status, i32_like, tree_select

Tensor = torch.Tensor


def _quad_interp(step_lo, step_hi, fx_lo, fx_hi, dg_lo):
    """Safeguarded quadratic interpolation (reference :30-60)."""
    fdiff = fx_hi - fx_lo
    sdiff = step_hi - step_lo
    smid = (step_hi + step_lo) / 2.0
    step_candid = (fdiff * step_lo - smid * sdiff * dg_lo) / \
        (fdiff - sdiff * dg_lo)

    candid_nan = ~torch.isfinite(step_candid)
    end_dist = torch.minimum((step_candid - step_lo).abs(),
                             (step_candid - step_hi).abs())
    near_end = end_dist < 0.01 * sdiff.abs()
    bisect = candid_nan | \
        (step_candid <= torch.minimum(step_lo, step_hi)) | \
        (step_candid >= torch.maximum(step_lo, step_hi)) | near_end
    return torch.where(bisect, smid, step_candid)


class _NWCarry(NamedTuple):
    step: Tensor
    fx: Tensor
    dg: Tensor
    x: Tensor
    grad: Tensor
    step_lo: Tensor
    fx_lo: Tensor
    dg_lo: Tensor
    step_hi: Tensor
    fx_hi: Tensor
    it: Tensor
    phase: Tensor    # 0 = bracketing, 1 = zoom, 2 = finished
    status: Tensor
    use_lo: Tensor   # finish by returning the _lo state
    nfev: Tensor


def nocedalwright(fg, param, xp: Tensor, drt: Tensor, step_max, step0,
                  fx0: Tensor, grad0: Tensor, dg0: Tensor,
                  active: Optional[Tensor] = None,
                  group=None) -> LineSearchResult:
    """Batched Nocedal-Wright search; ``step_max`` is ignored (L-BFGS
    only).  ``group``: the vectors are this rank's feature block; a
    trial's value and directional derivative take one all-reduce
    (lbfgspp_tpu/linesearch/nocedalwright.py:110, :153)."""
    del step_max
    if param.linesearch != LINESEARCH_BACKTRACKING_STRONG_WOLFE:
        raise ValueError(
            "'param.linesearch' must be LINESEARCH_BACKTRACKING_STRONG_WOLFE"
            " for the Nocedal-Wright line search")

    dtype = xp.dtype
    step0 = torch.as_tensor(step0, dtype=dtype,
                            device=xp.device).expand(fx0.shape).clone()
    invalid = step0 <= 0.0
    dg_init = dg0                       # the caller-supplied dg (:114)
    not_descent = dg_init > 0.0
    pre_fail = invalid | not_descent
    running = i32_like(Status.RUNNING, fx0)
    pre_status = torch.where(
        invalid, i32_like(Status.LS_INVALID_STEP, fx0),
        torch.where(not_descent, i32_like(Status.LS_NOT_DESCENT, fx0),
                    running))
    stopped = pre_fail if active is None else pre_fail | ~active

    fx_init = fx0
    test_decr = param.ftol * dg_init
    test_curv = -param.wolfe * dg_init
    max_ls = param.max_linesearch
    zero = torch.zeros_like(fx0)

    c = _NWCarry(
        step=step0, fx=fx0, dg=dg0, x=xp, grad=grad0,
        step_lo=zero, fx_lo=fx_init, dg_lo=dg_init,
        step_hi=zero, fx_hi=zero, it=i32_like(0, fx0),
        phase=torch.where(stopped, i32_like(2, fx0), i32_like(0, fx0)),
        status=pre_status, use_lo=torch.zeros_like(fx0, dtype=torch.bool),
        nfev=i32_like(0, fx0))

    def trial(c: _NWCarry) -> _NWCarry:
        bracket = c.phase == 0
        step = torch.where(bracket, c.step,
                           _quad_interp(c.step_lo, c.step_hi, c.fx_lo,
                                        c.fx_hi, c.dg_lo))
        x = xp + step[:, None] * drt
        fx, grad, dg = coll.evaluate(
            fg, x, lambda g: torch.linalg.vecdot(g, drt)[:, None], group,
            "nocedalwright.trial")
        dg = dg[:, 0]
        nfev = c.nfev + 1

        # Bracketing phase (reference :143-198).
        # Case (1)/(2): sufficient decrease violated -> bracketed, go zoom
        to_zoom_hi = (fx - fx_init > step * test_decr) | \
            ((c.step_lo > 0.0) & (fx >= c.fx_lo))
        # Case (4): strong Wolfe met -> finished with the trial point
        wolfe_b = (~to_zoom_hi) & (dg.abs() <= test_curv)
        shift = (~to_zoom_hi) & (~wolfe_b)
        # Case (3): dg >= 0 -> bracketed with [step, old lo], go zoom
        to_zoom_flip = shift & (dg >= 0.0)
        keep_going = shift & (dg < 0.0)
        it_b = c.it + keep_going.to(torch.int32)
        exhausted_b = keep_going & (it_b >= max_ls)
        bracketed = _NWCarry(
            step=torch.where(keep_going & ~exhausted_b, step * 2.0, step),
            fx=fx, dg=dg, x=x, grad=grad,
            step_lo=torch.where(shift, step, c.step_lo),
            fx_lo=torch.where(shift, fx, c.fx_lo),
            dg_lo=torch.where(shift, dg, c.dg_lo),
            step_hi=torch.where(to_zoom_hi, step,
                                torch.where(shift, c.step_lo, c.step_hi)),
            fx_hi=torch.where(to_zoom_hi, fx,
                              torch.where(shift, c.fx_lo, c.fx_hi)),
            it=it_b,
            phase=torch.where(
                wolfe_b | exhausted_b, i32_like(2, fx0),
                torch.where(to_zoom_hi | to_zoom_flip, i32_like(1, fx0),
                            i32_like(0, fx0))),
            status=c.status, use_lo=torch.zeros_like(c.use_lo), nfev=nfev)

        # Zoom phase (reference :211-278).
        decr_fail = (fx - fx_init > step * test_decr) | (fx >= c.fx_lo)
        fail_hi = decr_fail & (step == c.step_hi)
        wolfe_z = (~decr_fail) & (dg.abs() <= test_curv)
        flip = (~decr_fail) & (~wolfe_z) & \
            (dg * (c.step_hi - c.step_lo) >= 0.0)
        fail_lo = (~decr_fail) & (~wolfe_z) & (step == c.step_lo)
        take_lo = (~decr_fail) & (~wolfe_z) & (~fail_lo)
        step_lo = torch.where(take_lo, step, c.step_lo)
        it_z = c.it + 1
        numerical_fail = fail_hi | fail_lo
        exhausted_z = (~numerical_fail) & (~wolfe_z) & (it_z >= max_ls)
        # Exhaustion with no sufficient-decrease point found is a failure
        # (reference :266-267); otherwise return the _lo state.
        exhaust_fail = exhausted_z & (step_lo <= 0.0)
        zoomed = _NWCarry(
            step=step, fx=fx, dg=dg, x=x, grad=grad,
            step_lo=step_lo,
            fx_lo=torch.where(take_lo, fx, c.fx_lo),
            dg_lo=torch.where(take_lo, dg, c.dg_lo),
            step_hi=torch.where(decr_fail, step,
                                torch.where(flip, c.step_lo, c.step_hi)),
            fx_hi=torch.where(decr_fail, fx,
                              torch.where(flip, c.fx_lo, c.fx_hi)),
            it=it_z,
            phase=torch.where(wolfe_z | numerical_fail | exhausted_z,
                              i32_like(2, fx0), i32_like(1, fx0)),
            status=torch.where(numerical_fail | exhaust_fail,
                               i32_like(Status.LS_NUMERICAL, fx0), c.status),
            use_lo=exhausted_z & ~exhaust_fail, nfev=nfev)

        new = tree_select(bracket, bracketed, zoomed)
        return tree_select(c.phase == 2, c, new)

    while bool((c.phase != 2).any()):
        c = trial(c)

    step = torch.where(c.use_lo, c.step_lo, c.step)
    fx = torch.where(c.use_lo, c.fx_lo, c.fx)
    dg = torch.where(c.use_lo, c.dg_lo, c.dg)
    x, grad = c.x, c.grad
    if bool(c.use_lo.any()):
        # The best-so-far point is re-evaluated only on the exhaustion exit
        # instead of carrying x_lo/grad_lo through every trial; not counted
        # in nfev, matching the reference's evaluation count.
        x_lo = xp + c.step_lo[:, None] * drt
        _, g_lo = fg(x_lo)
        x = torch.where(c.use_lo[:, None], x_lo, x)
        grad = torch.where(c.use_lo[:, None], g_lo, grad)

    pf = pre_fail[:, None]
    return LineSearchResult(
        step=torch.where(pre_fail, step0, step),
        fx=torch.where(pre_fail, fx0, fx),
        grad=torch.where(pf, grad0, grad),
        dg=torch.where(pre_fail, dg0, dg),
        x=torch.where(pf, xp, x),
        status=c.status, nfev=c.nfev)
