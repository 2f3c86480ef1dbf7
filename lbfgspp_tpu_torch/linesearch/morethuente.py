"""More-Thuente line search, batched.

The port's counterpart of ``lbfgspp_tpu.linesearch.morethuente``
(LineSearchMoreThuente.h): the psi-function formulation, the 3-case
interval update, the 4-case step selection with quadratic/cubic
interpolation, the step_min/step_max safeguards and the forced bisection
when the interval fails to shrink by 0.66 twice.  The reference's throws
before the loop become ``LS_INVALID_STEP`` / ``LS_NOT_DESCENT``; an
exhausted search returns the best-so-far (``_lo``) point.  It honours
``step_max``.

Batched semantics: each instance keeps its own interval, ``bracketed``,
``shrink_fail``, trial counter and ``done``.  A trial evaluates the
objective once for the whole batch and updates the instances still
searching; the loop runs until each has finished or used
``max_linesearch`` trials, as ``vmap`` of the JAX search's while loop
does, and ``nfev`` counts per instance as there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..parallel import collectives as coll
from ..types import LineSearchResult, Status, i32_like, tree_select

Tensor = torch.Tensor


def _quad_minimizer_fga(a, b, fa, ga, fb):
    """Minimizer of the quadratic interpolating (fa, ga, fb) (:34-39)."""
    ba = b - a
    w = 0.5 * ba * ga / (fa - fb + ba * ga)
    return a + w * ba


def _quad_minimizer_gg(a, b, ga, gb):
    """Minimizer of the quadratic interpolating (ga, gb) (:46-50)."""
    w = ga / (ga - gb)
    return a + w * (b - a)


def _cubic_minimizer(a, b, fa, fb, ga, gb):
    """Local minimizer of the cubic interpolating (fa, ga, fb, gb) and
    whether it exists (:55-116); every branch evaluated and selected, the
    arguments of ``sqrt`` clamped at 0 in branches not taken."""
    eps = torch.finfo(a.dtype).eps
    apb = a + b
    ba = b - a
    ba2 = ba * ba
    fba = fb - fa
    gba = gb - ga
    z3 = (ga + gb) * ba - 2.0 * fba
    z2 = 0.5 * (gba * ba2 - 3.0 * apb * z3)
    z1 = fba * ba2 - apb * z2 - (a * apb + b * b) * z3

    # Degenerate cubic -> quadratic (:72-80)
    quad_case = (z3.abs() < eps * z2.abs()) | (z3.abs() < eps * z1.abs())
    quad_exists = z2 * ba > 0.0
    z2_safe = torch.where(z2 == 0.0, torch.ones_like(z2), z2)
    quad_val = torch.where(quad_exists, -0.5 * z1 / z2_safe, b)

    # Proper cubic (:83-115)
    z3_safe = torch.where(z3 == 0.0, torch.ones_like(z3), z3)
    u = z2 / (3.0 * z3_safe)
    v = z1 / z2_safe
    u_safe = torch.where(u == 0.0, torch.ones_like(u), u)
    v_safe = torch.where(v == 0.0, torch.ones_like(v), v)
    vu = v / u_safe
    cubic_exists = vu <= 1.0

    # |u| >= |v|: w = 1 + sqrt(1 - v/u); r1 = -u w, r2 = -v / w
    w = 1.0 + torch.sqrt(torch.clamp(1.0 - vu, min=0.0))
    r1a = -u * w
    r2a = -v / w
    # |u| < |v|: sqrt(delta) = sqrt|u| sqrt|v| sqrt(1 - u/v)
    sqrtd = torch.sqrt(u.abs()) * torch.sqrt(v.abs()) * \
        torch.sqrt(torch.clamp(1.0 - u / v_safe, min=0.0))
    r1b = -u - sqrtd
    r2b = -u + sqrtd
    use_a = u.abs() >= v.abs()
    r1 = torch.where(use_a, r1a, r1b)
    r2 = torch.where(use_a, r2a, r2b)
    cubic_val = torch.where(z3 * ba > 0.0, torch.maximum(r1, r2),
                            torch.minimum(r1, r2))
    cubic_val = torch.where(cubic_exists, cubic_val, b)

    value = torch.where(quad_case, quad_val, cubic_val)
    exists = torch.where(quad_case, quad_exists, cubic_exists)
    return value, exists


def _step_selection(al, au, at, fl, fu, ft, gl, gu, gt):
    """Next trial step from the interval and the trial (:120-189)."""
    deltal, deltau = 1.1, 0.66
    mid = (al + at) / 2.0

    ac, ac_exists = _cubic_minimizer(al, at, fl, ft, gl, gt)
    aq = _quad_minimizer_fga(al, at, fl, gl, ft)

    # Case 1: ft > fl (:142-149)
    res1 = torch.where(
        ~ac_exists, aq,
        torch.where((ac - al).abs() < (aq - al).abs(), ac, (aq + ac) / 2.0))

    a_s = _quad_minimizer_gg(al, at, gl, gt)
    # Case 2: ft <= fl, gt * gl < 0 (:152-155)
    res2 = torch.where((ac - at).abs() >= (a_s - at).abs(), ac, a_s)

    # Case 3: ft <= fl, gt * gl >= 0, |gt| < |gl| (:158-175)
    prefer_ac = ac_exists & ((ac - at) * (at - al) > 0.0) & \
        ((ac - at).abs() < (a_s - at).abs())
    res3_raw = torch.where(prefer_ac, ac, a_s)
    cap3 = at + deltau * (au - at)
    res3 = torch.where(at > al, torch.minimum(cap3, res3_raw),
                       torch.maximum(cap3, res3_raw))

    # Case 4: |gt| >= |gl| (:177-188)
    extrap = at + deltal * (at - al)
    ae, _ = _cubic_minimizer(at, au, ft, fu, gt, gu)
    res4 = torch.where(at > al, torch.minimum(cap3, ae),
                       torch.maximum(cap3, ae))
    res4 = torch.where(torch.isfinite(au) & torch.isfinite(fu) &
                       torch.isfinite(gu), res4, extrap)

    case1 = ft > fl
    case2 = gt * gl < 0.0
    case3 = gt.abs() < gl.abs()
    res = torch.where(case1, res1,
                      torch.where(case2, res2, torch.where(case3, res3, res4)))
    # ft or gt infinite -> midpoint (:131-132)
    res = torch.where(torch.isfinite(ft) & torch.isfinite(gt), res, mid)
    # al == au -> al (:127-128)
    return torch.where(al == au, al, res)


def _in_dtype(expr, dtype) -> float:
    """``expr`` evaluated on scalars of ``dtype`` (on the host), as a
    Python float that ``dtype`` holds exactly."""
    return expr(lambda v: torch.tensor(v, dtype=dtype)).item()


class _MTCarry(NamedTuple):
    step: Tensor
    fx: Tensor
    dg: Tensor
    x: Tensor
    grad: Tensor
    # bracketing interval
    i_lo: Tensor
    i_hi: Tensor
    fi_lo: Tensor
    fi_hi: Tensor
    gi_lo: Tensor
    gi_hi: Tensor
    psi_lo: Tensor
    # best-so-far (step = i_lo) objective state
    fx_lo: Tensor
    dg_lo: Tensor
    # safeguards
    bracketed: Tensor
    use_smin_sg: Tensor
    i_width: Tensor
    i_width_prev: Tensor
    shrink_fail: Tensor
    it: Tensor
    done: Tensor
    nfev: Tensor


def morethuente(fg, param, xp: Tensor, drt: Tensor, step_max, step0,
                fx0: Tensor, grad0: Tensor, dg0: Tensor,
                active: Optional[Tensor] = None,
                group=None) -> LineSearchResult:
    """Batched More-Thuente search from ``xp [B, n]`` along ``drt``;
    ``step_max`` and ``step0`` are scalars or [B] tensors.  ``group``: the
    vectors are this rank's feature block; a trial's value and
    directional derivative take one all-reduce."""
    dtype, dev = xp.dtype, xp.device

    def per_instance(v):
        return torch.as_tensor(v, dtype=dtype, device=dev).expand(
            fx0.shape).clone()

    step0 = per_instance(step0)
    step_max = per_instance(step_max)
    step_min = param.min_step
    ftol, wolfe = param.ftol, param.wolfe
    inf = torch.full_like(fx0, float("inf"))
    zero = torch.zeros_like(fx0)

    # Input validation (:360-366) and descent check (:376-377).
    invalid = (step0 <= 0.0) | (step0 < step_min) | (step0 > step_max)
    not_descent = dg0 >= 0.0
    pre_status = torch.where(
        invalid, i32_like(Status.LS_INVALID_STEP, fx0),
        torch.where(not_descent, i32_like(Status.LS_NOT_DESCENT, fx0),
                    i32_like(Status.RUNNING, fx0)))
    pre_fail = invalid | not_descent
    stopped = pre_fail if active is None else pre_fail | ~active

    fx_init = fx0
    test_decr = ftol * dg0          # psi slope (:381)
    test_curv = -wolfe * dg0        # curvature bound (:383)
    # Constants the reference computes in the solve's type.
    one_m_ftol = _in_dtype(lambda t: 1.0 - t(ftol), dtype)
    delta_min = _in_dtype(lambda t: t(7.0) / t(12.0), dtype)
    delta_max, shrink = 1.1, 0.66

    c = _MTCarry(
        step=step0, fx=fx0, dg=dg0, x=xp, grad=grad0,
        i_lo=zero, i_hi=inf, fi_lo=zero, fi_hi=inf,
        gi_lo=one_m_ftol * dg0, gi_hi=inf, psi_lo=zero,
        fx_lo=fx_init, dg_lo=dg0,
        bracketed=torch.zeros_like(stopped),
        use_smin_sg=torch.full_like(stopped, step_min > 0.0),
        i_width=inf, i_width_prev=inf,
        shrink_fail=i32_like(0, fx0), it=i32_like(0, fx0),
        done=stopped, nfev=i32_like(0, fx0))
    max_ls = param.max_linesearch

    def trial(c: _MTCarry) -> _MTCarry:
        # Trial evaluation (:412-414)
        x = xp + c.step[:, None] * drt
        fx, grad, dg = coll.evaluate(
            fg, x, lambda g: torch.linalg.vecdot(g, drt)[:, None], group,
            "morethuente.trial")
        dg = dg[:, 0]

        psit = fx - fx_init - c.step * test_decr
        dpsit = dg - test_decr

        # Exit tests (:428-447)
        converged = (psit <= 0.0) & (dg.abs() <= test_curv)
        exit_min = (c.step <= step_min) & ((psit > 0.0) | (dpsit >= 0.0))
        exit_max = (c.step >= step_max) & ((psit <= 0.0) & (dpsit < 0.0))
        done_now = converged | exit_min | exit_max

        ft, gt = psit, dpsit            # f stays psi (:449-461)

        # step_min safeguard (:464-471)
        use_sg = c.use_smin_sg & ~((psit <= 0.0) & (dpsit < 0.0))

        # New trial step (:473-514)
        in_case_2 = (psit <= c.psi_lo) & (dpsit * (c.i_lo - c.step) > 0.0)
        step_c2 = torch.minimum(step_max,
                                c.step + delta_max * (c.step - c.i_lo))
        sel = _step_selection(c.i_lo, c.i_hi, c.step, c.fi_lo, c.fi_hi, ft,
                              c.gi_lo, c.gi_hi, gt)
        sel = torch.minimum(torch.clamp(sel, min=step_min), step_max)
        sg_upper = torch.clamp(delta_min * c.step, min=step_min)
        sel_sg = torch.minimum(torch.clamp(sel, min=step_min), sg_upper)
        step_c13 = torch.where(use_sg, sel_sg, sel)
        new_step = torch.where(in_case_2, step_c2, step_c13)

        # 3-case interval update (:516-559), frozen on the terminating
        # trial.
        live = ~done_now
        case1 = psit > c.psi_lo
        case3 = (~case1) & (~in_case_2)
        i_hi = torch.where(live & case1, c.step,
                           torch.where(live & case3, c.i_lo, c.i_hi))
        fi_hi = torch.where(live & case1, ft,
                            torch.where(live & case3, c.fi_lo, c.fi_hi))
        gi_hi = torch.where(live & case1, gt,
                            torch.where(live & case3, c.gi_lo, c.gi_hi))
        take_lo = live & (~case1)
        i_lo = torch.where(take_lo, c.step, c.i_lo)
        fi_lo = torch.where(take_lo, ft, c.fi_lo)
        gi_lo = torch.where(take_lo, gt, c.gi_lo)
        psi_lo = torch.where(take_lo, psit, c.psi_lo)
        fx_lo = torch.where(take_lo, fx, c.fx_lo)
        dg_lo = torch.where(take_lo, dg, c.dg_lo)

        # bracketed status (:561-569)
        i_left = torch.minimum(i_lo, i_hi)
        i_right = torch.maximum(i_lo, i_hi)
        bracketed = c.bracketed | (live & (~in_case_2) &
                                   (i_left >= step_min) &
                                   (i_right <= step_max))

        # Forced bisection when the interval fails to shrink (:571-591)
        brk_live = live & bracketed
        i_width_prev = torch.where(brk_live, c.i_width, c.i_width_prev)
        i_width = torch.where(brk_live, (i_hi - i_lo).abs(), c.i_width)
        fail = (i_width_prev < float("inf")) & \
            (i_width > shrink * i_width_prev)
        shrink_fail = torch.where(
            brk_live, torch.where(fail, c.shrink_fail + 1,
                                  torch.zeros_like(c.shrink_fail)),
            c.shrink_fail)
        bisect = brk_live & (shrink_fail >= 2)
        new_step = torch.where(bisect, (i_lo + i_hi) / 2.0, new_step)
        shrink_fail = torch.where(bisect, torch.zeros_like(shrink_fail),
                                  shrink_fail)

        return _MTCarry(
            step=torch.where(done_now, c.step, new_step),
            fx=fx, dg=dg, x=x, grad=grad,
            i_lo=i_lo, i_hi=i_hi, fi_lo=fi_lo, fi_hi=fi_hi,
            gi_lo=gi_lo, gi_hi=gi_hi, psi_lo=psi_lo,
            fx_lo=fx_lo, dg_lo=dg_lo, bracketed=bracketed,
            use_smin_sg=torch.where(done_now, c.use_smin_sg, use_sg),
            i_width=i_width, i_width_prev=i_width_prev,
            shrink_fail=shrink_fail, it=c.it + 1, done=done_now,
            nfev=c.nfev + 1)

    searching = (~c.done) & (c.it < max_ls)
    while bool(searching.any()):
        c = tree_select(searching, trial(c), c)
        searching = (~c.done) & (c.it < max_ls)

    # Exhausted without termination: the best-so-far (_lo) state
    # (:602-614).  Its point is re-evaluated here instead of carried
    # through every trial; not counted in nfev, as in the reference.
    exhausted = (~c.done) & (~pre_fail)
    step = torch.where(exhausted, c.i_lo, c.step)
    fx = torch.where(exhausted, c.fx_lo, c.fx)
    dg = torch.where(exhausted, c.dg_lo, c.dg)
    x, grad = c.x, c.grad
    if bool(exhausted.any()):
        x_lo = xp + c.i_lo[:, None] * drt
        _, g_lo = fg(x_lo)
        x = torch.where(exhausted[:, None], x_lo, x)
        grad = torch.where(exhausted[:, None], g_lo, grad)

    # A pre-loop failure keeps the inputs untouched.
    pf = pre_fail[:, None]
    return LineSearchResult(
        step=torch.where(pre_fail, step0, step),
        fx=torch.where(pre_fail, fx0, fx),
        grad=torch.where(pf, grad0, grad),
        dg=torch.where(pre_fail, dg0, dg),
        x=torch.where(pf, xp, x),
        status=pre_status, nfev=c.nfev)
