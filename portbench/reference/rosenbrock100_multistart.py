"""Plain reference of the multistart: pairwise Rosenbrock, solved by L-BFGS.

NumPy, one instance at a time, in float64 (:func:`solve` also runs on
plain PyTorch CPU tensors, for the controls in lower precisions).  The
algorithm is LBFGS++'s (LBFGS.h:79-173, BFGSMat.h's two-loop recursion,
and LineSearchNocedalWright.h or LineSearchBracketing.h, as the parameters'
``line_search`` names) in the same branch order, transcribed from the
repository's scalar test oracle (tests/oracle.py:17-61, :100-212,
:368-419); it imports nothing of the program.

:func:`judge` holds the program's answers for a sample of the window's
instances against it (see the numbers there).
"""

from __future__ import annotations

import math

import numpy as np

CONVERGED, LS_FAILED, MAX_ITERATIONS = 0, 1, 2


def fg(x):
    """Pairwise Rosenbrock (examples/example-rosenbrock.cpp:14-29) and its
    gradient, in ``x``'s type: for even i, ``(1 - x_i)^2 + (10 (x_{i+1} -
    x_i^2))^2``."""
    xe, xo = x[0::2], x[1::2]
    t1 = 1.0 - xe
    t2 = 10.0 * (xo - xe * xe)
    grad = x * 0
    go = 20.0 * t2
    grad[1::2] = go
    grad[0::2] = -2.0 * (xe * go + t1)
    return (t1 * t1 + t2 * t2).sum(), grad


class _History:
    """The (s, y) ring and the two-loop recursion (BFGSMat.h:61-302)."""

    def __init__(self, x, m):
        self.m, self.ncorr, self.ptr = m, 0, m
        self.s, self.y = [None] * m, [None] * m
        self.ys = [None] * m
        self.theta = None

    def add(self, s, y):
        loc = self.ptr % self.m
        self.s[loc], self.y[loc] = s, y
        ys = _dot(s, y)
        self.ys[loc] = ys
        self.theta = _dot(y, y) / ys
        self.ncorr = min(self.ncorr + 1, self.m)
        self.ptr = loc + 1

    def apply_hv(self, v, a):
        res = a * v
        alpha = [None] * self.m
        j, order = self.ptr % self.m, []
        for _ in range(self.ncorr):
            j = (j + self.m - 1) % self.m
            alpha[j] = _dot(self.s[j], res) / self.ys[j]
            res = res - alpha[j] * self.y[j]
            order.append(j)
        if self.ncorr:
            res = res / self.theta
        for j in reversed(order):
            beta = _dot(self.y[j], res) / self.ys[j]
            res = res + (alpha[j] - beta) * self.s[j]
        return res


class _Failed(Exception):
    pass


def _dot(a, b):
    return (a * b).sum()


def _norm(a):
    return _dot(a, a) ** 0.5


def _quad_interp(step_lo, step_hi, fx_lo, fx_hi, dg_lo):
    fdiff, sdiff = fx_hi - fx_lo, step_hi - step_lo
    smid = (step_hi + step_lo) / 2
    den = float(fdiff - sdiff * dg_lo)
    cand = float(fdiff * step_lo - smid * sdiff * dg_lo) / den if den \
        else float("nan")
    near_end = min(abs(cand - step_lo), abs(cand - step_hi)) < \
        0.01 * abs(sdiff)
    if (not np.isfinite(cand) or cand <= min(step_lo, step_hi)
            or cand >= max(step_lo, step_hi) or near_end):
        return smid
    return cand


def _nocedal_wright(p, xp, drt, step, fx_init, grad, dg_init):
    """LineSearchNocedalWright.h: ``(x, fx, grad, nfev)``, or raises
    :class:`_Failed` where the reference throws."""
    if dg_init > 0:
        raise _Failed("not a descent direction")
    test_decr, test_curv = p["ftol"] * dg_init, -p["wolfe"] * dg_init
    step_lo, fx_lo, dg_lo = 0.0, fx_init, dg_init
    x_lo, grad_lo = xp, grad
    nfev = it = 0
    while True:
        x = xp + step * drt
        fx, g = fg(x)
        dg = _dot(g, drt)
        nfev += 1
        if fx - fx_init > step * test_decr or (0 < step_lo and fx >= fx_lo):
            step_hi, fx_hi = step, fx
            break
        if abs(dg) <= test_curv:
            return x, fx, g, nfev
        step_hi, fx_hi = step_lo, fx_lo
        step_lo, fx_lo, dg_lo, x_lo, grad_lo = step, fx, dg, x, g
        if dg >= 0:
            break
        it += 1
        if it >= p["max_linesearch"]:
            return x, fx, g, nfev
        step *= 2.0
    while True:
        step = _quad_interp(step_lo, step_hi, fx_lo, fx_hi, dg_lo)
        x = xp + step * drt
        fx, g = fg(x)
        dg = _dot(g, drt)
        nfev += 1
        if fx - fx_init > step * test_decr or fx >= fx_lo:
            if step == step_hi:
                raise _Failed("insufficient precision")
            step_hi, fx_hi = step, fx
        else:
            if abs(dg) <= test_curv:
                return x, fx, g, nfev
            if dg * (step_hi - step_lo) >= 0:
                step_hi, fx_hi = step_lo, fx_lo
            if step == step_lo:
                raise _Failed("insufficient precision")
            step_lo, fx_lo, dg_lo, x_lo, grad_lo = step, fx, dg, x, g
        it += 1
        if it >= p["max_linesearch"]:
            if step_lo <= 0:
                raise _Failed("unable to decrease")
            return x_lo, fx_lo, grad_lo, nfev


def _bracketing(p, xp, drt, step, fx_init, grad, dg_init):
    """LineSearchBracketing.h: ``(x, fx, grad, nfev)``, or raises
    :class:`_Failed` where the reference throws."""
    if dg_init > 0:
        raise _Failed("not a descent direction")
    test_decr = p["ftol"] * dg_init
    step_lo, step_hi = 0.0, math.inf
    for nfev in range(1, p["max_linesearch"] + 1):
        x = xp + step * drt
        fx, g = fg(x)
        if not math.isfinite(float(fx)) or fx > fx_init + step * test_decr:
            step_hi = step
        else:
            dg = _dot(g, drt)
            if p["linesearch"] == 1:
                return x, fx, g, nfev
            if dg < p["wolfe"] * dg_init:
                step_lo = step
            elif p["linesearch"] == 2:
                return x, fx, g, nfev
            elif dg > -p["wolfe"] * dg_init:
                step_hi = step
            else:
                return x, fx, g, nfev
        if step_lo > step_hi or not p["min_step"] <= step <= p["max_step"]:
            raise _Failed("bracket inverted or step out of range")
        step = 2 * step if math.isinf(step_hi) else \
            step_lo / 2 + step_hi / 2
    raise _Failed("max_linesearch reached")


SEARCHES = {"nocedalwright": _nocedal_wright, "bracketing": _bracketing}


def solve(x0, p, tiny=np.finfo(np.float64).eps):
    """L-BFGS from ``x0`` (LBFGS.h:79-173) with the parameters' line search, in
    ``x0``'s type (a NumPy array, or a CPU tensor of a type NumPy lacks;
    ``tiny`` is that type's epsilon): ``(x, fx, status)``; a failed search
    ends the solve at the last accepted point."""
    x = x0
    hist = _History(x, p["m"])
    fx, grad = fg(x)
    eps, eps_rel = p["epsilon"], p["epsilon_rel"]

    def converged(g, x):
        gn = _norm(g)
        return gn <= eps or gn <= eps_rel * _norm(x)

    if converged(grad, x):
        return x, fx, CONVERGED
    search = SEARCHES[p["line_search"]]
    drt, step, k = -grad, 1.0 / float(_norm(grad)), 1
    while True:
        xp, gp = x, grad
        try:
            x, fx, grad, _ = search(p, xp, drt, step, fx, grad,
                                    _dot(grad, drt))
        except _Failed:
            return xp, fg(xp)[0], LS_FAILED
        if converged(grad, x):
            return x, fx, CONVERGED
        if p["max_iterations"] and k >= p["max_iterations"]:
            return x, fx, MAX_ITERATIONS
        s, y = x - xp, grad - gp
        if _dot(s, y) > tiny * _dot(y, y):
            hist.add(s, y)
        drt, step, k = hist.apply_hv(grad, -1.0), 1.0, k + 1


def params(over: dict) -> dict:
    """LBFGS++'s defaults (Param.h:168-184) and its Nocedal-Wright search,
    with ``over`` applied."""
    p = dict(m=6, epsilon=1e-5, epsilon_rel=1e-5, max_iterations=0,
             linesearch=3, max_linesearch=20, min_step=1e-20,
             max_step=1e20, ftol=1e-4, wolfe=0.9,
             line_search="nocedalwright")
    p.update(over)
    return p


def judge(sample: dict, ctx) -> dict:
    """The run's numbers: :func:`compare`."""
    return compare(sample, ctx.cfg, ctx.traffic["check"])


def compare(sample: dict, cfg: dict, check: dict) -> dict:
    """The numbers that decide ``correct`` for a sample of the window's
    instances.  ``sample``: the starts ``x0 [S, n]``, the program's
    answers ``x [S, n]`` and, where the program reports it, its ``fx
    [S]`` (float64 NumPy).  The reference solves each start with
    ``check["reference"]``'s parameters in float64 and gives:

    * ``disputed``: the share of the sample whose answer the reference
      disputes: the reference brings the start within the quality bar and
      the program does not, or the value the program reports for its
      answer is off the reference's value at that answer by more than
      ``check["fx_tol"]`` (relative; where the program reports values);
    * ``solved_short``: the share the reference brings within the bar and
      the program does not, less the share the program brings there and
      the reference does not, at least 0;
    * ``fx_gap``: the largest relative gap of a reported value;
    * ``x_gap_median``: over the instances the reference solves, the
      median of ``max|x - x_ref|``.
    """
    bar, star = cfg["bar"], cfg["x_star"]
    p = params(check["reference"])
    x0, x = sample["x0"], sample["x"]
    refs = np.stack([solve(row, p)[0] for row in x0])
    ok_prog = np.abs(x - star).max(1) <= bar
    ok_ref = np.abs(refs - star).max(1) <= bar
    disputed = ok_ref & ~ok_prog
    out = dict(sample=float(len(x0)), frac_program=float(ok_prog.mean()),
               frac_reference=float(ok_ref.mean()),
               solved_short=max(0.0, float(ok_ref.mean() - ok_prog.mean())))
    if sample.get("fx") is not None:
        f = np.array([fg(row)[0] for row in x])
        rel = np.abs(sample["fx"] - f) / np.maximum(np.abs(f), 1e-20)
        out["fx_gap"] = float(rel.max())
        disputed = disputed | (rel > check["fx_tol"])
    out["disputed"] = float(disputed.mean())
    gaps = np.abs(x - refs).max(1)[ok_ref]
    out["x_gap_median"] = float(np.median(gaps)) if gaps.size else float(
        "inf")
    return out
