"""Plain reference of the box multistart: pairwise Rosenbrock in a box,
solved by L-BFGS-B.

NumPy, one instance at a time, computing in the input's type (float64 for
:func:`judge`; the control of ``correct`` runs it in float32).  The
algorithm is LBFGS++'s L-BFGS-B (LBFGSB.h:117-262; BFGSMat.h's B-mode
middle matrix and its W/M products; Cauchy.h's generalized Cauchy point;
SubspaceMin.h's BOXCQP subspace step with its three-level fallback;
LineSearchMoreThuente.h) in the same branch order, transcribed from the
repository's scalar test oracle (tests/oracle_b.py, and tests/oracle.py's
history and More-Thuente search); it imports nothing of the program.

:func:`judge` holds the program's answers for a sample of the window's
instances against it (see the numbers there).
"""

from __future__ import annotations

import numpy as np

from portbench.reference.rosenbrock100_multistart import fg

CONVERGED, CONVERGED_DELTA, MAX_ITERATIONS, LS_FAILED = 0, 1, 2, 3


class _Failed(Exception):
    """Where the reference's search throws."""


def _dot(a, b):
    return np.dot(a, b)


class _History:
    """The (s, y) ring with the 2m x 2m middle matrix (BFGSMat.h:61-146,
    B-mode) and its W/M products (BFGSMat.h:304-615), in compact
    ``[2 ncorr]`` layout like the reference."""

    def __init__(self, n, m, dt):
        self.n, self.m, self.dt = n, m, dt
        self.s = np.zeros((m, n), dt)
        self.y = np.zeros((m, n), dt)
        self.ys = np.zeros(m, dt)
        self.theta = dt.type(1.0)
        self.ncorr = 0
        self.ptr = m
        self.minv = np.eye(2 * m, dtype=dt)     # S'S unscaled

    def reset(self):
        self.__init__(self.n, self.m, self.dt)

    def _scaled_minv(self):
        m = self.m
        sc = self.minv.copy()
        sc[m:, m:] *= self.theta
        return sc

    def add(self, s, y):
        m = self.m
        loc = self.ptr % m
        self.s[loc], self.y[loc] = s, y
        ys = _dot(s, y)
        self.ys[loc] = ys
        self.theta = _dot(y, y) / ys
        if self.ncorr < m:
            self.ncorr += 1
        self.ptr = loc + 1
        ncorr = self.ncorr
        self.minv[loc, loc] = -ys
        ss = self.s[:ncorr] @ self.s[loc]
        self.minv[m + loc, m:m + ncorr] = ss
        self.minv[m:m + ncorr, m + loc] = ss
        # the overwritten y's stale column, then the new L row
        if ncorr >= m:
            self.minv[m:, loc] = 0.0
            self.minv[loc, m:] = 0.0
        yloc = (loc + m - 1) % m
        for _ in range(ncorr - 1):
            v = self.s[loc] @ self.y[yloc]
            self.minv[m + loc, yloc] = v
            self.minv[yloc, m + loc] = v
            yloc = (yloc + m - 1) % m

    def wtv(self, v):
        c = self.ncorr
        return np.concatenate([self.y[:c] @ v, self.theta * (self.s[:c] @ v)])

    def mv(self, v):
        c, m = self.ncorr, self.m
        if c < 1:
            return np.zeros(0, self.dt)
        pad = np.zeros(2 * m, self.dt)
        pad[:c] = v[:c]
        pad[m:m + c] = v[c:]
        sol = np.linalg.solve(self._scaled_minv(), pad)
        return np.concatenate([sol[:c], sol[m:m + c]])

    def wb(self, b):
        c = self.ncorr
        return np.concatenate([self.y[:c, b], self.theta * self.s[:c, b]])

    def wtpv(self, p_set, v):
        c = self.ncorr
        res = np.zeros(2 * c, self.dt)
        if c < 1 or len(p_set) < 1:
            return res
        for j in range(c):
            res[j] = self.y[j][p_set] @ v
            res[c + j] = self.s[j][p_set] @ v
        res[c:] *= self.theta
        return res

    def ptwmv(self, p_set, v, scale):
        c = self.ncorr
        res = np.zeros(len(p_set), self.dt)
        if c < 1 or len(p_set) < 1:
            return res
        mv = self.mv(v)
        mv[c:] *= self.theta
        for j in range(c):
            res += mv[j] * self.y[j][p_set] + mv[c + j] * self.s[j][p_set]
        return scale * res

    def ftbab(self, fv_set, newact_set, drt):
        c = self.ncorr
        nfree = len(fv_set)
        if c < 1 or len(newact_set) < 1 or nfree < 1:
            return np.zeros(nfree, self.dt)
        rhs = self.wtpv(newact_set, drt[newact_set])
        return self.ptwmv(fv_set, rhs, -1.0)

    def solve_ptbp(self, p_set, v):
        """inv(P'BP) v (BFGSMat::solve_PtBP, BFGSMat.h:529-565)."""
        c, m, th = self.ncorr, self.m, self.theta
        if c < 1 or len(p_set) < 1:
            return v / th
        wp_y = self.y[:c][:, p_set].T
        wp_s = self.s[:c][:, p_set].T
        mid = np.zeros((2 * c, 2 * c), self.dt)
        mid[:c, :c] = self.minv[:c, :c] - wp_y.T @ wp_y / th
        mid[c:, :c] = self.minv[m:m + c, :c] - wp_s.T @ wp_y
        mid[:c, c:] = mid[c:, :c].T
        mid[c:, c:] = th * (self.minv[m:m + c, m:m + c] - wp_s.T @ wp_s)
        wpv = np.concatenate([wp_y.T @ v, th * (wp_s.T @ v)])
        z = np.linalg.solve(mid, wpv)
        z[c:] *= th
        return v / th + (wp_y @ z[:c] + wp_s @ z[c:]) / (th * th)

    def ptbqv(self, p_set, q_set, v):
        c = self.ncorr
        if c < 1 or len(p_set) < 1 or len(q_set) < 1:
            return np.zeros(len(p_set), self.dt)
        mv = self.mv(self.wtpv(q_set, v))
        mv[c:] *= self.theta
        res = np.zeros(len(p_set), self.dt)
        for j in range(c):
            res += mv[j] * self.y[j][p_set] + mv[c + j] * self.s[j][p_set]
        return -res


def cauchy_point(bfgs, x0, g, lb, ub, tiny):
    """The generalized Cauchy point (Cauchy.h:86-284): ``(xcp, newact,
    fv)``."""
    n = len(x0)
    xcp = x0.copy()
    c = bfgs.ncorr
    vecc = np.zeros(2 * c, x0.dtype)
    newact_set, fv_set = [], []
    brk = np.zeros(n, x0.dtype)
    vecd = np.zeros(n, x0.dtype)
    ord_ = []
    for i in range(n):
        if lb[i] == ub[i]:
            brk[i] = 0.0
        elif g[i] < 0:
            brk[i] = (x0[i] - ub[i]) / g[i]
        elif g[i] > 0:
            brk[i] = (x0[i] - lb[i]) / g[i]
        else:
            brk[i] = np.inf
        iszero = brk[i] == 0.0
        vecd[i] = 0.0 if iszero else -g[i]
        if brk[i] == np.inf:
            fv_set.append(i)
        elif not iszero:
            ord_.append(i)
    ord_.sort(key=lambda i: brk[i])
    nord, nfree = len(ord_), len(fv_set)
    if nfree < 1 and nord < 1:
        return xcp, newact_set, fv_set

    vecp = bfgs.wtv(vecd)
    fp = -(vecd @ vecd)
    cache = bfgs.mv(vecp)
    fpp = -bfgs.theta * fp - vecp @ cache if c >= 1 else -bfgs.theta * fp
    deltatmin = -fp / fpp
    il = 0.0
    b = 0
    iu = np.inf if nord < 1 else brk[ord_[b]]
    deltat = iu - il
    crossed_all = False
    while deltatmin >= deltat:
        vecc = vecc + deltat * vecp
        act_begin = b
        i = b
        while i < nord and brk[ord_[i]] <= iu:
            i += 1
        act_end = i - 1
        if nfree == 0 and act_end == nord - 1:
            for i in range(act_begin, act_end + 1):
                act = ord_[i]
                xcp[act] = ub[act] if vecd[act] > 0 else lb[act]
                newact_set.append(act)
            crossed_all = True
            break
        fp += deltat * fpp
        for i in range(act_begin, act_end + 1):
            act = ord_[i]
            xcp[act] = ub[act] if vecd[act] > 0 else lb[act]
            zact = xcp[act] - x0[act]
            gact = g[act]
            ggact = gact * gact
            wact = bfgs.wb(act)
            cache = bfgs.mv(wact)
            fp += ggact + bfgs.theta * gact * zact - gact * (cache @ vecc)
            fpp -= (bfgs.theta * ggact + 2 * gact * (cache @ vecp) +
                    ggact * (cache @ wact))
            vecp = vecp + gact * wact
            vecd[act] = 0.0
            newact_set.append(act)
        deltatmin = -fp / fpp
        il = iu
        b = act_end + 1
        if b >= nord:
            break
        iu = brk[ord_[b]]
        deltat = iu - il

    if fpp < tiny:
        deltatmin = -fp / tiny
    if not crossed_all:
        deltatmin = max(deltatmin, 0.0)
        tfinal = il + deltatmin
        for coord in fv_set:
            xcp[coord] = x0[coord] + tfinal * vecd[coord]
        for i in range(b, nord):
            coord = ord_[i]
            xcp[coord] = x0[coord] + tfinal * vecd[coord]
            fv_set.append(coord)
    return xcp, newact_set, fv_set


def subspace_minimize(bfgs, x0, xcp, g, lb, ub, newact_set, fv_set, maxit,
                      tiny):
    """The BOXCQP subspace step (SubspaceMin.h:122-302): the direction."""
    drt = xcp - x0
    nfree = len(fv_set)
    if nfree < 1:
        return drt
    fv = np.asarray(fv_set, dtype=int)
    vecc = bfgs.ftbab(fv, np.asarray(newact_set, int), drt)
    vecl = lb[fv] - x0[fv]
    vecu = ub[fv] - x0[fv]
    vecc = vecc + g[fv]
    vecy = bfgs.solve_ptbp(fv, -vecc)
    if np.all((vecy >= vecl) & (vecy <= vecu)):
        drt[fv] = vecy
        return drt

    yfallback = vecy.copy()
    lam = np.zeros(nfree, x0.dtype)
    mu = np.zeros(nfree, x0.dtype)
    k = 0
    while k < maxit:
        yl, yu, yp = [], [], []
        for i in range(nfree):
            li, ui = vecl[i], vecu[i]
            if vecy[i] < li or (vecy[i] == li and lam[i] >= 0):
                yl.append(i)
                vecy[i] = li
                mu[i] = 0.0
            elif vecy[i] > ui or (vecy[i] == ui and mu[i] >= 0):
                yu.append(i)
                vecy[i] = ui
                lam[i] = 0.0
            else:
                yp.append(i)
                lam[i] = 0.0
                mu[i] = 0.0
        l_set, u_set, p_set = fv[yl], fv[yu], fv[yp]
        if len(yp) > 0:
            rhs = vecc[yp].copy()
            rhs = rhs + bfgs.ptbqv(p_set, l_set, vecl[yl])
            rhs = rhs + bfgs.ptbqv(p_set, u_set, vecu[yu])
            vecy[yp] = bfgs.solve_ptbp(p_set, -rhs)
        if len(yl) > 0 or len(yu) > 0:
            fy = bfgs.wtpv(fv, vecy)
        if len(yl) > 0:
            res = bfgs.ptwmv(l_set, fy, -1.0)
            lam[yl] = res + vecc[yl] + bfgs.theta * vecy[yl]
        if len(yu) > 0:
            res = bfgs.ptwmv(u_set, fy, -1.0)
            mu[yu] = -(res + vecc[yu] + bfgs.theta * vecy[yu])
        k += 1
        if np.all(lam[yl] >= 0) and np.all(mu[yu] >= 0) and \
                np.all((vecy[yp] >= vecl[yp]) & (vecy[yp] <= vecu[yp])):
            break
    else:
        # no convergence in maxit: the three-level fallback
        drt[fv] = np.clip(vecy, vecl, vecu)
        if drt @ g <= -tiny:
            return drt
        drt[fv] = np.clip(yfallback, vecl, vecu)
        if drt @ g <= -tiny:
            return drt
        drt[fv] = yfallback
        return drt
    drt[fv] = vecy
    return drt


def _cubic_minimizer(a, b, fa, fb, ga, gb, tiny):
    apb = a + b
    ba = b - a
    ba2 = ba * ba
    fba = fb - fa
    gba = gb - ga
    z3 = (ga + gb) * ba - 2 * fba
    z2 = 0.5 * (gba * ba2 - 3 * apb * z3)
    z1 = fba * ba2 - apb * z2 - (a * apb + b * b) * z3
    if abs(z3) < tiny * abs(z2) or abs(z3) < tiny * abs(z1):
        exists = z2 * ba > 0
        return (-0.5 * z1 / z2 if exists else b), exists
    u = z2 / (3 * z3)
    v = z1 / z2
    vu = v / u
    exists = vu <= 1
    if not exists:
        return b, exists
    if abs(u) >= abs(v):
        w = 1 + np.sqrt(1 - vu)
        r1, r2 = -u * w, -v / w
    else:
        sqrtd = np.sqrt(abs(u)) * np.sqrt(abs(v)) * np.sqrt(1 - u / v)
        r1, r2 = -u - sqrtd, -u + sqrtd
    return (max(r1, r2) if z3 * ba > 0 else min(r1, r2)), exists


def _step_selection(al, au, at, fl, fu, ft, gl, gu, gt, tiny):
    if al == au:
        return al
    if not np.isfinite(ft) or not np.isfinite(gt):
        return (al + at) / 2
    ac, ac_exists = _cubic_minimizer(al, at, fl, ft, gl, gt, tiny)
    ba = at - al
    aq = al + 0.5 * ba * gl / (fl - ft + ba * gl) * ba
    if ft > fl:
        if not ac_exists:
            return aq
        return ac if abs(ac - al) < abs(aq - al) else (aq + ac) / 2
    a_s = al + gl / (gl - gt) * (at - al)
    if gt * gl < 0:
        return ac if abs(ac - at) >= abs(a_s - at) else a_s
    deltal, deltau = 1.1, 0.66
    if abs(gt) < abs(gl):
        res = ac if (ac_exists and (ac - at) * (at - al) > 0
                     and abs(ac - at) < abs(a_s - at)) else a_s
        if at > al:
            return min(at + deltau * (au - at), res)
        return max(at + deltau * (au - at), res)
    if not np.isfinite(au) or not np.isfinite(fu) or not np.isfinite(gu):
        return at + deltal * (at - al)
    ae, _ = _cubic_minimizer(at, au, ft, fu, gt, gu, tiny)
    if at > al:
        return min(at + deltau * (au - at), ae)
    return max(at + deltau * (au - at), ae)


def _morethuente(p, xp, drt, step_max, step, fx, grad, dg, tiny):
    """LineSearchMoreThuente.h: ``(x, fx, grad)``, or raises
    :class:`_Failed` where the reference throws."""
    step_min = p["min_step"]
    if step <= 0:
        raise _Failed("step must be positive")
    if step < step_min:
        raise _Failed("step < min_step")
    if step > step_max:
        raise _Failed("step > step_max")
    fx_init, dg_init = fx, dg
    if dg_init >= 0:
        raise _Failed("not a descent direction")
    test_decr = p["ftol"] * dg_init
    test_curv = -p["wolfe"] * dg_init
    i_lo, i_hi = 0.0, np.inf
    fi_lo, fi_hi = 0.0, np.inf
    gi_lo, gi_hi = (1 - p["ftol"]) * dg_init, np.inf
    psi_lo = fi_lo
    x_lo, grad_lo, fx_lo = xp.copy(), grad.copy(), fx_init
    bracketed = False
    use_sg = step_min > 0
    width = width_prev = np.inf
    shrink_fail = 0
    delta_max, delta_min, shrink = 1.1, 7.0 / 12.0, 0.66
    for _ in range(p["max_linesearch"]):
        x = xp + step * drt
        fx, grad = fg(x)
        dg = _dot(grad, drt)
        psit = fx - fx_init - step * test_decr
        dpsit = dg - test_decr
        if psit <= 0 and abs(dg) <= test_curv:
            return x, fx, grad
        if step <= step_min and (psit > 0 or dpsit >= 0):
            return x, fx, grad
        if step >= step_max and (psit <= 0 and dpsit < 0):
            return x, fx, grad
        ft, gt = psit, dpsit
        if use_sg and (psit <= 0 and dpsit < 0):
            use_sg = False
        in_case_2 = (psit <= psi_lo) and (dpsit * (i_lo - step) > 0)
        if in_case_2:
            new_step = min(step_max, step + delta_max * (step - i_lo))
        else:
            new_step = _step_selection(i_lo, i_hi, step, fi_lo, fi_hi, ft,
                                       gi_lo, gi_hi, gt, tiny)
            new_step = min(max(new_step, step_min), step_max)
            if use_sg:
                new_step = min(max(new_step, step_min),
                               max(step_min, delta_min * step))
        if psit > psi_lo:
            i_hi, fi_hi, gi_hi = step, ft, gt
        elif in_case_2:
            i_lo, fi_lo, gi_lo, psi_lo = step, ft, gt, psit
            x_lo, grad_lo, fx_lo = x.copy(), grad.copy(), fx
        else:
            i_hi, fi_hi, gi_hi = i_lo, fi_lo, gi_lo
            i_lo, fi_lo, gi_lo, psi_lo = step, ft, gt, psit
            x_lo, grad_lo, fx_lo = x.copy(), grad.copy(), fx
        if not bracketed and not in_case_2:
            bracketed = (min(i_lo, i_hi) >= step_min and
                         max(i_lo, i_hi) <= step_max)
        if bracketed:
            width_prev = width
            width = abs(i_hi - i_lo)
            if width_prev < np.inf and width > shrink * width_prev:
                shrink_fail += 1
            else:
                shrink_fail = 0
            if shrink_fail >= 2:
                new_step = (i_lo + i_hi) / 2
                shrink_fail = 0
        step = new_step
    return x_lo, fx_lo, grad_lo


def _max_step(x, drt, lb, ub):
    step = np.inf
    for i in range(len(x)):
        if drt[i] > 0:
            step = min(step, (ub[i] - x[i]) / drt[i])
        elif drt[i] < 0:
            step = min(step, (lb[i] - x[i]) / drt[i])
    return step


def _pg_norm(x, g, lb, ub):
    return np.max(np.abs(np.clip(x - g, lb, ub) - x))


def solve(x0, p, tiny=np.finfo(np.float64).eps):
    """L-BFGS-B from the NumPy array ``x0`` in its own type, in the box of
    ``p`` (``p["lb"]``, ``p["ub"]``; ``tiny`` is the type's epsilon):
    ``(x, fx, status)``; a failed search ends the solve at the last
    accepted point."""
    x0 = np.asarray(x0)
    dt = x0.dtype
    lb, ub = (np.asarray(p[k], dt) for k in ("lb", "ub"))
    m, past = p["m"], p["past"]
    x = np.clip(x0.copy(), lb, ub)
    bfgs = _History(len(x), m, dt)
    fx_hist = np.zeros(max(past, 1), dt)
    fx, grad = fg(x)
    if past > 0:
        fx_hist[0] = fx

    def converged(x, grad):
        pg = _pg_norm(x, grad, lb, ub)
        return pg <= p["epsilon"] or pg <= p["epsilon_rel"] * \
            np.linalg.norm(x)

    if converged(x, grad):
        return x, fx, CONVERGED
    xcp, _, _ = cauchy_point(bfgs, x, grad, lb, ub, tiny)
    drt = xcp - x
    nrm = np.linalg.norm(drt)
    if nrm > 0:
        drt = drt / nrm
    k = 1
    while True:
        xp, gradp = x.copy(), grad.copy()
        dg = _dot(grad, drt)
        step_max = _max_step(x, drt, lb, ub)
        if dg >= 0 or step_max <= p["min_step"]:
            drt = xcp - x
            bfgs.reset()
            dg = _dot(grad, drt)
            step_max = _max_step(x, drt, lb, ub)
        step_max = min(p["max_step"], step_max)
        step = min(1.0, step_max)
        try:
            x, fx, grad = _morethuente(p, xp, drt, step_max, step, fx, grad,
                                       dg, tiny)
        except _Failed:
            return xp, fg(xp)[0], LS_FAILED
        if converged(x, grad):
            return x, fx, CONVERGED
        if past > 0:
            fxd = fx_hist[k % past]
            if k >= past and abs(fxd - fx) <= \
                    p["delta"] * max(max(abs(fx), abs(fxd)), 1.0):
                return x, fx, CONVERGED_DELTA
            fx_hist[k % past] = fx
        if p["max_iterations"] and k >= p["max_iterations"]:
            return x, fx, MAX_ITERATIONS
        vecs, vecy = x - xp, grad - gradp
        if _dot(vecs, vecy) > tiny * _dot(vecy, vecy):
            bfgs.add(vecs, vecy)
        x = np.clip(x, lb, ub)
        xcp, newact, fv = cauchy_point(bfgs, x, grad, lb, ub, tiny)
        drt = subspace_minimize(bfgs, x, xcp, grad, lb, ub, newact, fv,
                                p["max_submin"], tiny)
        k += 1


def box(bounds):
    """``(lb, ub)`` float64 arrays of a configuration's ``bounds``: a
    ``[lo, hi]`` pair a coordinate, ``null`` for no bound."""
    lo = [-np.inf if b[0] is None else b[0] for b in bounds]
    hi = [np.inf if b[1] is None else b[1] for b in bounds]
    return np.array(lo, np.float64), np.array(hi, np.float64)


def params(over: dict) -> dict:
    """LBFGS++'s L-BFGS-B defaults (Param.h, LBFGSBParam) with ``over``
    applied; its ``bounds`` become ``lb`` and ``ub``."""
    p = dict(m=6, epsilon=1e-5, epsilon_rel=1e-5, past=1, delta=1e-10,
             max_iterations=0, max_submin=10, max_linesearch=20,
             min_step=1e-20, max_step=1e20, ftol=1e-4, wolfe=0.9)
    p.update(over)
    p["lb"], p["ub"] = box(p.pop("bounds"))
    return p


def judge(sample: dict, ctx) -> dict:
    """The run's numbers: :func:`compare`."""
    return compare(sample, ctx.cfg, ctx.traffic["check"])


def compare(sample: dict, cfg: dict, check: dict) -> dict:
    """The numbers that decide ``correct`` for a sample of the window's
    instances.  ``sample``: the starts ``x0 [S, n]``, the program's
    answers ``x [S, n]`` and its values ``fx [S]`` (float64 NumPy).  The
    reference solves each start with ``check["reference"]``'s parameters
    and bounds (the configuration's) in float64 and gives:

    * ``infeasible``: the number of answers outside their box (or not
      finite);
    * ``disputed``: the share of the sample whose answer the reference
      disputes: the reference brings the start within the quality bar
      (``max|x - x_star| <= bar``) and the program does not, or the value
      the program reports is off the value at its own answer by more than
      ``check["fx_tol"]`` (relative);
    * ``fx_gap``: the largest relative gap of a reported value;
    * ``x_gap_median``, ``x_gap``: over the instances the reference
      solves, the median and the largest of ``max|x - x_ref|``.
    """
    p = params(check["reference"])
    lb, ub = box(cfg["bounds"])
    if not (np.array_equal(lb, p["lb"]) and np.array_equal(ub, p["ub"])):
        raise ValueError("the reference's bounds are not the "
                         "configuration's")
    star, bar = np.asarray(cfg["x_star"], np.float64), cfg["bar"]
    x0, x = sample["x0"], sample["x"]
    refs = np.stack([solve(row, p)[0] for row in x0]) if len(x0) \
        else np.zeros_like(x)
    ok_prog = np.abs(x - star).max(1) <= bar
    ok_ref = np.abs(refs - star).max(1) <= bar
    f = np.array([fg(row)[0] for row in x])
    rel = np.abs(sample["fx"] - f) / np.maximum(np.abs(f), 1e-20)
    disputed = (ok_ref & ~ok_prog) | (rel > check["fx_tol"])
    gaps = np.abs(x - refs).max(1)[ok_ref]
    return dict(
        sample=float(len(x0)), frac_program=float(ok_prog.mean()),
        frac_reference=float(ok_ref.mean()),
        infeasible=float((~((x >= lb) & (x <= ub))).any(1).sum()),
        disputed=float(disputed.mean()), fx_gap=float(rel.max()),
        x_gap_median=float(np.median(gaps)) if gaps.size else np.inf,
        x_gap=float(gaps.max()) if gaps.size else np.inf)
