"""Box-constrained L-BFGS-B solver, batched.

The port's counterpart of ``lbfgspp_tpu.lbfgsb`` (LBFGS++'s LBFGSB.h:
117-262).  As in :mod:`.lbfgs`, the state carries a leading batch axis, a
step runs for the whole batch, and finished instances keep their state
through :func:`..types.freeze_when`.  Bounds are shared ``[n]`` or
per-instance ``[B, n]``; entries may be infinite, and ``lb == ub`` pins a
variable.

Per instance, as in the reference: the start is projected into the box
and the first direction is ``normalize(xcp - x)``; convergence is tested
on the infinity norm of the projected gradient ``||P(x - g) - x||_inf <=
max(epsilon, epsilon_rel ||x||)`` plus the past/delta test; the step is
capped by the box (``step_max``, a min over the bound gaps) with ``step0 =
min(1, step_max)``; a direction with ``dg >= 0`` or ``step_max <=
min_step`` is replaced by ``xcp - x`` and the whole matrix is reset; the
history takes a correction under ``s'y > eps * y'y``; the next GCP is
taken at the projected iterate with the search's gradient.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from .lbfgs import Solver, as_batch, unbatch
from .linesearch import get_line_search
from .ops import bmat, cauchy, subspace
from .parallel import collectives as coll
from .params import LBFGSBParams
from .types import (SolveResult, Status, freeze_when, i32_like,
                    make_fun_and_grad, resolve_device, tree_select)

Tensor = torch.Tensor


def force_bounds(x: Tensor, lb: Tensor, ub: Tensor) -> Tensor:
    """Project onto the box (LBFGSB.h:55-58)."""
    return torch.minimum(torch.maximum(x, lb), ub)


def proj_grad_norm(x: Tensor, g: Tensor, lb: Tensor, ub: Tensor,
                   group=None) -> Tensor:
    """``||P(x - g, lb, ub) - x||_inf`` per instance (LBFGSB.h:62-65)."""
    return coll.pmax_abs(force_bounds(x - g, lb, ub) - x, group,
                         "lbfgsb.projg")


def max_step_size(x: Tensor, drt: Tensor, lb: Tensor, ub: Tensor) -> Tensor:
    """The largest step keeping ``x + step * drt`` in the box, per
    instance (LBFGSB.h:68-86)."""
    per = torch.where(drt > 0.0, (ub - x) / drt,
                      torch.where(drt < 0.0, (lb - x) / drt, float("inf")))
    return per.amin(dim=1)


def _norm(a: Tensor) -> Tensor:
    return torch.linalg.vector_norm(a, dim=-1)


class LBFGSBState(NamedTuple):
    """Full solver state; every field has the batch axis first."""

    k: Tensor           # [B] int32
    x: Tensor           # [B, n]
    fx: Tensor          # [B]
    grad: Tensor        # [B, n]
    projgnorm: Tensor   # [B]
    drt: Tensor         # [B, n]
    xcp: Tensor         # [B, n]
    hist: bmat.BHistory
    fx_ring: Tensor     # [B, max(past, 1)]
    done: Tensor        # [B] bool
    status: Tensor      # [B] int32
    nfev: Tensor        # [B] int32


def _resolve_gcp(gcp: str, group=None) -> str:
    """The GCP a solve runs (lbfgspp_tpu/lbfgsb.py:90-111).  On one
    device ``"auto"`` is the reference-order ``"scan"`` (the batched
    entry point routes by n itself).  Under a group the sorted forms
    would each compute a GCP of the rank's block alone, so ``"auto"``
    takes ``"walk_auto"`` and any other single-device name ``"walk"``."""
    if gcp != "auto" and gcp not in cauchy.GCP_IMPLS:
        raise ValueError(f"gcp must be one of {sorted(cauchy.GCP_IMPLS)} "
                         f"or 'auto', got {gcp!r}")
    if group is not None and gcp not in ("walk", "walk_chunked",
                                         "walk_auto"):
        return "walk_auto" if gcp == "auto" else "walk"
    return "scan" if gcp == "auto" else gcp


def solver(fun: Optional[Callable] = None,
           lb=None,
           ub=None,
           params: LBFGSBParams = LBFGSBParams(),
           *,
           fun_and_grad=None,
           line_search="morethuente",
           gcp: str = "scan",
           unroll_subspace: bool = False,
           middle_solve=None,
           group=None,
           device=None) -> Solver:
    """Build the batched L-BFGS-B ``init/step/run/run_fixed/finalize``
    (see :func:`.lbfgs.solver`); the bounds ``lb``/``ub`` ([n] shared or
    [B, n] per instance) are closed over.

    ``gcp``: ``"scan"`` (the reference-order walk), ``"prefix"`` (the
    prefix-sum form: the same index sets, reassociated sums),
    ``"prefix_sorted"``, or ``"auto"`` (``"scan"``).  ``unroll_subspace``
    runs the BOXCQP loop for exactly ``max_submin`` steps (the same
    values, no exit test read back).  ``middle_solve``: ``"gj"``
    (Gauss-Jordan) or ``"bkldlt"`` (the reference's Bunch-Kaufman);
    ``None`` takes :data:`.ops.bmat.USE_BKLDLT`.  A zero pivot latches the
    history's ``info``.

    ``group``: ``x`` and the bounds are split over a ``torch.distributed``
    process group on their feature axis (:mod:`.parallel.sharded`); the
    oracle sees this rank's block, every reduction is an all-reduce over
    the group, and the GCP is a sortless walk (:func:`_resolve_gcp`).

    ``device`` defaults to the CUDA card; pass ``device="cpu"`` to run on
    the CPU."""
    return _build_solver(make_fun_and_grad(fun, fun_and_grad), lb, ub,
                         params, line_search=line_search, gcp=gcp,
                         unroll_subspace=unroll_subspace,
                         middle_solve=middle_solve, group=group,
                         device=device)


def _build_solver(fg, lb, ub, params: LBFGSBParams, *,
                  line_search="morethuente", gcp: str = "scan",
                  unroll_subspace: bool = False, middle_solve=None,
                  group=None, device=None) -> Solver:
    """:func:`solver` on a ready batched oracle ``fg(x [B, n]) -> (fx [B],
    grad [B, n])``."""
    gcp_fn = cauchy.GCP_IMPLS[_resolve_gcp(gcp, group)]
    bmat.resolve_middle_solve(middle_solve)
    device = resolve_device(device)
    search = get_line_search(line_search)
    if group is not None:
        gcp_fn = functools.partial(gcp_fn, group=group)
        search = functools.partial(search, group=group)
    fpast = params.past

    def xx(x: Tensor) -> Tensor:
        """The local partial ``x.x``, ``[B, 1]``."""
        return torch.linalg.vecdot(x, x)[:, None]

    on_device = {}

    def bounds(x: Tensor):
        """The bounds as [B, n] views on the device, copied there once per
        dtype."""
        if x.dtype not in on_device:
            on_device[x.dtype] = tuple(
                torch.as_tensor(v, dtype=x.dtype, device=device)
                for v in (lb, ub))
        return tuple(v.expand_as(x) for v in on_device[x.dtype])

    def fresh(x: Tensor) -> bmat.BHistory:
        batch, n = x.shape
        return bmat.init_b_history(batch, n, params.m, x.dtype,
                                   device=device)

    def init(x0) -> LBFGSBState:
        x0 = as_batch(x0, device)
        lbb, ubb = bounds(x0)
        batch = x0.shape[0]
        # Project the start into the box (LBFGSB.h:128).
        x0 = force_bounds(x0, lbb, ubb)
        if group is None:
            fx0, grad0 = fg(x0)
            xnorm0 = _norm(x0)
        else:
            fx0, grad0, sq = coll.evaluate(fg, x0, lambda g: xx(x0), group,
                                           "lbfgsb.init")
            xnorm0 = torch.sqrt(sq[:, 0])
        pg0 = proj_grad_norm(x0, grad0, lbb, ubb, group)
        fx_ring = torch.zeros((batch, max(fpast, 1)), dtype=x0.dtype,
                              device=device)
        if fpast > 0:
            fx_ring[:, 0] = fx0
        # Early exit if x0 is already a minimizer (LBFGSB.h:146-149).
        early = (pg0 <= params.epsilon) | \
            (pg0 <= params.epsilon_rel * xnorm0)
        hist0 = fresh(x0)
        cp0 = gcp_fn(hist0, x0, grad0, lbb, ubb)
        d0 = cp0.xcp - x0
        d0_norm = _norm(d0) if group is None else \
            coll.pnorm(d0, group, "lbfgsb.d0_norm")
        pos = d0_norm > 0.0
        drt0 = torch.where(pos[:, None],
                           d0 / torch.where(pos, d0_norm, 1.0)[:, None], d0)
        return LBFGSBState(
            k=i32_like(1, fx0), x=x0, fx=fx0, grad=grad0, projgnorm=pg0,
            drt=drt0, xcp=cp0.xcp, hist=hist0, fx_ring=fx_ring, done=early,
            status=torch.where(early, i32_like(Status.CONVERGED_GRAD, fx0),
                               i32_like(Status.RUNNING, fx0)),
            nfev=i32_like(1, fx0))

    def body(c: LBFGSBState) -> LBFGSBState:
        """One outer iteration (LBFGSB.h:171-258)."""
        lbb, ubb = bounds(c.x)
        xp, gradp = c.x, c.grad
        if group is None:
            dg = torch.linalg.vecdot(c.grad, c.drt)
            step_max = max_step_size(c.x, c.drt, lbb, ubb)
        else:
            # Both candidate directions' g.d and step caps up front: one
            # sum and one min all-reduce, the rescue's included.
            rescue = c.xcp - c.x
            dg, dg_rescue = coll.pdot2(c.grad, c.drt, c.grad, rescue, group,
                                       "lbfgsb.dg")
            caps = coll.pmin(torch.stack(
                [max_step_size(c.x, c.drt, lbb, ubb),
                 max_step_size(c.x, rescue, lbb, ubb)], dim=1), group,
                "lbfgsb.step_max")
            step_max = caps[:, 0]

        # The pathological-direction rescue resets the direction and the
        # whole matrix (LBFGSB.h:181-197).
        patho = (dg >= 0.0) | (step_max <= params.min_step)
        drt = torch.where(patho[:, None], c.xcp - c.x, c.drt)
        hist = tree_select(patho, fresh(c.x), c.hist)
        if group is None:
            dg = torch.where(patho, torch.linalg.vecdot(c.grad, drt), dg)
            step_max = torch.where(patho, max_step_size(c.x, drt, lbb, ubb),
                                   step_max)
        else:
            dg = torch.where(patho, dg_rescue, dg)
            step_max = torch.where(patho, caps[:, 1], step_max)

        # The search, capped at step_max (LBFGSB.h:200-203).
        step_max = torch.clamp(step_max, max=params.max_step)
        step0 = torch.clamp(step_max, max=1.0)
        ls = search(fg, params, xp, drt, step_max, step0, c.fx, c.grad, dg,
                    active=~c.done)
        nfev = c.nfev + ls.nfev
        projgnorm = proj_grad_norm(ls.x, ls.grad, lbb, ubb, group)
        ls_fail = ls.status != Status.RUNNING
        # Under a group ||x|| rides the history products' all-reduce.
        s_vec, y_vec = ls.x - xp, ls.grad - gradp
        products = None
        if group is None:
            xnorm = _norm(ls.x)
        else:
            *products, sq = bmat.correction_products(
                hist.base, s_vec, y_vec, group, xx(ls.x))
            xnorm = torch.sqrt(sq[:, 0])

        # Convergence tests (LBFGSB.h:212-230).
        conv_grad = (projgnorm <= params.epsilon) | \
            (projgnorm <= params.epsilon_rel * xnorm)
        if fpast > 0:
            slot = (c.k % fpast).long()[:, None]
            fxd = c.fx_ring.gather(1, slot)[:, 0]
            conv_past = (c.k >= fpast) & \
                ((fxd - ls.fx).abs() <= params.delta * torch.clamp(
                    torch.maximum(ls.fx.abs(), fxd.abs()), min=1.0))
            fx_ring = c.fx_ring.scatter(1, slot, ls.fx[:, None])
        else:
            conv_past = torch.zeros_like(conv_grad)
            fx_ring = c.fx_ring
        max_iter = (c.k >= params.max_iterations) if \
            params.max_iterations != 0 else torch.zeros_like(conv_grad)
        done = ls_fail | conv_grad | conv_past | max_iter
        status = torch.where(
            ls_fail, ls.status,
            torch.where(conv_grad, i32_like(Status.CONVERGED_GRAD, ls.fx),
                        torch.where(conv_past,
                                    i32_like(Status.CONVERGED_DELTA, ls.fx),
                                    torch.where(
                                        max_iter,
                                        i32_like(Status.MAX_ITERATIONS, ls.fx),
                                        i32_like(Status.RUNNING, ls.fx)))))

        # The history update under the curvature gate (LBFGSB.h:232-238).
        hist, _ = bmat.update_history_b(hist, s_vec, y_vec, ~done,
                                        middle_solve, products=products)

        # Projection, GCP and subspace step (LBFGSB.h:240-250); on the
        # terminating iteration the reference returns the search's x
        # before the projection.
        x_next = force_bounds(ls.x, lbb, ubb)
        cp = gcp_fn(hist, x_next, ls.grad, lbb, ubb)
        drt_next, sub_info = subspace.subspace_minimize(
            hist, x_next, cp.xcp, ls.grad, lbb, ubb, cp.vecc,
            cp.newact_mask, cp.free_mask, params.max_submin,
            unroll=unroll_subspace, middle_solve=middle_solve, group=group)
        hist = hist._replace(info=torch.maximum(hist.info, sub_info))
        return LBFGSBState(
            k=torch.where(done, c.k, c.k + 1),
            x=torch.where(done[:, None], ls.x, x_next),
            fx=ls.fx, grad=ls.grad, projgnorm=projgnorm, drt=drt_next,
            xcp=cp.xcp, hist=hist, fx_ring=fx_ring, done=done,
            status=status, nfev=nfev)

    def step(c: LBFGSBState) -> LBFGSBState:
        return freeze_when(c.done, c, body)

    def run(c: LBFGSBState) -> LBFGSBState:
        while not bool(c.done.all()):
            c = step(c)
        return c

    def run_fixed(c: LBFGSBState, iters: int) -> LBFGSBState:
        for _ in range(iters):
            c = step(c)
        return c

    def finalize(c: LBFGSBState) -> SolveResult:
        return SolveResult(x=c.x, fx=c.fx, grad=c.grad, gnorm=c.projgnorm,
                           niter=c.k, nfev=c.nfev, status=c.status,
                           history=c.hist)

    return Solver(init=init, step=step, finalize=finalize, run=run,
                  run_fixed=run_fixed)


def minimize(fun: Optional[Callable] = None,
             x0=None,
             lb=None,
             ub=None,
             params: LBFGSBParams = LBFGSBParams(),
             *,
             fun_and_grad=None,
             line_search="morethuente",
             gcp: str = "scan",
             unroll_subspace: bool = False,
             middle_solve=None,
             device=None) -> SolveResult:
    """Minimize ``fun`` over the box ``[lb, ub]`` from ``x0`` with L-BFGS-B
    (LBFGSBSolver::minimize, LBFGSB.h:117-262).

    ``x0`` is ``[n]`` (one solve; the result has no batch axis) or
    ``[B, n]``.  More-Thuente is the default search, as in the reference:
    it is the one that honours ``step_max``.  See :func:`solver` for the
    options."""
    if x0 is None:
        raise ValueError("x0 is required")
    s = solver(fun, lb, ub, params, fun_and_grad=fun_and_grad,
               line_search=line_search, gcp=gcp,
               unroll_subspace=unroll_subspace, middle_solve=middle_solve,
               device=device)
    single = torch.as_tensor(x0).dim() == 1
    res = s.finalize(s.run(s.init(x0)))
    return unbatch(res) if single else res
