"""Batched multistart solves and the df64 refinement phases.

The port's counterpart of ``lbfgspp_tpu.batch``: ``minimize_batched``
(batch.py:552-742) with its main phase, straggler compaction
(``_compact_refine``), the warm or cold df64 pair-space polish
(:func:`polish_solve`) and the straggler-targeted deep stage
(:func:`deep_polish`).  The JAX package maps one instance's polish over
the batch with ``vmap``; here every phase runs the batch at once, so a
polish is one batched solve in pair space ``[B, 2n]``.  The multi-device
``mesh`` option is a later slice of the port and raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from . import lbfgs
from .ops import history as hist_ops
from .params import LBFGSParams
from .types import (SolveResult, Status, resolve_device, tree_map,
                    tree_select)
from .utils import doublefloat as dfl

Tensor = torch.Tensor


def _compact_refine(s2: lbfgs.Solver, x0s: Tensor, k_refine: int,
                    k_stage1: int) -> lbfgs.LBFGSState:
    """Two-stage batched solve with straggler compaction
    (lbfgspp_tpu/batch.py:29-75).

    Stage 1 steps the whole batch while an instance is unfinished and has
    ``k <= k_stage1`` (a pause at an iteration boundary, so the carry stays
    whole).  The states are then sorted unconverged first (stable), the
    leading ``k_refine`` run on alone to the solver's cap, and scattered
    back.  Unconverged instances beyond ``k_refine`` keep their stage-1
    iterate and report ``MAX_ITERATIONS``."""
    c = s2.init(x0s)

    def pausing(c):
        return (~c.done) & (c.k <= k_stage1)

    live = pausing(c)
    while bool(live.any()):
        c = tree_select(live, s2.step(c), c)
        live = pausing(c)
    order = torch.argsort(c.done.to(torch.int32), stable=True)
    cs = tree_map(lambda a: a[order], c)
    head = s2.run(tree_map(lambda a: a[:k_refine], cs))
    tail = tree_map(lambda a: a[k_refine:], cs)
    # A paused carry holds k = iterations performed + 1 (a capped one
    # holds the count itself): align the reported count.
    tail = tail._replace(
        k=torch.where(tail.done, tail.k, tail.k - 1),
        done=torch.ones_like(tail.done),
        status=torch.where(tail.done, tail.status,
                           torch.full_like(tail.status,
                                           int(Status.MAX_ITERATIONS))))
    merged = tree_map(lambda h, t: torch.cat([h, t], dim=0), head, tail)
    inv = torch.argsort(order)
    return tree_map(lambda a: a[inv], merged)


def _lift_history_pairs(hist: hist_ops.LBFGSHistory,
                        direction: str) -> hist_ops.LBFGSHistory:
    """An [B, m, n] history as a pair-space [B, m, 2n] one (lo halves 0).

    The main phase's pairs are exact pair-space pairs with zero lo words,
    and every cached product (ys, theta, the Grams) is unchanged by the
    padding (lbfgspp_tpu/batch.py:78-98).  The ``rinv`` factor is kept,
    or rebuilt from the Grams when the direction needs one the history
    does not carry."""
    z = torch.zeros_like(hist.s)
    rinv = hist.rinv
    if direction == "rinv" and rinv is None:
        rinv = hist_ops.rinv_from_grams(hist)
    elif direction != "rinv":
        rinv = None
    return hist._replace(s=torch.cat([hist.s, z], dim=2),
                         y=torch.cat([hist.y, z], dim=2), rinv=rinv)


def polish_solve(fun: Optional[Callable], x0, params: LBFGSParams,
                 iters: int, *,
                 fun_and_grad=None,
                 line_search: str = "morethuente",
                 drive: str = "while",
                 direction: str = "sweeps",
                 warm_history: Optional[hist_ops.LBFGSHistory] = None,
                 shift: bool = False,
                 on_ls_fail: str = "stop",
                 restarts: int = 1,
                 device=None) -> SolveResult:
    """Refine f32 solutions ``x0 [B, n]`` (or one ``[n]``) with up to
    ``iters`` L-BFGS iterations in double-float pair space
    (lbfgspp_tpu/batch.py:101-237).

    The solver sees ``[hi; lo]``, 2n ordinary coordinates per instance,
    while the objective and gradient are evaluated at the exact sum in
    pair arithmetic (:func:`.utils.doublefloat.df64_pair_fun_and_grad`):
    big moves land in ``hi``, sub-ulp moves accumulate in ``lo``.

    ``warm_history``: the main phase's final history; its pairs lift
    exactly into pair space, so the first direction is ``-H g`` (one
    two-loop call) with a unit step instead of steepest descent.
    ``shift=True`` subtracts the pair value at ``x0`` inside the pair
    objective, for objectives whose optimum value is far from 0 (its
    evaluation counts one ``nfev``).  ``restarts > 1`` runs that many cold
    chunks of ``iters`` in turn (``warm_history`` serves the first only),
    counters summed.  ``drive`` and ``on_ls_fail`` as in
    :func:`minimize_batched`.

    The result's ``history`` is an empty [B, m, n] history: the polish's
    curvature lives in pair space.
    """
    device = resolve_device(device)
    single = torch.as_tensor(x0).dim() == 1
    x0 = lbfgs.as_batch(x0, device)
    options = dict(fun_and_grad=fun_and_grad, line_search=line_search,
                   drive=drive, direction=direction, shift=shift,
                   on_ls_fail=on_ls_fail, device=device)
    if restarts > 1:
        res = polish_solve(fun, x0, params, iters,
                           warm_history=warm_history, **options)
        niter, nfev = res.niter, res.nfev
        for _ in range(restarts - 1):
            res = polish_solve(fun, res.x, params, iters, **options)
            niter, nfev = niter + res.niter, nfev + res.nfev
        res = res._replace(niter=niter, nfev=nfev)
        return lbfgs.unbatch(res) if single else res

    ref = None
    if shift:
        ref = dfl.df64_value(fun, fun_and_grad)(x0)
    fg2 = dfl.df64_pair_fun_and_grad(
        fun, fun_and_grad, shift=None if ref is None else tuple(ref))
    s = lbfgs._build_solver(
        fg2, dataclasses.replace(params, max_iterations=iters),
        line_search=line_search, direction=direction,
        on_ls_fail=on_ls_fail, device=device)
    batch, n = x0.shape
    st = s.init(torch.cat([x0, torch.zeros_like(x0)], dim=1))
    if warm_history is not None:
        h2 = _lift_history_pairs(warm_history, direction)
        drt = hist_ops.apply_hv(h2, st.grad, -1.0, tri=direction)
        st = st._replace(hist=h2, drt=drt, step=torch.ones_like(st.step))
    st = s.run_fixed(st, iters) if drive == "fixed" else s.run(st)
    res2 = s.finalize(st)
    grad = res2.grad[:, :n].contiguous()
    fx, nfev = res2.fx, res2.nfev
    if ref is not None:
        fx = (fx + ref.lo) + ref.hi
        nfev = nfev + 1
    res = SolveResult(
        x=dfl.pair_to_float(res2.x), fx=fx, grad=grad,
        gnorm=torch.linalg.vector_norm(grad, dim=-1), niter=res2.niter,
        nfev=nfev, status=res2.status,
        history=hist_ops.init_history(batch, n, params.m, x0.dtype,
                                      device=device))
    return lbfgs.unbatch(res) if single else res


def _select_stragglers(res: SolveResult, k_deep: int, direction: str,
                       selection: str) -> Tensor:
    """The indices of the ``k_deep`` instances the deep stage refines
    (stable sorts, so ties select as the JAX package's do)."""
    batch = res.gnorm.shape[0]
    if selection == "hstep":
        tri = direction if direction == "rinv" else "sweeps"
        est = torch.linalg.vector_norm(hist_ops.apply_hv(
            res.history, res.grad.contiguous(), -1.0, tri=tri), dim=-1)
        est = est.to(torch.float32)
        est = torch.where(torch.isnan(est), math.inf, est)
        order = torch.argsort(-est, stable=True)   # largest ||H g|| first
    else:
        gn = res.gnorm.to(torch.float32)
        gn = torch.where(torch.isnan(gn), math.inf, gn)
        unconv = (res.status == int(Status.MAX_ITERATIONS)) | \
            (res.status >= 10)
        # Integer composite rank: unconverged first, then by gradient
        # norm descending.
        rank = torch.argsort(torch.argsort(-gn, stable=True), stable=True)
        order = torch.argsort(torch.where(unconv, rank, rank + batch),
                              stable=True)
    return order[:k_deep]


def deep_polish(fun: Optional[Callable], res: SolveResult,
                params: LBFGSParams, k_deep: int, deep_iters: int, *,
                fun_and_grad=None,
                line_search: str = "morethuente",
                direction: str = "sweeps",
                selection: str = "gnorm",
                shift: bool = False,
                on_ls_fail: str = "stop",
                restarts: int = 1) -> SolveResult:
    """Straggler-targeted deep df64 refinement of a batched result
    (lbfgspp_tpu/batch.py:442-540).

    Selects ``k_deep`` instances in-band: ``selection="gnorm"`` ranks the
    unconverged (iteration cap or search failure) first, then by gradient
    norm descending, a NaN norm worst; ``"hstep"`` ranks by the
    quasi-Newton step length ``||H g||`` of each instance's carried
    history (one two-loop call).  The selected instances get a cold
    :func:`polish_solve` of up to ``deep_iters`` iterations from their
    current iterate, and the refined fields are scattered back, counters
    added.  The returned history is the input's with the refined rows
    soft-reset (``ncorr = 0``, ``theta = 1``), since their model no longer
    matches the refined iterate.
    """
    if selection not in ("gnorm", "hstep"):
        raise ValueError(f"selection must be 'gnorm' or 'hstep', "
                         f"got {selection!r}")
    idx = _select_stragglers(res, k_deep, direction, selection)
    pol = polish_solve(fun, res.x[idx], params, deep_iters,
                       fun_and_grad=fun_and_grad, line_search=line_search,
                       direction=direction, shift=shift,
                       on_ls_fail=on_ls_fail, restarts=restarts,
                       device=res.x.device)

    def scat(a, b):
        return a.index_copy(0, idx, b)

    hist = res.history._replace(
        ncorr=res.history.ncorr.index_fill(0, idx, 0),
        theta=res.history.theta.index_fill(0, idx, 1.0))
    return SolveResult(
        x=scat(res.x, pol.x), fx=scat(res.fx, pol.fx),
        grad=scat(res.grad, pol.grad), gnorm=scat(res.gnorm, pol.gnorm),
        niter=scat(res.niter, res.niter[idx] + pol.niter),
        nfev=scat(res.nfev, res.nfev[idx] + pol.nfev),
        status=scat(res.status, pol.status), history=hist)


def _merge_polished(res: SolveResult, pol: SolveResult) -> SolveResult:
    """Main + polish phases: iterates from the polish, counters summed,
    the history (in the original space) from the main phase."""
    return SolveResult(x=pol.x, fx=pol.fx, grad=pol.grad, gnorm=pol.gnorm,
                       niter=res.niter + pol.niter, nfev=res.nfev + pol.nfev,
                       status=pol.status, history=res.history)


def minimize_batched(fun: Optional[Callable] = None,
                     x0s=None,
                     params: LBFGSParams = LBFGSParams(),
                     *,
                     fun_and_grad=None,
                     line_search: str = "nocedalwright",
                     mesh=None,
                     polish_iters: int = 0,
                     polish_params: Optional[LBFGSParams] = None,
                     polish_line_search: Optional[str] = None,
                     refine_frac: float = 0.0,
                     refine_iters: int = 0,
                     drive: str = "while",
                     direction: str = "sweeps",
                     polish_warm: bool = False,
                     polish_shift: bool = False,
                     polish_on_ls_fail: str = "stop",
                     polish_restarts: int = 1,
                     deep_frac: float = 0.0,
                     deep_iters: int = 0,
                     deep_selection: str = "gnorm",
                     on_ls_fail: str = "stop",
                     device=None) -> SolveResult:
    """Solve one objective from a batch of starts ``x0s [B, n]``; every
    result field has the batch axis (lbfgspp_tpu/batch.py:552-742).

    Set ``params.max_iterations``: the batch runs until its slowest
    instance stops.  ``drive="fixed"`` runs exactly that many steps (the
    same result, finished instances keep their state) with no all-done
    test between steps.

    Phases after the main solve, each off by default:

    * ``polish_iters > 0``: a df64 pair-space polish of every instance
      (:func:`polish_solve`), warm-started from the main phase's history
      with ``polish_warm``, shifted with ``polish_shift``, in
      ``polish_restarts`` chunks, failing searches handled by
      ``polish_on_ls_fail``;
    * ``deep_frac``/``deep_iters``: the hardest ``round(deep_frac * B)``
      instances (``deep_selection``) get up to ``deep_iters`` cold df64
      iterations (:func:`deep_polish`);
    * ``refine_frac``/``refine_iters``: straggler compaction
      (:func:`_compact_refine`): the batch runs in lockstep only to
      ``params.max_iterations``, then the hardest ``refine_frac`` of it
      continues alone for up to ``refine_iters`` more.

    ``polish_params`` is the polish and deep phases' parameter set
    (default ``params``): the bench recipe caps the main phase's search
    at 2 trials and keeps the full budget there.  ``polish_line_search``
    is their line search (default ``line_search``, as in the JAX
    package); the bench recipe runs Nocedal-Wright in the main phase and
    More-Thuente in the df64 phases.
    """
    if mesh is not None:
        raise NotImplementedError("minimize_batched(mesh=...) lands in a "
                                  "later slice of the port")
    if drive not in ("while", "fixed"):
        raise ValueError(f"drive must be 'while' or 'fixed', got {drive!r}")
    use_refine = refine_frac > 0.0 and refine_iters > 0
    if drive == "fixed":
        if params.max_iterations == 0:
            raise ValueError("drive='fixed' requires a finite "
                             "params.max_iterations (the trip count)")
        if use_refine:
            raise ValueError("drive='fixed' does not compose with straggler "
                             "compaction (whose stages are while-driven)")
    if use_refine and params.max_iterations == 0:
        raise ValueError("refine_iters requires a finite "
                         "params.max_iterations (the stage-1 lockstep cap)")
    device = resolve_device(device)
    x0s = lbfgs.as_batch(x0s, device)
    batch = x0s.shape[0]
    pparams = params if polish_params is None else polish_params
    pline = line_search if polish_line_search is None else polish_line_search

    if use_refine:
        k_refine = max(1, min(batch, int(round(refine_frac * batch))))
        p2 = dataclasses.replace(
            params, max_iterations=params.max_iterations + refine_iters)
        s2 = lbfgs.solver(fun, p2, fun_and_grad=fun_and_grad,
                          line_search=line_search, direction=direction,
                          on_ls_fail=on_ls_fail, device=device)
        res = s2.finalize(_compact_refine(s2, x0s, k_refine,
                                          params.max_iterations))
    else:
        s1 = lbfgs.solver(fun, params, fun_and_grad=fun_and_grad,
                          line_search=line_search, direction=direction,
                          on_ls_fail=on_ls_fail, device=device)
        state = s1.init(x0s)
        state = (s1.run_fixed(state, params.max_iterations)
                 if drive == "fixed" else s1.run(state))
        res = s1.finalize(state)

    if polish_iters:
        pol = polish_solve(
            fun, res.x, pparams, polish_iters, fun_and_grad=fun_and_grad,
            line_search=pline, drive=drive, direction=direction,
            warm_history=res.history if polish_warm else None,
            shift=polish_shift, on_ls_fail=polish_on_ls_fail,
            restarts=polish_restarts, device=device)
        res = _merge_polished(res, pol)
    if deep_frac > 0.0 and deep_iters > 0:
        k_deep = max(1, min(batch, int(round(deep_frac * batch))))
        res = deep_polish(fun, res, pparams, k_deep, deep_iters,
                          fun_and_grad=fun_and_grad, line_search=pline,
                          direction=direction, selection=deep_selection,
                          shift=polish_shift, on_ls_fail=polish_on_ls_fail,
                          restarts=polish_restarts)
    return res
