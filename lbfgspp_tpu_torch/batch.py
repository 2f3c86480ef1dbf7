"""Batched multistart solves and the df64 refinement phases.

The port's counterpart of ``lbfgspp_tpu.batch``: ``minimize_batched``
(batch.py:552-742) with its main phase, straggler compaction
(``_compact_refine``), the warm or cold df64 pair-space polish
(:func:`polish_solve`) and the straggler-targeted deep stage
(:func:`deep_polish`); the box-constrained ``minimize_b_batched``
(batch.py:772-877) with its active-set df64 polish
(:func:`polish_solve_b`); the active-orthant df64 polish of OWL-QN
solutions (:func:`polish_solve_owlqn`); and :func:`best_result`.  The
JAX package maps one instance's polish over the batch with ``vmap``;
here every phase runs the batch at once, so a polish is one batched
solve in pair space ``[B, 2n]``.

``mesh=`` (a 1-D ``torch.distributed.DeviceMesh`` or ``ProcessGroup``)
splits the batch over the ranks data-parallel, as the JAX package's
batch-sharded ``jit`` does (batch.py:582-586, :867-876): each rank solves
its contiguous block of instances with no collective inside the solve.
The selections the JAX package makes over the whole batch stay global:
the straggler compaction's and the deep stage's scores are gathered
(one all-reduce each) and every rank refines the selected instances it
holds.  The result is gathered, so every rank returns the whole batch in
instance order.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import torch

from . import lbfgs, lbfgsb
from .ops import history as hist_ops
from .owlqn import pseudo_gradient
from .parallel import collectives as coll
from .params import LBFGSBParams, LBFGSParams
from .types import (SUCCESS_STATUSES, SolveResult, Status,
                    data_fun_and_grad, make_fun_and_grad, resolve_device,
                    tree_map, tree_select)
from .utils import doublefloat as dfl

Tensor = torch.Tensor


def _compact_refine(s2: lbfgs.Solver, x0s: Tensor, k_refine: int,
                    k_stage1: int, group=None,
                    total: Optional[int] = None) -> lbfgs.LBFGSState:
    """Two-stage batched solve with straggler compaction
    (lbfgspp_tpu/batch.py:29-75).

    Stage 1 steps the whole batch while an instance is unfinished and has
    ``k <= k_stage1`` (a pause at an iteration boundary, so the carry stays
    whole).  The states are then sorted unconverged first (stable), the
    leading ``k_refine`` run on alone to the solver's cap, and scattered
    back.  Unconverged instances beyond ``k_refine`` keep their stage-1
    iterate and report ``MAX_ITERATIONS``.

    ``group``: ``x0s`` is this rank's block of a batch of ``total``; the
    sort runs over the whole batch's gathered flags, and this rank runs on
    the selected instances it holds."""
    c = s2.init(x0s)

    def pausing(c):
        return (~c.done) & (c.k <= k_stage1)

    live = pausing(c)
    while bool(live.any()):
        c = tree_select(live, s2.step(c), c)
        live = pausing(c)
    order, k_head = _local_order(
        torch.argsort(coll.gather_rows(c.done, total, group,
                                       "batch.refine_select")
                      .to(torch.int32), stable=True), k_refine, group,
        total)
    cs = tree_map(lambda a: a[order], c)
    head = s2.run(tree_map(lambda a: a[:k_head], cs))
    tail = tree_map(lambda a: a[k_head:], cs)
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
    res = _polish_pairs(fg2, x0, params, iters, line_search=line_search,
                        drive=drive, direction=direction,
                        warm_history=warm_history, on_ls_fail=on_ls_fail,
                        device=device)
    if ref is not None:
        res = res._replace(fx=(res.fx + ref.lo) + ref.hi, nfev=res.nfev + 1)
    return lbfgs.unbatch(res) if single else res


def _polish_pairs(fg2, x0: Tensor, params: LBFGSParams, iters: int, *,
                  line_search: str, drive: str, direction: str,
                  warm_history: Optional[hist_ops.LBFGSHistory],
                  on_ls_fail: str, device) -> SolveResult:
    """Up to ``iters`` L-BFGS iterations on the pair oracle ``fg2`` from
    ``[x0; 0]``, collapsed back to ``x0``'s dtype (the history is an empty
    [B, m, n] one)."""
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
    return SolveResult(
        x=dfl.pair_to_float(res2.x), fx=res2.fx, grad=grad,
        gnorm=torch.linalg.vector_norm(grad, dim=-1), niter=res2.niter,
        nfev=res2.nfev, status=res2.status,
        history=hist_ops.init_history(batch, n, params.m, x0.dtype,
                                      device=device))


def _local_order(order: Tensor, k: int, group, total: Optional[int]):
    """``(local, k_local)``: the instances of this rank's block in the
    global ``order``, as local indices, and how many of them are among
    the first ``k`` (``order`` and ``k`` themselves without a group)."""
    if group is None:
        return order, k
    lo, hi = coll.block(total, group)
    mine = (order >= lo) & (order < hi)
    return order[mine] - lo, int(mine[:k].sum())


def _select_stragglers(res: SolveResult, k_deep: int, direction: str,
                       selection: str, group=None,
                       total: Optional[int] = None) -> Tensor:
    """The indices of the ``k_deep`` instances the deep stage refines
    (stable sorts, so ties select as the JAX package's do); under a group
    ``res`` is this rank's block of ``total`` instances, the ranking runs
    over the gathered scores, and the indices are this rank's selected
    ones, local."""
    batch = res.gnorm.shape[0] if group is None else total
    if selection == "hstep":
        tri = direction if direction == "rinv" else "sweeps"
        est = torch.linalg.vector_norm(hist_ops.apply_hv(
            res.history, res.grad.contiguous(), -1.0, tri=tri), dim=-1)
        est = est.to(torch.float32)
        est = coll.gather_rows(est, total, group, "batch.deep_select")
        est = torch.where(torch.isnan(est), math.inf, est)
        order = torch.argsort(-est, stable=True)   # largest ||H g|| first
    else:
        gn, status = coll.gather_rows(
            torch.stack([res.gnorm.to(torch.float32),
                         res.status.to(torch.float32)], dim=1),
            total, group, "batch.deep_select").unbind(1)
        gn = torch.where(torch.isnan(gn), math.inf, gn)
        unconv = (status == int(Status.MAX_ITERATIONS)) | (status >= 10)
        # Integer composite rank: unconverged first, then by gradient
        # norm descending.
        rank = torch.argsort(torch.argsort(-gn, stable=True), stable=True)
        order = torch.argsort(torch.where(unconv, rank, rank + batch),
                              stable=True)
    local, k_local = _local_order(order, k_deep, group, total)
    return local[:k_local]


def deep_polish(fun: Optional[Callable], res: SolveResult,
                params: LBFGSParams, k_deep: int, deep_iters: int, *,
                fun_and_grad=None,
                line_search: str = "morethuente",
                direction: str = "sweeps",
                selection: str = "gnorm",
                shift: bool = False,
                on_ls_fail: str = "stop",
                restarts: int = 1,
                group=None,
                total: Optional[int] = None) -> SolveResult:
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

    ``group``: ``res`` is this rank's block of a batch of ``total``; the
    selection ranks the whole batch (:func:`_select_stragglers`) and this
    rank refines the selected instances it holds.
    """
    if selection not in ("gnorm", "hstep"):
        raise ValueError(f"selection must be 'gnorm' or 'hstep', "
                         f"got {selection!r}")
    idx = _select_stragglers(res, k_deep, direction, selection, group,
                             total)
    if idx.numel() == 0:
        return res
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

    ``mesh`` (a 1-D ``DeviceMesh`` or ``ProcessGroup``; every rank passes
    the same ``x0s``) splits the batch over the ranks data-parallel: each
    solves its block with no collective inside the solve, the compaction's
    and the deep stage's selections rank the whole batch, and every rank
    returns the whole batch's result (see the module docstring).
    """
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
    group, x0s = _batch_block(mesh, x0s)
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
                                          params.max_iterations, group,
                                          batch))
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
                          restarts=polish_restarts, group=group,
                          total=batch)
    return _gather_result(res, batch, group)


def _batch_block(mesh, x0s: Tensor):
    """``(group, block)``: the group of ``mesh`` (None without one) and
    this rank's contiguous block of the instances ``x0s``."""
    if mesh is None:
        return None, x0s
    group = coll.resolve_group(mesh)
    batch, world = x0s.shape[0], torch.distributed.get_world_size(group)
    if batch < world:
        raise ValueError(f"a batch of {batch} cannot split over {world} "
                         f"ranks")
    lo, hi = coll.block(batch, group)
    return group, x0s[lo:hi]


def _gather_result(res: SolveResult, total: int, group) -> SolveResult:
    """Every rank's block of the result assembled into the whole batch's,
    in instance order (one all-reduce per field)."""
    return tree_map(lambda t: coll.gather_rows(t, total, group,
                                               "batch.gather_result"), res)


def polish_solve_b(fun: Optional[Callable], x0, lb, ub,
                   params: LBFGSParams, iters: int, *,
                   fun_and_grad=None,
                   active_tol: float = 1e-3,
                   line_search: str = "morethuente",
                   direction: str = "sweeps",
                   prior: Optional[SolveResult] = None,
                   device=None) -> SolveResult:
    """The active-set df64 polish of box-constrained f32 solutions ``x0
    [B, n]`` (or one ``[n]``) (lbfgspp_tpu/batch.py:240-341).

    An f32 box solve stops at the f32 objective plateau, where the
    past/delta test fires with coordinates still ~1e-4 off their bounds.
    Per instance: coordinates within ``active_tol`` of a bound whose
    gradient pushes outward (KKT-consistent) are pinned exactly to it; the
    free ones are refined by up to ``iters`` iterations of the pair-space
    polish of the pinned objective, shifted by its df64 value at the
    pinned start (the active coordinates' pair gradient is zero, so they
    stay); the result is projected into the box and kept only where the
    shifted df64 objective did not grow, else the start is kept.

    ``prior``: the box solve whose ``x`` this polishes; then ``niter`` and
    ``nfev`` are cumulative and its ``status`` and ``history`` stay.
    ``nfev`` adds five evaluations to the polish's own: the value and
    gradient at ``x0``, the df64 value at the pinned start, the two
    shifted df64 values of the acceptance test and the value and gradient
    at the result.
    """
    device = resolve_device(device)
    single = torch.as_tensor(x0).dim() == 1
    x0 = lbfgs.as_batch(x0, device)
    lb = torch.as_tensor(lb, dtype=x0.dtype, device=device).expand_as(x0)
    ub = torch.as_tensor(ub, dtype=x0.dtype, device=device).expand_as(x0)
    fg = make_fun_and_grad(fun, fun_and_grad)
    fx0, g0 = fg(x0)
    act_lo = (x0 - lb <= active_tol) & (g0 >= 0.0)
    act_hi = (ub - x0 <= active_tol) & (g0 <= 0.0) & (~act_lo)
    active = act_lo | act_hi
    xpin = torch.where(act_lo, lb, torch.where(act_hi, ub, x0))

    # The df64 value at the pinned start, subtracted inside the pair
    # arithmetic: the refinement's decrease (~1e-5) would vanish in the f32
    # rounding of a large objective value.
    value = dfl.df64_value(fun, fun_and_grad)
    ref = value(xpin)
    chi, clo = ref.hi, ref.lo
    fg2 = dfl.df64_pair_fun_and_grad(fun, fun_and_grad, shift=(chi, clo),
                                     pin=(active, xpin))
    pol = _polish_pairs(fg2, xpin, params, iters, line_search=line_search,
                        drive="while", direction=direction,
                        warm_history=None, on_ls_fail="stop", device=device)
    xp = lbfgsb.force_bounds(pol.x, lb, ub)
    fxp, gp = fg(xp)

    def shifted(z):
        return dfl.to_float(dfl.sub(dfl.sub(value(z), dfl.lift(chi)),
                                    dfl.lift(clo)))

    # Accept at df64 resolution too: the gain is below an f32 ulp of fx.
    better = shifted(xp) <= shifted(x0)
    x = torch.where(better[:, None], xp, x0)
    fx = torch.where(better, fxp, fx0)
    grad = torch.where(better[:, None], gp, g0)
    res = SolveResult(
        x=x, fx=fx, grad=grad, gnorm=lbfgsb.proj_grad_norm(x, grad, lb, ub),
        niter=pol.niter, nfev=pol.nfev + 5, status=pol.status,
        history=pol.history)
    if prior is not None:
        if single:
            prior = tree_map(lambda t: t[None], prior)
        res = res._replace(niter=prior.niter + pol.niter,
                           nfev=prior.nfev + pol.nfev + 5,
                           status=prior.status, history=prior.history)
    return lbfgs.unbatch(res) if single else res


@functools.lru_cache(maxsize=16)
def _owlqn_objectives(fun: Optional[Callable],
                      fun_and_grad: Optional[Callable], with_data: bool):
    """The per-instance objectives of the OWL-QN polish, built once per
    loss so that the pair interpreter records each graph once: the masked
    restriction ``masked(z, (data, pinned, sgn, lam))`` and the full L1
    objective ``full(z, (data, lam))``.  Everything per instance enters as
    data, none of it as a recorded constant."""
    if fun is None:
        def fun(x, *data):
            return fun_and_grad(x, *data)[0]

    def loss(x, data):
        return fun(x, data) if with_data else fun(x)

    def masked(z, aux):
        data, pinned, sgn, lam = aux
        xz = torch.where(pinned, 0.0, z)
        return loss(xz, data) + \
            torch.sum(torch.where(pinned, 0.0, lam * sgn * z))

    def full(z, aux):
        data, lam = aux
        return loss(z, data) + torch.sum(lam * torch.abs(z))

    return masked, full


def polish_solve_owlqn(fun: Optional[Callable], x0, l1,
                       params: LBFGSParams, iters: int, *,
                       fun_and_grad=None,
                       data: Any = None,
                       line_search: str = "morethuente",
                       direction: str = "sweeps",
                       on_ls_fail: str = "stop",
                       restarts: int = 1,
                       prior: Optional[SolveResult] = None,
                       device=None) -> SolveResult:
    """The active-orthant df64 polish of L1-regularized (OWL-QN) f32
    solutions ``x0 [B, n]`` (or one ``[n]``)
    (lbfgspp_tpu/batch.py:344-439).

    On the converged support the objective is smooth, so per instance:
    coordinates at exact zero with ``|g_i| <= l1_i`` (KKT-consistent) are
    pinned; every other coordinate keeps its orthant, ``sign(x_i)``, or
    for a zero that is not KKT-consistent the pseudo-gradient's descent
    orthant; the free ones are refined by up to ``iters`` iterations (in
    ``restarts`` cold chunks) of the pair-space polish of ``loss(where(
    pinned, 0, z)) + sum_free l1_i s_i z_i``, shifted by its df64 value at
    ``x0``; the result is projected back onto the orthant (coordinates that
    crossed zero become exact zeros) and kept only where the df64 full L1
    objective did not grow, else ``x0`` stays.

    ``fun(x[n])`` (or ``fun_and_grad``) is the loss; with ``data``,
    ``fun(x[n], data_i)`` as in :func:`.owlqn.minimize_owlqn`.  ``l1`` is
    a scalar, ``[n]`` or ``[B, n]``.  ``gnorm`` is the pseudo-gradient's
    infinity norm (the KKT residual).  ``prior``: the OWL-QN solve whose
    ``x`` this polishes; then ``niter``/``nfev`` are cumulative and its
    ``status`` and ``history`` stay.  ``nfev`` adds five evaluations to the
    polish's own, as in :func:`polish_solve_b`.
    """
    device = resolve_device(device)
    single = torch.as_tensor(x0).dim() == 1
    x0 = lbfgs.as_batch(x0, device)
    lam = torch.as_tensor(l1, dtype=x0.dtype, device=device).expand(x0.shape)
    fg = data_fun_and_grad(fun, fun_and_grad, data)
    masked, full = _owlqn_objectives(fun, fun_and_grad, data is not None)
    loss0, g0 = fg(x0)
    fx0 = loss0 + (lam * x0.abs()).sum(-1)
    zero = x0 == 0.0
    pinned = zero & (g0.abs() <= lam)      # KKT-consistent exact zeros
    # A zero that is not KKT-consistent takes the pseudo-gradient's
    # descent orthant (pg > 0: f decreases into x < 0).
    pg0 = pseudo_gradient(x0, g0, lam)
    sgn = torch.where(zero, -torch.sign(pg0), torch.sign(x0))

    # Without data, its slot is an empty tuple: a tree with no leaves.
    lam, slot = lam.contiguous(), () if data is None else data
    aux = (slot, pinned, sgn, lam)
    ref = dfl.df64_value(masked, data=aux)(x0)
    chi, clo = ref.hi, ref.lo
    fg2 = dfl.df64_pair_fun_and_grad(masked, shift=(chi, clo), data=aux)
    xs, niter, nfev = x0, 0, 0
    for _ in range(restarts):
        pol = _polish_pairs(fg2, xs, params, iters, line_search=line_search,
                            drive="while", direction=direction,
                            warm_history=None, on_ls_fail=on_ls_fail,
                            device=device)
        xs, niter, nfev = pol.x, niter + pol.niter, nfev + pol.nfev
    # Orthant projection: coordinates that crossed zero become exact 0.
    xp = torch.where(pinned | (sgn * xs < 0.0), 0.0, xs)

    value = dfl.df64_value(full, data=(slot, lam))

    def shifted(z):
        return dfl.to_float(dfl.sub(dfl.sub(value(z), dfl.lift(chi)),
                                    dfl.lift(clo)))

    better = shifted(xp) <= shifted(x0)
    x = torch.where(better[:, None], xp, x0)
    loss_x, gx = fg(x)
    fx = torch.where(better, loss_x + (lam * x.abs()).sum(-1), fx0)
    grad = torch.where(better[:, None], gx, g0)
    pgnorm = pseudo_gradient(x, grad, lam).abs().amax(dim=-1)
    res = SolveResult(x=x, fx=fx, grad=grad, gnorm=pgnorm, niter=niter,
                      nfev=nfev + 5, status=pol.status, history=pol.history)
    if prior is not None:
        if single:
            prior = tree_map(lambda t: t[None], prior)
        res = res._replace(niter=prior.niter + niter,
                           nfev=prior.nfev + nfev + 5,
                           status=prior.status, history=prior.history)
    return lbfgs.unbatch(res) if single else res


def best_result(results: SolveResult,
                prefer_success: bool = True) -> SolveResult:
    """The best instance of a batched result, without the batch axis
    (lbfgspp_tpu/batch.py:745-769): the lowest ``fx``; with
    ``prefer_success`` an instance whose status is a success outranks
    every failed one.  A NaN ``fx`` always loses; in a batch of failures
    only, the lowest ``fx`` wins."""
    fx = results.fx
    bad = torch.isnan(fx)
    if prefer_success:
        ok = torch.isin(results.status,
                        torch.tensor([int(s) for s in SUCCESS_STATUSES],
                                     dtype=results.status.dtype,
                                     device=fx.device))
        bad = bad | ~ok
    keyed = torch.where(bad, float("inf"), fx)
    keyed = torch.where(bad.all(),
                        torch.where(torch.isnan(fx), float("inf"), fx),
                        keyed)
    i = torch.argmin(keyed)
    return tree_map(lambda a: a[i], results)


def minimize_b_batched(fun: Optional[Callable] = None,
                       x0s=None,
                       lb=None,
                       ub=None,
                       params: LBFGSBParams = LBFGSBParams(),
                       *,
                       fun_and_grad=None,
                       line_search: str = "morethuente",
                       mesh=None,
                       gcp: str = "auto",
                       unroll_subspace: bool = False,
                       drive: str = "while",
                       middle_solve=None,
                       polish_iters: int = 0,
                       polish_active_tol: float = 1e-3,
                       device=None) -> SolveResult:
    """Box-constrained solves from a batch of starts ``x0s [B, n]``; ``lb``
    and ``ub`` are shared ``[n]`` or per-instance ``[B, n]``
    (lbfgspp_tpu/batch.py:772-877).

    ``gcp="auto"`` takes the prefix-sum Cauchy point for n <= 2048 and the
    reference-order walk above; ``"scan"``, ``"prefix"`` or
    ``"prefix_sorted"`` force one.  ``unroll_subspace`` and
    ``middle_solve`` as in :func:`.lbfgsb.solver`; ``drive="fixed"`` runs
    exactly ``params.max_iterations`` steps.

    ``polish_iters > 0`` appends the active-set df64 polish
    (:func:`polish_solve_b`, ``polish_active_tol`` its activity
    tolerance) with ``LBFGSParams(epsilon=min(params.epsilon, 1e-7),
    max_iterations=max(params.max_iterations, 60), m=params.m)``; the
    result's counters are then cumulative and the box solve's status and
    history stay.

    ``mesh`` splits the batch over the ranks as in
    :func:`minimize_batched`: per-instance ``[B, n]`` bounds split with
    it, shared ``[n]`` bounds are every rank's."""
    if drive not in ("while", "fixed"):
        raise ValueError(f"drive must be 'while' or 'fixed', got {drive!r}")
    if drive == "fixed" and params.max_iterations == 0:
        raise ValueError("drive='fixed' requires a finite "
                         "params.max_iterations (the trip count)")
    device = resolve_device(device)
    x0s = lbfgs.as_batch(x0s, device)
    batch = x0s.shape[0]
    group, x0s = _batch_block(mesh, x0s)
    if group is not None:
        lo, hi = coll.block(batch, group)
        lb, ub = (v[lo:hi] if torch.as_tensor(v).dim() == 2 else v
                  for v in (lb, ub))
    if gcp == "auto":
        gcp = "prefix" if x0s.shape[-1] <= 2048 else "scan"
    s = lbfgsb.solver(fun, lb, ub, params, fun_and_grad=fun_and_grad,
                      line_search=line_search, gcp=gcp,
                      unroll_subspace=unroll_subspace,
                      middle_solve=middle_solve, device=device)
    state = s.init(x0s)
    state = (s.run_fixed(state, params.max_iterations)
             if drive == "fixed" else s.run(state))
    res = s.finalize(state)
    if polish_iters:
        pparams = LBFGSParams(epsilon=min(params.epsilon, 1e-7),
                              max_iterations=max(params.max_iterations, 60),
                              m=params.m)
        res = polish_solve_b(fun, res.x, lb, ub, pparams, polish_iters,
                             fun_and_grad=fun_and_grad,
                             active_tol=polish_active_tol, prior=res,
                             device=device)
    return _gather_result(res, batch, group)
