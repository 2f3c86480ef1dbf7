"""Unconstrained L-BFGS solver, batched.

The port's counterpart of ``lbfgspp_tpu.lbfgs`` (LBFGS++'s LBFGS.h:79-173).
The JAX package writes one solve as a ``lax.while_loop`` and batches it
with ``vmap``; here the state carries a leading batch axis ``B`` (a single
solve is ``B = 1``), every step runs for the whole batch, and instances
that have finished keep their state through :func:`..types.freeze_when` —
the frozen carry that ``vmap`` of the while loop gives the JAX package.

Algorithmic invariants, per instance, as in the reference: first direction
``-g`` with step ``1/||g||``; the step resets to 1 after every iteration;
the curvature gate ``s'y > eps * y'y``; convergence when ``||g|| <=
max(epsilon, epsilon_rel * ||x||)``, plus the optional past/delta test;
``max_iterations == 0`` means unlimited.
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable, NamedTuple, Optional

import torch

from .linesearch import get_line_search
from .ops import history as hist_ops
from .parallel import collectives as coll
from .params import LBFGSParams
from .types import (SolveResult, Status, freeze_when, i32_like,
                    make_fun_and_grad, resolve_device, tree_map)

Tensor = torch.Tensor

DIRECTIONS = ("sweeps", "rinv", "doubling")


class LBFGSState(NamedTuple):
    """Full solver state; every field has the batch axis first."""

    k: Tensor          # [B] int32
    x: Tensor          # [B, n]
    fx: Tensor         # [B]
    grad: Tensor       # [B, n]
    gnorm: Tensor      # [B]
    drt: Tensor        # [B, n]
    step: Tensor       # [B]
    hist: hist_ops.LBFGSHistory
    fx_ring: Tensor    # [B, max(past, 1)]
    done: Tensor       # [B] bool
    status: Tensor     # [B] int32
    nfev: Tensor       # [B] int32


class Solver(NamedTuple):
    """``init(x0) -> state``; ``step(state) -> state`` runs ONE iteration of
    every unfinished instance; ``run(state)`` steps until every instance
    has finished; ``run_fixed(state, iters)`` runs exactly ``iters`` steps
    (the same result as ``run`` when ``iters`` covers every instance's
    end); ``finalize(state) -> SolveResult``."""

    init: Callable
    step: Callable
    finalize: Callable
    run: Callable
    run_fixed: Callable


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.vecdot(a, b)


def as_batch(x0, device: torch.device) -> Tensor:
    """``x0`` ([n] or [B, n], tensor or array) as a [B, n] tensor on
    ``device``; the dtype follows ``x0``."""
    x0 = torch.as_tensor(x0, device=device)
    if x0.dim() == 1:
        x0 = x0[None]
    if x0.dim() != 2:
        raise ValueError(f"x0 must be [n] or [B, n], got shape "
                         f"{tuple(x0.shape)}")
    return x0.contiguous()


def solver(fun: Optional[Callable] = None,
           params: LBFGSParams = LBFGSParams(),
           *,
           fun_and_grad=None,
           line_search="nocedalwright",
           direction: str = "sweeps",
           on_ls_fail: str = "stop",
           history_dtype=None,
           group=None,
           device=None) -> Solver:
    """Build the batched L-BFGS ``init/step/run/run_fixed/finalize``.

    ``fun(x[n]) -> fx`` or ``fun_and_grad(x[n]) -> (fx, grad)`` is the
    objective of ONE instance; it is mapped over the batch.

    ``direction`` is the two-loop schedule (:func:`.ops.history.apply_hv`):
    ``"sweeps"`` (bit-parity), ``"rinv"`` (the maintained ``R^{-1}``
    factor) or ``"doubling"``.  On a CUDA device, ``sweeps`` and ``rinv``
    launch the two-loop kernel once per iteration.

    ``on_ls_fail``: ``"stop"`` ends an instance with the failed search's
    status (the reference's throw); ``"restart"`` keeps the failed trial
    only if it is finite and no worse, resets the curvature history, and
    continues from steepest descent (needs a finite
    ``params.max_iterations``).

    ``history_dtype`` (such as ``torch.bfloat16``) stores the (s, y)
    correction rows at reduced precision while every reduction stays in
    the solve's dtype (lbfgspp_tpu/lbfgs.py:107-111): it halves the bytes
    of the per-iteration row streams, and the gate, theta and Grams still
    use the exact pair.  On the card a float32 solve with bf16 rows runs
    the kernel's bf16-row instantiation.

    ``group``: a ``torch.distributed`` process group over which ``x`` is
    split on its feature axis (:mod:`.parallel.sharded`); the oracle then
    sees this rank's ``[B, n_local]`` block, and every reduction is one
    all-reduce over the group.

    ``device`` defaults to the CUDA card; pass ``device="cpu"`` to run on
    the CPU.

    .. warning:: ``direction="rinv"`` with m > 16 is outside the regime
       where its f32 solution quality was measured safe; a
       ``UserWarning`` fires.
    """
    return _build_solver(make_fun_and_grad(fun, fun_and_grad), params,
                         line_search=line_search, direction=direction,
                         on_ls_fail=on_ls_fail, history_dtype=history_dtype,
                         group=group, device=device)


def _build_solver(fg, params: LBFGSParams, *,
                  line_search="nocedalwright", direction: str = "sweeps",
                  on_ls_fail: str = "stop", history_dtype=None,
                  group=None, device=None) -> Solver:
    """:func:`solver` on a ready batched oracle ``fg(x [B, n]) -> (fx [B],
    grad [B, n])``, such as a pair-space oracle of
    :mod:`.utils.doublefloat`.

    Under ``group`` the reductions take these all-reduces: the start's
    norms ride the objective's (or one of their own), each iteration
    takes one for ``g.d``, the line search's, one for the history's fused
    products with the convergence norms, and one in the two-loop
    recursion; the JAX package's compiled program has the same
    (tests/test_collective_audit.py:72-76)."""
    if on_ls_fail not in ("stop", "restart"):
        raise ValueError(f"on_ls_fail must be 'stop' or 'restart', "
                         f"got {on_ls_fail!r}")
    if on_ls_fail == "restart" and params.max_iterations == 0:
        raise ValueError("on_ls_fail='restart' requires a finite "
                         "params.max_iterations (a permanently-failing "
                         "instance would loop forever)")
    if direction not in DIRECTIONS:
        raise ValueError(f"direction must be one of {DIRECTIONS}, got "
                         f"{direction!r}")
    if direction == "rinv" and params.m > 16:
        warnings.warn(
            f"direction='rinv' with m={params.m} > 16 is outside the "
            f"measured-safe f32 regime and has a measured "
            f"solution-quality cliff at larger m; use m <= 16 in f32, or "
            f"direction='sweeps' for large histories",
            UserWarning, stacklevel=2)
    device = resolve_device(device)
    search = get_line_search(line_search)
    if group is not None:
        search = functools.partial(search, group=group)
    fpast = params.past
    restart = on_ls_fail == "restart"

    def norms(g: Tensor, x: Tensor) -> Tensor:
        """The local partials ``[g.g, x.x]``, ``[B, 2]``."""
        return torch.stack([_dot(g, g), _dot(x, x)], dim=1)

    def init(x0, fg0=None) -> LBFGSState:
        """``fg0``: optional precomputed ``(fx0 [B], grad0 [B, n])``."""
        x0 = as_batch(x0, device)
        batch, n = x0.shape
        if fg0 is None:
            fx0, grad0, sq = coll.evaluate(fg, x0, lambda g: norms(g, x0),
                                           group, "lbfgs.init")
        else:
            (fx0, grad0), sq = fg0, coll.psum(norms(fg0[1], x0), group,
                                              "lbfgs.init.extra")
        gnorm0, xnorm0 = torch.sqrt(sq[:, 0]), torch.sqrt(sq[:, 1])
        fx_ring = torch.zeros((batch, max(fpast, 1)), dtype=x0.dtype,
                              device=device)
        if fpast > 0:
            fx_ring[:, 0] = fx0
        # Early exit if x0 is already a minimizer (LBFGS.h:100-103).
        early = (gnorm0 <= params.epsilon) | \
            (gnorm0 <= params.epsilon_rel * xnorm0)
        drt0 = -grad0
        return LBFGSState(
            k=i32_like(1, fx0), x=x0, fx=fx0, grad=grad0, gnorm=gnorm0,
            drt=drt0, step=1.0 / gnorm0,
            hist=hist_ops.init_history(batch, n, params.m, x0.dtype,
                                       store_dtype=history_dtype,
                                       device=device,
                                       with_rinv=direction == "rinv"),
            fx_ring=fx_ring, done=early,
            status=torch.where(early, i32_like(Status.CONVERGED_GRAD, fx0),
                               i32_like(Status.RUNNING, fx0)),
            nfev=i32_like(1, fx0))

    def body(c: LBFGSState) -> LBFGSState:
        xp, gradp = c.x, c.grad
        dg = coll.pdot(c.grad, c.drt, group, "lbfgs.dg")
        ls = search(fg, params, xp, c.drt, params.max_step, c.step, c.fx,
                    c.grad, dg, active=~c.done)
        nfev = c.nfev + ls.nfev
        ls_fail = ls.status != Status.RUNNING

        if restart:
            # Keep the failed search's point only if it is finite and no
            # worse; otherwise restore the pre-search iterate.
            accept = (~ls_fail) | (torch.isfinite(ls.fx) & (ls.fx <= c.fx))
            x_new = torch.where(accept[:, None], ls.x, xp)
            fx_new = torch.where(accept, ls.fx, c.fx)
            grad_new = torch.where(accept[:, None], ls.grad, gradp)
        else:
            x_new, fx_new, grad_new = ls.x, ls.fx, ls.grad
        # The history's products (LBFGS.h:159-162) come first: under a
        # group the convergence norms ride their all-reduce, one
        # collective, as XLA fuses them (lbfgspp_tpu/lbfgs.py:281-298).
        s_vec, y_vec = x_new - xp, grad_new - gradp
        *products, sq = hist_ops.correction_products(
            c.hist, s_vec, y_vec, group, norms(grad_new, x_new))
        gnorm, xnorm = torch.sqrt(sq[:, 0]), torch.sqrt(sq[:, 1])

        # Convergence test: gradient (LBFGS.h:137-140)
        conv_grad = (gnorm <= params.epsilon) | \
            (gnorm <= params.epsilon_rel * xnorm)

        # Convergence test: objective decrease (LBFGS.h:142-149)
        if fpast > 0:
            slot = (c.k % fpast).long()[:, None]
            fxd = c.fx_ring.gather(1, slot)[:, 0]
            conv_past = (c.k >= fpast) & \
                ((fxd - fx_new).abs() <= params.delta * torch.clamp(
                    torch.maximum(fx_new.abs(), fxd.abs()), min=1.0))
            fx_ring = c.fx_ring.scatter(1, slot, fx_new[:, None])
        else:
            conv_past = torch.zeros_like(conv_grad)
            fx_ring = c.fx_ring

        # Iteration cap (LBFGS.h:151-154)
        max_iter = (c.k >= params.max_iterations) if \
            params.max_iterations != 0 else torch.zeros_like(conv_grad)

        if restart:
            # A failed-search iteration made no (or restored) progress, so
            # the past/delta test is suppressed on it: a permanently
            # failing instance reports MAX_ITERATIONS, not a success.
            conv_past = conv_past & ~ls_fail
        status = torch.where(
            conv_grad, i32_like(Status.CONVERGED_GRAD, fx_new),
            torch.where(conv_past, i32_like(Status.CONVERGED_DELTA, fx_new),
                        torch.where(max_iter,
                                    i32_like(Status.MAX_ITERATIONS, fx_new),
                                    i32_like(Status.RUNNING, fx_new))))
        if restart:
            done = conv_grad | conv_past | max_iter
        else:
            done = ls_fail | conv_grad | conv_past | max_iter
            status = torch.where(ls_fail, ls.status, status)

        # History update with curvature gate (LBFGS.h:159-162)
        hist, _ = hist_ops.update_history(c.hist, s_vec, y_vec,
                                          ~done & ~ls_fail,
                                          products=products)
        if restart:
            # SOFT reset of a failed instance: every read of the rows,
            # Grams and rinv is masked by the ring validity test, so
            # ncorr = 0 (and theta = 1) makes the stale data unreachable.
            hist = hist._replace(
                ncorr=torch.where(ls_fail, torch.zeros_like(hist.ncorr),
                                  hist.ncorr),
                theta=torch.where(ls_fail, torch.ones_like(hist.theta),
                                  hist.theta))

        # New direction d = -H g (LBFGS.h:165) and step reset (LBFGS.h:168)
        drt = hist_ops.apply_hv(hist, grad_new, -1.0, tri=direction,
                                group=group)
        step_new = torch.ones_like(fx_new)
        if restart:
            gsafe = torch.where(gnorm > 0.0, gnorm, 1.0)
            step_new = torch.where(ls_fail, 1.0 / gsafe, step_new)

        return LBFGSState(
            k=torch.where(done, c.k, c.k + 1),
            x=x_new, fx=fx_new, grad=grad_new, gnorm=gnorm, drt=drt,
            step=step_new, hist=hist, fx_ring=fx_ring,
            done=done, status=status, nfev=nfev)

    def step(c: LBFGSState) -> LBFGSState:
        # Finished instances keep their state, so a step on a done state
        # is a no-op.
        return freeze_when(c.done, c, body)

    def run(c: LBFGSState) -> LBFGSState:
        while not bool(c.done.all()):
            c = step(c)
        return c

    def run_fixed(c: LBFGSState, iters: int) -> LBFGSState:
        for _ in range(iters):
            c = step(c)
        return c

    def finalize(c: LBFGSState) -> SolveResult:
        return SolveResult(x=c.x, fx=c.fx, grad=c.grad, gnorm=c.gnorm,
                           niter=c.k, nfev=c.nfev, status=c.status,
                           history=c.hist)

    return Solver(init=init, step=step, finalize=finalize, run=run,
                  run_fixed=run_fixed)


def unbatch(tree):
    """Drop the batch axis of a B = 1 NamedTuple of tensors (``None``
    fields stay ``None``)."""
    return tree_map(lambda t: t[0], tree)


def minimize(fun: Optional[Callable] = None,
             x0=None,
             params: LBFGSParams = LBFGSParams(),
             *,
             fun_and_grad=None,
             line_search="nocedalwright",
             direction: str = "sweeps",
             on_ls_fail: str = "stop",
             history_dtype=None,
             device=None) -> SolveResult:
    """Minimize ``fun`` from ``x0`` with L-BFGS (LBFGS.h:79-173).

    ``x0`` is ``[n]`` (one solve; the result has no batch axis, as with
    the JAX package) or ``[B, n]`` (B independent solves of the same
    objective; every result field has the batch axis).  See
    :func:`solver` for the options.
    """
    if x0 is None:
        raise ValueError("x0 is required")
    s = solver(fun, params, fun_and_grad=fun_and_grad,
               line_search=line_search, direction=direction,
               on_ls_fail=on_ls_fail, history_dtype=history_dtype,
               device=device)
    single = torch.as_tensor(x0).dim() == 1
    res = s.finalize(s.run(s.init(x0)))
    return unbatch(res) if single else res


def _dense(hist, fn):
    """``fn`` of a batched history, or of one without the batch axis (the
    result of a solve from a 1-D ``x0``), with the same axes back."""
    if hist.s.dim() == 2:
        return fn(tree_map(lambda t: t[None], hist))[0]
    return fn(hist)


def final_approx_hessian(result: SolveResult) -> Tensor:
    """Dense approximate Hessian at the final iterate, ``[B, n, n]`` or
    ``[n, n]`` (``final_approx_hessian``, LBFGS.h:192;
    lbfgspp_tpu/lbfgs.py:359-362)."""
    return _dense(result.history, hist_ops.bmat)


def final_approx_inverse_hessian(result: SolveResult) -> Tensor:
    """Dense approximate inverse Hessian at the final iterate (``final_
    approx_inverse_hessian``, LBFGS.h:197; lbfgspp_tpu/lbfgs.py:365-368)."""
    return _dense(result.history, hist_ops.hmat)
