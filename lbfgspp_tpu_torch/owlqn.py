"""OWL-QN: L1-regularized L-BFGS, batched.

The port's counterpart of ``lbfgspp_tpu.owlqn`` (Andrew & Gao, "Scalable
training of L1-regularized log-linear models", ICML 2007).  It minimizes
``loss(x) + sum_i l1_i |x_i|`` for every instance of a batch:

* the pseudo-gradient stands in for the gradient of ``|x|`` at 0;
* the two-loop direction is taken from the pseudo-gradient through a
  history of **loss**-gradient differences (the L1 term has no
  curvature), then aligned to the pseudo-descent orthant;
* the projected backtracking Armijo search puts every trial point back
  onto the chosen orthant, so coordinates that cross zero land exactly on
  ``+0.0``.

As in :mod:`.lbfgs`, the state carries a leading batch axis and finished
instances keep their state; the line search runs in lockstep until the
slowest instance of the batch is done, as the JAX package's vmapped
``lax.while_loop`` does.  ``l1`` is a scalar, ``[n]`` or ``[B, n]`` (per
instance, the batch-explicit form of vmapping the JAX solve over lambda);
entries equal to 0 leave a coordinate unpenalized.

:data:`COUNTS` holds the batched iterations and the batched objective
evaluations (lockstep line-search trials) of the solves since its last
``clear()``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from .lbfgs import as_batch, unbatch
from .ops import history as hist_ops
from .parallel import collectives as coll
from .params import LBFGSParams
from .types import (SolveResult, Status, data_fun_and_grad, freeze_when,
                    i32_like, matmul_tf32, resolve_device, tree_select)

Tensor = torch.Tensor

# Batched iterations ("iterations") and batched objective evaluations
# ("evaluations": the start point's and every lockstep trial's) since the
# last clear().
COUNTS: collections.Counter = collections.Counter()


def pseudo_gradient(x: Tensor, g: Tensor, lam: Tensor) -> Tensor:
    """Andrew & Gao's pseudo-gradient of ``loss + lam |x|``
    (lbfgspp_tpu/owlqn.py:51-64): ``g + lam sign(x)`` where ``x != 0``;
    at ``x == 0`` the one-sided slope into the descent orthant, ``g +
    lam`` if negative, ``g - lam`` if positive, else 0."""
    right = g + lam
    left = g - lam
    at_zero = torch.where(right < 0, right,
                          torch.where(left > 0, left, 0.0))
    return torch.where(x != 0, g + lam * torch.sign(x), at_zero)


class OWLQNState(NamedTuple):
    """Full solver state; every field has the batch axis first."""

    k: Tensor          # [B] int32
    x: Tensor          # [B, n]
    fx: Tensor         # [B] loss + L1 (the full objective)
    grad: Tensor       # [B, n] LOSS gradient at x
    pgrad: Tensor      # [B, n] pseudo-gradient at x
    gnorm: Tensor      # [B] ||pseudo-gradient||_2
    hist: hist_ops.LBFGSHistory
    fx_ring: Tensor    # [B, max(past, 1)]
    done: Tensor       # [B] bool
    status: Tensor     # [B] int32
    nfev: Tensor       # [B] int32


class _LS(NamedTuple):
    step: Tensor
    x: Tensor
    fx: Tensor
    grad: Tensor
    it: Tensor
    done: Tensor
    status: Tensor


def _norm(a: Tensor) -> Tensor:
    return torch.linalg.vector_norm(a, dim=-1)


def _with_tf32(fg: Callable, allowed: bool) -> Callable:
    """``fg`` with its matmuls at TF32 (``allowed``) or full float32, in a
    scope around the objective only."""
    def wrapped(x):
        with matmul_tf32(allowed):
            return fg(x)
    return wrapped


def minimize_owlqn(fun: Optional[Callable] = None,
                   x0=None,
                   l1: Any = None,
                   params: LBFGSParams = LBFGSParams(),
                   *,
                   fun_and_grad=None,
                   data: Any = None,
                   history_dtype=None,
                   fast_phase_epsilon: Optional[float] = None,
                   device=None) -> SolveResult:
    """Minimize ``fun(x) + sum(l1 * |x|)`` with OWL-QN
    (lbfgspp_tpu/owlqn.py:95-306).

    ``fun(x[n])`` (or ``fun_and_grad``) is the SMOOTH part for one
    instance; with ``data`` (a tensor or tree of tensors with a leading
    ``[B]`` axis) it is ``fun(x[n], data_i)``.  ``x0`` is ``[n]`` (one
    solve; the result has no batch axis) or ``[B, n]``; ``l1`` a
    nonnegative scalar, ``[n]`` or ``[B, n]``.  ``params``:
    ``epsilon``/``epsilon_rel`` test the pseudo-gradient norm; ``ftol``,
    ``max_linesearch``, ``min_step``, ``m``, ``past``/``delta`` and
    ``max_iterations`` keep their meanings.

    ``fast_phase_epsilon``: a two-phase run.  Phase 1 runs the objective
    with ``torch.backends.cuda.matmul.allow_tf32 = True`` (set around the
    objective only; the card's counterpart of the TPU's default bf16
    passes) down to ``max(epsilon, fast_phase_epsilon)``; phase 2 restarts
    from its iterate with the objective at full float32 and finishes to
    ``params.epsilon``.  ``niter``/``nfev`` add up over both phases.

    Returns a :class:`~.types.SolveResult`: ``fx`` is the full objective,
    ``grad`` the loss gradient, ``gnorm`` the pseudo-gradient norm;
    coordinates at zero are exact zeros.  ``history_dtype`` stores the
    (s, y) rows at reduced precision (as :func:`.lbfgs.solver` does).
    """
    if x0 is None:
        raise ValueError("x0 is required")
    if fun_and_grad is None and fun is None:
        raise ValueError("either 'fun' or 'fun_and_grad' must be given")
    device = resolve_device(device)
    single = torch.as_tensor(x0).dim() == 1
    x0 = as_batch(x0, device)
    lam = torch.as_tensor(0.0 if l1 is None else l1, dtype=x0.dtype,
                          device=device).expand(x0.shape)
    fg = data_fun_and_grad(fun, fun_and_grad, data)
    if fast_phase_epsilon is None:
        res = _solve(fg, x0, lam, params, history_dtype)
    else:
        coarse = dataclasses.replace(
            params, epsilon=max(params.epsilon, float(fast_phase_epsilon)))
        r1 = _solve(_with_tf32(fg, True), x0, lam, coarse, history_dtype)
        r2 = _solve(_with_tf32(fg, False), r1.x, lam, params, history_dtype)
        res = r2._replace(niter=r1.niter + r2.niter, nfev=r1.nfev + r2.nfev)
    return unbatch(res) if single else res


def _solve(fg, x0: Tensor, lam: Tensor, params: LBFGSParams,
           history_dtype=None, group=None) -> SolveResult:
    """One OWL-QN run of the batched oracle ``fg`` from ``x0 [B, n]``;
    ``history_dtype``: the rows' storage dtype.

    ``group``: ``x0``, ``lam`` and the oracle's gradient are this rank's
    feature block.  The L1 term's sum rides the objective's all-reduce,
    and so do the start's norms and a trial's Armijo decrease; each
    iteration adds one for ``pg.d`` and ``||d||``, the history's fused
    products (with the convergence norms) and the two-loop recursion:
    the JAX package's five (tests/test_collective_audit.py:154-173)."""
    batch, n = x0.shape
    dtype, device = x0.dtype, x0.device
    penalized = lam > 0
    fpast = params.past
    ftol = params.ftol

    def full_obj(x, extra=None, site="owlqn.objective"):
        """``(loss + l1 term, loss gradient, sums of extra(g))``."""
        def sums(g):
            l1 = (lam * x.abs()).sum(-1)[:, None]
            return l1 if extra is None else torch.cat([l1, extra(g)], 1)
        loss, g, red = coll.evaluate(fg, x, sums, group, site)
        COUNTS["evaluations"] += 1
        return loss + red[:, 0], g, red[:, 1:]

    def sq_parts(pg, x):
        """The local partials ``[pg.pg, x.x]``, ``[B, 2]``."""
        return torch.stack([torch.linalg.vecdot(pg, pg),
                            torch.linalg.vecdot(x, x)], dim=1)

    def norms(pg, x, sq):
        """``(||pg||, ||x||)``: from the vectors without a group, else
        from their global squared sums ``sq``."""
        if group is None:
            return _norm(pg), _norm(x)
        return torch.sqrt(sq[:, 0]), torch.sqrt(sq[:, 1])

    def converged(gnorm, xnorm):
        return (gnorm <= params.epsilon) | \
            (gnorm <= params.epsilon_rel * xnorm)

    def init() -> OWLQNState:
        fx0, g0, sq = full_obj(
            x0, None if group is None else
            (lambda g: sq_parts(pseudo_gradient(x0, g, lam), x0)),
            "owlqn.init")
        pg0 = pseudo_gradient(x0, g0, lam)
        gnorm0, xnorm0 = norms(pg0, x0, sq)
        early = converged(gnorm0, xnorm0)
        fx_ring = torch.zeros((batch, max(fpast, 1)), dtype=dtype,
                              device=device)
        if fpast > 0:
            fx_ring[:, 0] = fx0
        return OWLQNState(
            k=i32_like(1, fx0), x=x0, fx=fx0, grad=g0, pgrad=pg0,
            gnorm=gnorm0,
            hist=hist_ops.init_history(batch, n, params.m, dtype,
                                       store_dtype=history_dtype,
                                       device=device),
            fx_ring=fx_ring, done=early,
            status=torch.where(early, i32_like(Status.CONVERGED_GRAD, fx0),
                               i32_like(Status.RUNNING, fx0)),
            nfev=i32_like(1, fx0))

    def body(c: OWLQNState) -> OWLQNState:
        COUNTS["iterations"] += 1
        # Direction from the pseudo-gradient through the loss-curvature
        # history, then orthant alignment: zero every component that is
        # not a descent component of the pseudo-gradient (:209-213).
        d = hist_ops.apply_hv(c.hist, c.pgrad, -1.0, tri="sweeps",
                              group=group)
        d = torch.where(penalized & (d * c.pgrad >= 0), 0.0, d)
        # Chosen orthant: the current sign, else the pseudo-descent sign.
        xi = torch.where(c.x != 0, torch.sign(c.x), torch.sign(-c.pgrad))
        if group is None:
            dg, dnorm = torch.linalg.vecdot(c.pgrad, d), _norm(d)
        else:
            dg, dd = coll.pdot2(c.pgrad, d, d, d, group, "owlqn.direction")
            dnorm = torch.sqrt(dd)
        bad_dir = dg >= 0
        step0 = torch.where(
            c.k == 1, 1.0 / torch.clamp(dnorm, min=torch.finfo(dtype).tiny),
            torch.ones_like(dnorm))

        def trial(s: _LS) -> _LS:
            # Project onto the orthant: coordinates that crossed land on
            # an exact +0.0 (a literal zero, as :223-224 writes).
            xt = c.x + s.step[:, None] * d
            xt = torch.where(penalized & (xt * xi <= 0), 0.0, xt)
            # Armijo on the projected step: f(xt) <= f(x) + ftol pg.(xt-x)
            ft, gt, dec = full_obj(
                xt, lambda g: torch.linalg.vecdot(c.pgrad, xt - c.x)[:, None],
                "owlqn.trial")
            dec = dec[:, 0]
            ok = ft <= c.fx + ftol * dec
            it = s.it + 1
            exhausted = it >= params.max_linesearch
            too_small = s.step * 0.5 < params.min_step
            status = torch.where(
                ok, i32_like(Status.RUNNING, ft),
                torch.where(exhausted,
                            i32_like(Status.LS_MAX_LINESEARCH, ft),
                            torch.where(too_small,
                                        i32_like(Status.LS_STEP_TOO_SMALL,
                                                 ft),
                                        i32_like(Status.RUNNING, ft))))
            done = ok | exhausted | too_small
            return _LS(step=torch.where(done, s.step, s.step * 0.5),
                       x=torch.where(ok[:, None], xt, s.x),
                       fx=torch.where(ok, ft, s.fx),
                       grad=torch.where(ok[:, None], gt, s.grad),
                       it=it, done=done, status=status)

        ls = _LS(step=step0, x=c.x, fx=c.fx, grad=c.grad,
                 it=torch.zeros_like(c.k),
                 done=bad_dir | c.done,
                 status=torch.where(bad_dir,
                                    i32_like(Status.LS_NOT_DESCENT, c.k),
                                    i32_like(Status.RUNNING, c.k)))
        # Lockstep: trials for the batch until its slowest instance is
        # done; a finished instance keeps its carry.
        live = ~ls.done
        while bool(live.any()):
            ls = tree_select(live, trial(ls), ls)
            live = ~ls.done
        ls_fail = ls.status != Status.RUNNING
        nfev = c.nfev + ls.it

        pg1 = pseudo_gradient(ls.x, ls.grad, lam)
        # Curvature from LOSS gradients (the L1 part has none); under a
        # group the convergence norms ride the products' all-reduce.
        s_vec, y_vec = ls.x - c.x, ls.grad - c.grad
        products, sq = None, None
        if group is not None:
            *products, sq = hist_ops.correction_products(
                c.hist, s_vec, y_vec, group, sq_parts(pg1, ls.x))
        gnorm1, xnorm1 = norms(pg1, ls.x, sq)
        conv_grad = converged(gnorm1, xnorm1)

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
            torch.where(conv_grad, i32_like(Status.CONVERGED_GRAD, c.k),
                        torch.where(conv_past,
                                    i32_like(Status.CONVERGED_DELTA, c.k),
                                    torch.where(
                                        max_iter,
                                        i32_like(Status.MAX_ITERATIONS, c.k),
                                        i32_like(Status.RUNNING, c.k)))))

        hist, _ = hist_ops.update_history(c.hist, s_vec, y_vec, ~ls_fail,
                                          products=products)
        return OWLQNState(
            k=torch.where(done, c.k, c.k + 1), x=ls.x, fx=ls.fx,
            grad=ls.grad, pgrad=pg1, gnorm=gnorm1, hist=hist,
            fx_ring=fx_ring, done=done, status=status, nfev=nfev)

    state = init()
    while not bool(state.done.all()):
        state = freeze_when(state.done, state, body)
    return SolveResult(x=state.x, fx=state.fx, grad=state.grad,
                       gnorm=state.gnorm, niter=state.k, nfev=state.nfev,
                       status=state.status, history=state.hist)
