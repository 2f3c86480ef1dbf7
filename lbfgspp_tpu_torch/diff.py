"""Implicit differentiation of solves, batched: ``d x*(theta) / d theta``.

The port's counterpart of ``lbfgspp_tpu.diff.implicit_minimize``.  For a
parametric objective ``f(x, theta)`` the solution ``x*(theta)`` satisfies
``g(x*, theta) = 0`` (``g = grad_x f``), so by the implicit function
theorem a cotangent ``v`` on ``x*`` costs one linear solve ``H_xx u = v``
and one mixed vector-Jacobian product, with no differentiation through the
iterations.  :func:`implicit_minimize` is a ``torch.autograd.Function``:

* forward: the ordinary batched solve (:mod:`.lbfgs`, or :mod:`.lbfgsb`
  with ``lb``/``ub``) under ``no_grad``;
* backward: conjugate gradients on Hessian-vector products
  (``torch.func.jvp`` of each instance's gradient), in lockstep over the
  batch, each instance frozen once its own residual test holds (a batched
  transcription of ``jax.scipy.sparse.linalg.cg``), preconditioned by the
  solve's own curvature history through the two-loop kernel.

Box constraints restrict the solve to the free coordinates (active ones
have derivative 0, under strict complementarity).  Only ``x`` and ``fx``
of the result carry derivatives; ``fx`` takes the envelope theorem's
``partial_theta f`` plus the indirect term.

:data:`COUNTS` holds, since its last ``clear()``, the lockstep CG
iterations of the backward passes (``"cg_iterations"``: each launches the
two-loop kernel once when preconditioned, plus once for the first
residual) and the iterations the instances needed (``"instance_iterations"``
over ``"instances"``).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from . import lbfgs, lbfgsb
from .ops import history as hist_ops
from .parallel import collectives as coll
from .params import LBFGSBParams, LBFGSParams
from .types import SolveResult, data_fun_and_grad, resolve_device

Tensor = torch.Tensor

COUNTS: collections.Counter = collections.Counter()


def _resolve_cg_tol(cg_tol: Optional[float], dtype) -> float:
    """Dtype-aware default CG tolerance (lbfgspp_tpu/diff.py:81-87): 1e-8
    in f64; in f32 the attainable relative residual is ~eps, so 3e-6."""
    if cg_tol is not None:
        return cg_tol
    return 1e-8 if torch.finfo(dtype).bits >= 64 else 3e-6


def cg(amat: Callable, b: Tensor, tol: float, maxiter: int,
       minv: Optional[Callable] = None, group=None) -> Tensor:
    """Preconditioned conjugate gradients for every instance of ``b [B,
    n]``, from ``x0 = 0``: ``jax.scipy.sparse.linalg.cg``'s ``_cg_solve``
    (jax/_src/scipy/sparse/linalg.py:103-137) with ``atol = 0``, batched.
    An instance runs while ``r.r > max(tol^2 b.b, 0)`` (``r.z`` without a
    preconditioner) and it has taken fewer than ``maxiter`` iterations;
    the loop runs until every instance has stopped, finished instances
    keep their carry.  ``r0 = b - A(0) = b``.  The denominators of
    finished instances are replaced by 1, so an instance with ``b = 0``
    gives 0.

    ``group``: the vectors are this rank's feature block (the collective
    CG of lbfgspp_tpu/diff.py:237-267); ``r.z`` and ``r.r`` ride one
    all-reduce, ``p.Ap`` takes another, and the start's three dots one."""
    x = torch.zeros_like(b)
    r = b
    z = r if minv is None else minv(r)
    bb, gamma = coll.pdot2(b, b, r, z, group, "cg.start")
    rr = bb                                              # r = b
    atol2 = torch.clamp(tol * tol * bb, min=0.0)
    p = z
    k = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)

    def running(gamma, rr, k):
        rs = gamma if minv is None else rr
        return (rs > atol2) & (k < maxiter)

    live = running(gamma, rr, k)
    while bool(live.any()):
        COUNTS["cg_iterations"] += 1
        ap = amat(p)
        alpha = gamma / torch.where(live, coll.pdot(p, ap, group, "cg.pap"),
                                    1.0)
        x_new = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * ap
        z_new = r_new if minv is None else minv(r_new)
        gamma_new, rr_new = coll.pdot2(r_new, z_new, r_new, r_new, group,
                                       "cg.rz")
        beta = gamma_new / torch.where(live, gamma, 1.0)
        p_new = z_new + beta[:, None] * p
        lv = live[:, None]
        x = torch.where(lv, x_new, x)
        r = torch.where(lv, r_new, r)
        p = torch.where(lv, p_new, p)
        gamma = torch.where(live, gamma_new, gamma)
        rr = torch.where(live, rr_new, rr)
        k = torch.where(live, k + 1, k)
        live = running(gamma, rr, k)
    COUNTS["instance_iterations"] += int(k.sum())
    COUNTS["instances"] += k.numel()
    return x


class _Problem:
    """What the autograd function needs besides tensors: the objective,
    the solver options and the structure of ``theta``; the solve's other
    fields come back through ``result``."""

    def __init__(self, fun, fun_and_grad, spec, params, lb, ub,
                 line_search, precondition, cg_tol, cg_maxiter, active_tol,
                 device, group=None, batched=False):
        self.fun, self.fun_and_grad, self.spec = fun, fun_and_grad, spec
        self.params, self.lb, self.ub = params, lb, ub
        self.line_search, self.precondition = line_search, precondition
        self.cg_tol, self.cg_maxiter = cg_tol, cg_maxiter
        self.active_tol, self.device = active_tol, device
        # batched: fun_and_grad is ``(x [B, n_local], theta) -> (fx [B],
        # grad_local)`` with the whole objective's collectives inside
        self.group, self.batched = group, batched
        self.result = None

    def theta(self, leaves):
        return pytree.tree_unflatten(list(leaves), self.spec)

    def value(self, x, th):
        if self.fun is not None:
            return self.fun(x, th)
        return self.fun_and_grad(x, th)[0]

    def grad(self, x, th):
        if self.fun_and_grad is not None:
            return self.fun_and_grad(x, th)[1]
        return torch.func.grad(self.fun)(x, th)

    def solve(self, x0, leaves) -> SolveResult:
        if self.batched:
            theta = self.theta(leaves)

            def fg(x):
                return self.fun_and_grad(x, theta)
        else:
            fg = data_fun_and_grad(self.fun, self.fun_and_grad,
                                   self.theta(leaves))
            if self.group is not None:
                # the objective is the rank's partial: its values add up
                fg = coll.ShardedObjective(fg, self.group)
        if self.lb is not None:
            s = lbfgsb._build_solver(fg, self.lb, self.ub, self.params,
                                     line_search=self.line_search,
                                     group=self.group, device=self.device)
        else:
            s = lbfgs._build_solver(fg, self.params,
                                    line_search=self.line_search,
                                    group=self.group, device=self.device)
        return s.finalize(s.run(s.init(x0)))

    def free(self, xs: Tensor) -> Tensor:
        """1.0 on the coordinates strictly inside the box (beyond
        ``active_tol``), 0.0 on the active ones; all 1 without a box."""
        if self.lb is None:
            return torch.ones_like(xs)
        lb, ub = (torch.as_tensor(v, dtype=xs.dtype, device=xs.device)
                  .expand_as(xs) for v in (self.lb, self.ub))
        tol = self.active_tol
        return ((xs > lb + tol) & (xs < ub - tol)).to(xs.dtype)


def _batched_dtheta(prob: _Problem, xs: Tensor, u: Tensor, ct_fx: Tensor,
                    parts, with_parts):
    """This rank's share of ``-(dg/dtheta)' u + ct_fx (df/dtheta)`` for a
    batched oracle with collectives inside: reverse mode through it, the
    replicated value weighted ``1/world`` so that the ranks' shares add
    up to the one objective (the convention of
    :func:`.parallel.collectives.psum_grad`); ``ct_fx`` is the replicated
    cotangent, the same on every rank."""
    world = torch.distributed.get_world_size(prob.group)
    with torch.enable_grad():
        parts = [p.detach().requires_grad_(True) for p in parts]
        fx, g = prob.fun_and_grad(xs, with_parts(parts))
        total = -(g * u).sum() + (ct_fx * fx).sum() / world
        grads = torch.autograd.grad(total, parts, allow_unused=True)
    return [torch.zeros_like(p) if d is None else d
            for p, d in zip(parts, grads)]


class _ImplicitSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prob: _Problem, x0: Tensor, *leaves):
        res = prob.solve(x0, leaves)
        prob.result = res
        ctx.prob, ctx.history = prob, res.history
        ctx.save_for_backward(res.x, res.grad, *leaves)
        return res.x, res.fx

    @staticmethod
    def backward(ctx, ct_x: Tensor, ct_fx: Tensor):
        prob = ctx.prob
        xs, gs, *leaves = ctx.saved_tensors
        dtype = xs.dtype
        free = prob.free(xs)
        # The cotangent reaching x*: the direct one plus fx's indirect
        # term (zero at exact stationarity; kept for inexact solves).
        # Split, fx is replicated and so is its cotangent, as a
        # replicated input of shard_map (lbfgspp_tpu/diff.py:447):
        # the loss counts fx once.
        ct_fx = ct_fx.to(dtype)
        rhs = free * (ct_x + ct_fx[:, None] * gs)
        theta = prob.theta(leaves)

        if prob.batched:
            # An objective with collectives inside: c10d does not map
            # under vmap, so the products are reverse-mode over the batch,
            # J'u = H u of the gradient's graph at x*, recorded once; the
            # collectives' backward makes them global.
            with torch.enable_grad():
                x_at = xs.detach().requires_grad_(True)
                g_at = prob.fun_and_grad(x_at, theta)[1]

            def hvp(u):
                return torch.autograd.grad(g_at, x_at, u,
                                           retain_graph=True)[0]
        else:
            def hvp_one(x, th, u):
                return torch.func.jvp(lambda xx: prob.grad(xx, th), (x,),
                                      (u,))[1]

            def hvp(u):
                return torch.func.vmap(hvp_one)(xs, theta, u)

        def amat(u):
            return free * hvp(free * u) + (1.0 - free) * u

        minv = None
        if prob.precondition:
            # The box solver's history is a BHistory; the two-loop
            # preconditioner takes its base L-BFGS history.
            base = getattr(ctx.history, "base", ctx.history)

            def minv(r):
                return free * hist_ops.apply_hv(base, free * r, 1.0,
                                                group=prob.group) + \
                    (1.0 - free) * r

        u = free * cg(amat, rhs, _resolve_cg_tol(prob.cg_tol, dtype),
                      prob.cg_maxiter, minv, prob.group)

        # dtheta = -(dg/dtheta)' u + ct_fx (df/dtheta), for the leaves of
        # theta that need a gradient.
        need = [i for i, leaf in enumerate(leaves)
                if ctx.needs_input_grad[2 + i]]
        grads = [None] * len(leaves)
        if need:
            def with_parts(parts):
                full = list(leaves)
                for i, part in zip(need, parts):
                    full[i] = part
                return prob.theta(full)

            if prob.batched:
                parts = _batched_dtheta(prob, xs, u, ct_fx,
                                        [leaves[i] for i in need],
                                        with_parts)
            else:
                parts = [leaves[i] for i in need]
                _, g_vjp = torch.func.vjp(
                    lambda *ps: torch.func.vmap(prob.grad)(
                        xs, with_parts(ps)), *parts)
                _, f_vjp = torch.func.vjp(
                    lambda *ps: torch.func.vmap(prob.value)(
                        xs, with_parts(ps)), *parts)
                parts = [dg + df for dg, df in zip(g_vjp(-u),
                                                   f_vjp(ct_fx))]
            # Feature-split: each rank's partial objective gives its share
            # of dtheta; one all-reduce sums the shares.
            for i, part in zip(need, coll.pfused(parts, prob.group,
                                                 "implicit.dtheta")):
                grads[i] = part
        # x0 only selects the basin: the solution is locally constant in
        # it.
        return (None, None, *grads)


def implicit_minimize(fun: Optional[Callable] = None,
                      x0=None,
                      theta: Any = None,
                      params=None,
                      *,
                      fun_and_grad=None,
                      lb=None,
                      ub=None,
                      line_search: Optional[str] = None,
                      precondition: bool = True,
                      cg_tol: Optional[float] = None,
                      cg_maxiter: int = 200,
                      active_tol: float = 0.0,
                      device=None) -> SolveResult:
    """Solve ``argmin_x fun(x, theta)`` and make ``x`` and ``fx``
    differentiable in ``theta`` by the implicit function theorem
    (lbfgspp_tpu/diff.py:102-234).

    ``fun(x[n], theta_i) -> fx`` (or ``fun_and_grad -> (fx, grad)``) is
    one instance's objective.  ``x0`` is ``[n]`` (one solve; ``theta`` a
    tensor or tree of tensors of any shape, and the result has no batch
    axis) or ``[B, n]`` (``theta``'s leaves carry a leading ``[B]`` axis;
    every result field has it).  Leaves of ``theta`` that need no gradient
    are per-instance data at no cost.  With ``lb``/``ub`` (both, ``[n]``
    or ``[B, n]``) the box solver runs and the adjoint solve restricts to
    the coordinates more than ``active_tol`` inside the box.

    ``precondition`` takes the solve's final curvature history (the
    two-loop ``a H v``, on the card the kernel) as the CG preconditioner;
    ``cg_tol`` (default 1e-8 in f64, 3e-6 in f32) and ``cg_maxiter`` bound
    the adjoint solve.  Reverse mode only: ``x`` and ``fx`` carry
    derivatives, every other field is constant.
    """
    if (fun is None) == (fun_and_grad is None):
        raise ValueError("exactly one of 'fun' / 'fun_and_grad' is required")
    boxed = lb is not None or ub is not None
    if boxed and (lb is None or ub is None):
        raise ValueError("boxes need both lb and ub (use +-inf for "
                         "one-sided bounds)")
    if x0 is None:
        raise ValueError("x0 is required")
    if params is None:
        params = LBFGSBParams() if boxed else LBFGSParams()
    if line_search is None:
        line_search = "morethuente" if boxed else "nocedalwright"
    device = resolve_device(device)
    single = torch.as_tensor(x0).dim() == 1
    x0 = lbfgs.as_batch(x0, device)
    leaves, spec = pytree.tree_flatten(theta)
    leaves = [torch.as_tensor(leaf).to(device) for leaf in leaves]
    if single:
        leaves = [leaf[None] for leaf in leaves]
    prob = _Problem(fun, fun_and_grad, spec, params, lb, ub, line_search,
                    precondition, cg_tol, cg_maxiter, active_tol, device)
    x, fx = _ImplicitSolve.apply(prob, x0, *leaves)
    res = prob.result._replace(x=x, fx=fx)
    return lbfgs.unbatch(res) if single else res


def implicit_minimize_sharded(local_fun: Optional[Callable] = None,
                              x0=None,
                              theta: Any = None,
                              params=None,
                              *,
                              local_fun_and_grad: Optional[Callable] = None,
                              lb=None,
                              ub=None,
                              mesh=None,
                              line_search: Optional[str] = None,
                              precondition: bool = True,
                              cg_tol: Optional[float] = None,
                              cg_maxiter: int = 200,
                              active_tol: float = 0.0,
                              device=None) -> SolveResult:
    """:func:`implicit_minimize` with ``x`` split over the ranks of
    ``mesh`` on its feature axis (lbfgspp_tpu/diff.py:270-462).

    The objective follows :mod:`.parallel.sharded`'s contract:
    ``local_fun(x_local [n_local], theta_i) -> fx_partial``, this rank's
    additive share of one instance's objective, or a batched
    ``local_fun_and_grad(x_local [B, n_local], theta) -> (fx [B],
    grad_local)`` with the whole objective's collectives inside, made with
    :func:`.parallel.collectives.psum_grad` (which has a backward; theta's
    leaves carry the batch axis).  ``x0`` (and ``lb``/``ub``, scalars or
    global tensors) are the global ones, the same on every rank, and
    ``theta`` is replicated.  The forward pass is the feature-split solve;
    the backward pass is the collective preconditioned CG adjoint: every
    CG dot takes an all-reduce, the preconditioner is the solve's own
    split history (the two-loop's grouped route), and one all-reduce sums
    the ranks' shares of ``d theta``.  The Hessian-vector products of a
    partial objective are local (its Hessian is block-diagonal over the
    ranks, so ``vmap(jvp)`` serves); those of ``local_fun_and_grad`` are
    reverse mode through its collectives.  The result's ``x`` is this
    rank's block; ``x`` and ``fx`` carry derivatives.

    The gradient in ``theta`` is that of one global loss, as the JAX
    package's: every rank calls ``backward`` on a loss ``l_r(x_r) +
    phi(fx)`` of its block ``x_r`` and of the replicated ``fx``, with the
    same ``phi`` on every rank, and gets ``d/dtheta [sum_r l_r(x_r) +
    phi(fx)]``, replicated.  So the blocks' terms add up over the ranks
    and ``fx``'s counts once: ``(res.x ** 2).sum() + res.fx`` on every
    rank is ``||x||^2 + f(x)``.  ``fx``'s cotangent must be the same on
    every rank."""
    from .parallel import sharded as shd

    if (local_fun is None) == (local_fun_and_grad is None):
        raise ValueError("exactly one of 'local_fun' / 'local_fun_and_grad' "
                         "is required")
    boxed = lb is not None or ub is not None
    if boxed and (lb is None or ub is None):
        raise ValueError("boxes need both lb and ub (use +-inf for "
                         "one-sided bounds)")
    if params is None:
        params = LBFGSBParams() if boxed else LBFGSParams()
    if line_search is None:
        line_search = "morethuente" if boxed else "nocedalwright"
    group, x0, single = shd._start(x0, mesh, device)
    if boxed:
        lb, ub = shd._local(lb, group, x0), shd._local(ub, group, x0)
    leaves, spec = pytree.tree_flatten(theta)
    leaves = [torch.as_tensor(leaf).to(x0.device) for leaf in leaves]
    if single:
        leaves = [leaf[None] for leaf in leaves]
    prob = _Problem(local_fun, local_fun_and_grad, spec, params, lb, ub,
                    line_search, precondition, cg_tol, cg_maxiter,
                    active_tol, x0.device, group,
                    batched=local_fun_and_grad is not None)
    x, fx = _ImplicitSolve.apply(prob, x0, *leaves)
    res = prob.result._replace(x=x, fx=fx)
    return lbfgs.unbatch(res) if single else res
