"""Subspace minimization of L-BFGS-B (BOXCQP), batched.

The port's counterpart of ``lbfgspp_tpu.ops.subspace`` (LBFGS++'s
``SubspaceMin``, SubspaceMin.h:122-302): the bound-constrained quadratic
over the free variables, by the primal-dual active-set method of Voglis
and Lagaris.  The L/U/P sets are ``[B, n]`` masks and every sub-solve goes
through the masked operators of :mod:`.bmat`, as in the JAX package.

The active-set loop runs in lockstep: each instance keeps its own
iteration count, convergence flag and factorization status, and the loop
runs until every instance has converged or reached ``maxit``; a finished
instance's state passes through unchanged (what ``vmap`` of the JAX
``lax.while_loop`` computes).  Each lockstep iteration's exit test reads
one flag back from the device; :data:`COUNTS` records the calls, the
lockstep iterations and the iterations the instances took.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from . import bmat
from ..parallel import collectives as coll
from ..types import tree_select

Tensor = torch.Tensor

#: ``calls``: subspace solves; ``instances``: their instances, summed;
#: ``lockstep``: batched active-set iterations; ``syncs``: exit tests read
#: back from the device (none when unrolled); ``instance_iterations``:
#: the iterations the instances took, summed, read by the exit tests
#: (so not counted when unrolled).
COUNTS: collections.Counter = collections.Counter()


class _Carry(NamedTuple):
    y: Tensor          # [B, n] iterate on the free coordinates
    lam: Tensor        # [B, n] lower-bound multipliers
    mu: Tensor         # [B, n] upper-bound multipliers
    k: Tensor          # [B] int32 iterations
    converged: Tensor  # [B] bool
    info: Tensor       # [B] int32, latched factorization status


def _all(mask: Tensor, test: Tensor) -> Tensor:
    """Per instance, ``test`` holds wherever ``mask`` does (on this
    rank's coordinates)."""
    return torch.where(mask, test, True).all(dim=1)


def subspace_minimize(bh: bmat.BHistory, x0: Tensor, xcp: Tensor, g: Tensor,
                      lb: Tensor, ub: Tensor, wd: Tensor,
                      newact_mask: Tensor, free_mask: Tensor, maxit: int,
                      unroll: bool = False, middle_solve=None, group=None):
    """``(drt, info)``: the search direction ``xsm - x0`` of every instance
    (SubspaceMin::subspace_minimize, SubspaceMin.h:122-302;
    lbfgspp_tpu/ops/subspace.py:52-185) and ``info > 0`` where one of its
    ``solve_ptbp`` factorizations met a zero pivot.

    ``unroll=True`` runs exactly ``maxit`` lockstep iterations, the
    finished instances frozen, with no exit test read back: the same
    values.

    ``group``: the vectors and masks are this rank's feature block; every
    set test is a global AND and every product one all-reduce
    (lbfgspp_tpu/ops/subspace.py:52-185), so the loop's exit reads
    replicated flags only."""
    eps = torch.finfo(x0.dtype).eps
    theta = bh.theta[:, None]

    drt0 = xcp - x0
    any_free = coll.pall(~free_mask.any(dim=1), group,
                         "subspace.any_free").logical_not()

    # The linear term c = F'BAb + F'g and the shifted bounds
    # (SubspaceMin.h:146-156).
    vecc = bmat.compute_ftbab(bh, free_mask, newact_mask, wd, drt0, group)
    vecc = torch.where(free_mask, vecc + g, 0.0)
    vecl = torch.where(free_mask, lb - x0, 0.0)
    vecu = torch.where(free_mask, ub - x0, 0.0)

    # The unconstrained solve y = -inv(B[F, F]) c (SubspaceMin.h:157-159)
    # and the feasibility shortcut (SubspaceMin.h:160-166).
    y0, info0 = bmat.solve_ptbp(bh, free_mask, -vecc, middle_solve, group,
                                "subspace.solve_y0")
    feasible = coll.pall(_all(free_mask, (y0 >= vecl) & (y0 <= vecu)),
                         group, "subspace.feasible")

    def body(c: _Carry) -> _Carry:
        # The L/U/P partition with the reference's tie-breaking
        # (SubspaceMin.h:194-219).
        l_set = free_mask & ((c.y < vecl) | ((c.y == vecl) & (c.lam >= 0.0)))
        u_set = free_mask & (~l_set) & \
            ((c.y > vecu) | ((c.y == vecu) & (c.mu >= 0.0)))
        p_set = free_mask & (~l_set) & (~u_set)
        y = torch.where(l_set, vecl, torch.where(u_set, vecu, c.y))
        lam = torch.where(u_set | p_set, 0.0, c.lam)
        mu = torch.where(l_set | p_set, 0.0, c.mu)

        # y[P] = -inv(B[P,P]) (B[P,L] l + B[P,U] u + c[P])
        # (SubspaceMin.h:226-245)
        rhs = torch.where(p_set, vecc, 0.0)
        rhs = rhs + bmat.apply_ptbqv(bh, p_set, l_set, vecl, group,
                                     "subspace.bpl")
        rhs = rhs + bmat.apply_ptbqv(bh, p_set, u_set, vecu, group,
                                     "subspace.bpu")
        yp, info_p = bmat.solve_ptbp(bh, p_set, -rhs, middle_solve, group,
                                     "subspace.solve_yp")
        y = torch.where(p_set, yp, y)

        # lambda[L] = B[L,F] y + c[L]; mu[U] = -B[U,F] y - c[U]
        # (SubspaceMin.h:247-268), B[Q,F] y = theta y[Q] - (Q'W M W'F) y
        fy = bmat.apply_wtpv(bh, free_mask, y, group, "subspace.fy")
        wm_l = bmat.apply_ptwmv(bh, l_set, fy, -1.0)
        lam = torch.where(l_set, wm_l + vecc + theta * y, lam)
        wm_u = bmat.apply_ptwmv(bh, u_set, fy, -1.0)
        mu = torch.where(u_set, -(wm_u + vecc + theta * y), mu)

        # Convergence of the three sets (SubspaceMin.h:271-272)
        conv = coll.pall(_all(l_set, lam >= 0.0) & _all(u_set, mu >= 0.0) &
                         _all(p_set, (y >= vecl) & (y <= vecu)),
                         group, "subspace.converged")
        return _Carry(y=y, lam=lam, mu=mu, k=c.k + 1, converged=conv,
                      info=torch.maximum(c.info, info_p))

    run_loop = any_free & (~feasible)
    out = _Carry(y=y0, lam=torch.zeros_like(y0), mu=torch.zeros_like(y0),
                 k=torch.zeros_like(info0), converged=~run_loop, info=info0)
    COUNTS["calls"] += 1
    COUNTS["instances"] += x0.shape[0]
    for _ in range(maxit):
        going = (~out.converged) & (out.k < maxit)
        if not unroll:
            # the exit test: one read, which also counts the instances
            # that take this iteration
            COUNTS["syncs"] += 1
            taking = int(going.sum())
            if not taking:
                break
            COUNTS["instance_iterations"] += taking
        out = tree_select(going, body(out), out)
        COUNTS["lockstep"] += 1

    # The 3-level fallback where the iterations did not converge
    # (SubspaceMin.h:276-296).
    failed = run_loop & (~out.converged)
    y_proj = torch.minimum(torch.maximum(out.y, vecl), vecu)
    drt_a = torch.where(free_mask, y_proj, drt0)
    fb_proj = torch.minimum(torch.maximum(y0, vecl), vecu)
    drt_b = torch.where(free_mask, fb_proj, drt0)
    dg_a, dg_b = coll.pfused([(drt_a * g).sum(dim=1), (drt_b * g).sum(dim=1)],
                             group, "subspace.fallback")
    drt_c = torch.where(free_mask, y0, drt0)
    drt_failed = torch.where((dg_a <= -eps)[:, None], drt_a,
                             torch.where((dg_b <= -eps)[:, None], drt_b,
                                         drt_c))
    drt_ok = torch.where(free_mask, out.y, drt0)
    drt = torch.where(failed[:, None], drt_failed, drt_ok)
    return torch.where(any_free[:, None], drt, drt0), out.info
