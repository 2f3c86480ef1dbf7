"""Feature-split solves over a ``torch.distributed`` process group.

The port's counterpart of ``lbfgspp_tpu.parallel.sharded``.  The solver's
only cross-rank dependencies are reductions (dots, norms, the step cap's
min) and the replicated ``[m]``/``[2m]`` state (SURVEY.md §5), so:

* ``x``, ``g``, ``drt`` and the history rows ``s``/``y`` are split on the
  feature axis over the ranks of a 1-D group, each rank holding one
  contiguous block (:func:`shard`);
* every reduction of the solver goes through
  :mod:`.collectives` and becomes one all-reduce over the group;
* all scalar and ``[m]``-sized state is replicated.

Every rank runs the same entry point with the same global ``x0`` (and
bounds); each solves its block in lockstep with the others, its loops
steered by replicated flags only.  The result keeps ``x``, ``grad`` and
the history rows local (this rank's block) and everything else
replicated, as the JAX package's ``_result_specs`` does
(lbfgspp_tpu/parallel/sharded.py:70-84).

The objective is written locally.  ``local_fun(x_local)`` is ONE
instance's *partial* objective on this rank's block (mapped over the
batch like any objective of the port); the port adds the all-reduce of
the partial values, and the local gradient of the global objective is
the gradient of the partial.  A non-separable objective passes
``local_fun_and_grad(x_local [B, n_local]) -> (fx [B], grad_local)``,
batched and with its own collectives (a ``vmap`` cannot map a
collective), as :func:`..utils.objectives.make_sharded_logreg` does.

``mesh`` is a 1-D ``torch.distributed.DeviceMesh``, a ``ProcessGroup``,
or None for the default group.  n must divide by the group's size.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .. import lbfgs, lbfgsb, owlqn
from ..params import LBFGSBParams, LBFGSParams
from ..types import SolveResult, make_fun_and_grad, resolve_device
from . import collectives as coll

Tensor = torch.Tensor


def shard(t, mesh=None) -> Tensor:
    """This rank's contiguous block of a global ``[n]`` or ``[B, n]``
    tensor on its last (feature) axis (a view), the counterpart of
    ``sharding_for``; n must divide by the group's size."""
    group = coll.resolve_group(mesh)
    t = torch.as_tensor(t)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n = t.shape[-1]
    if n % world:
        raise ValueError(f"n = {n} does not divide by the group's "
                         f"{world} ranks")
    k = n // world
    return t.narrow(-1, rank * k, k)


def make_sharded_fg(local_fun: Optional[Callable] = None,
                    local_fun_and_grad: Optional[Callable] = None,
                    mesh=None):
    """The solver-facing batched oracle ``x_local [B, n_local] -> (fx
    [B], grad_local)`` (lbfgspp_tpu/parallel/sharded.py:87-112).

    ``local_fun(x_local [n_local]) -> fx_partial`` is this rank's additive
    share of ONE instance's objective: the oracle takes the local value
    and gradient by autograd over the batch and one all-reduce of the
    partial values (a :class:`.collectives.ShardedObjective`, whose
    all-reduce the line searches share with their directional
    derivatives).  ``local_fun_and_grad`` is returned as it is."""
    if local_fun_and_grad is not None:
        return local_fun_and_grad
    if local_fun is None:
        raise ValueError("pass 'local_fun' or 'local_fun_and_grad'")
    return coll.ShardedObjective(make_fun_and_grad(local_fun),
                                 coll.resolve_group(mesh))


def _start(x0, mesh, device):
    """``(group, x0_local [B, n_local], single)`` on the device."""
    if x0 is None:
        raise ValueError("x0 is required")
    group = coll.resolve_group(mesh)
    single = torch.as_tensor(x0).dim() == 1
    x0 = lbfgs.as_batch(x0, resolve_device(device))
    return group, shard(x0, group).contiguous(), single


def _local(v, group, like: Tensor):
    """A scalar stays; an ``[n]`` / ``[B, n]`` global tensor becomes this
    rank's block on ``like``'s device and dtype."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v if v.dim() == 0 else shard(v, group).contiguous()


def minimize_sharded(local_fun: Optional[Callable] = None,
                     x0=None,
                     params: LBFGSParams = LBFGSParams(),
                     *,
                     mesh=None,
                     local_fun_and_grad: Optional[Callable] = None,
                     line_search: str = "nocedalwright",
                     direction: str = "sweeps",
                     history_dtype=None,
                     on_ls_fail: str = "stop",
                     device=None) -> SolveResult:
    """L-BFGS with ``x`` split over the ranks of ``mesh``
    (lbfgspp_tpu/parallel/sharded.py:115-163).

    ``x0`` is the global ``[n]`` (the result has no batch axis) or
    ``[B, n]``, the same on every rank.  The all-reduces per iteration:
    ``g.d``, the line search's (one per trial, the objective's value and
    the directional derivative together), the history's fused products
    with the convergence norms, and the two-loop's ``[B, 2m]``; the
    two-loop takes the plain route (the kernel fuses the dots that the
    all-reduce must split).  ``direction="rinv"`` changes none of them;
    ``history_dtype`` stores the local rows narrower."""
    group, x0, single = _start(x0, mesh, device)
    fg = make_sharded_fg(local_fun, local_fun_and_grad, group)
    s = lbfgs._build_solver(fg, params, line_search=line_search,
                            direction=direction, on_ls_fail=on_ls_fail,
                            history_dtype=history_dtype, group=group,
                            device=x0.device)
    res = s.finalize(s.run(s.init(x0)))
    return lbfgs.unbatch(res) if single else res


def minimize_b_sharded(local_fun: Optional[Callable] = None,
                       x0=None,
                       lb=None,
                       ub=None,
                       params: Optional[LBFGSBParams] = None,
                       *,
                       mesh=None,
                       local_fun_and_grad: Optional[Callable] = None,
                       line_search: str = "morethuente",
                       gcp: str = "auto",
                       middle_solve=None,
                       device=None) -> SolveResult:
    """L-BFGS-B with ``x`` and its bounds split over the ranks of
    ``mesh`` (lbfgspp_tpu/parallel/sharded.py:180-234).

    ``lb``/``ub`` are scalars or global ``[n]`` / ``[B, n]`` tensors.  The
    reference's sorted Cauchy point cannot run on a block, so the GCP is
    the sortless walk: ``gcp="auto"`` routes each instance between the
    plain walk and the chunked walk by its estimated crossing count
    (:func:`..ops.cauchy.cauchy_point_walk_auto`); ``"walk"`` and
    ``"walk_chunked"`` pin one, and any other name takes ``"walk"``.
    BOXCQP's set tests are global ANDs."""
    if params is None:
        params = LBFGSBParams()
    group, x0, single = _start(x0, mesh, device)
    fg = make_sharded_fg(local_fun, local_fun_and_grad, group)
    s = lbfgsb._build_solver(fg, _local(lb, group, x0),
                             _local(ub, group, x0), params,
                             line_search=line_search, gcp=gcp,
                             middle_solve=middle_solve, group=group,
                             device=x0.device)
    res = s.finalize(s.run(s.init(x0)))
    return lbfgs.unbatch(res) if single else res


def minimize_owlqn_sharded(local_fun: Optional[Callable] = None,
                           x0=None,
                           l1=None,
                           params: LBFGSParams = LBFGSParams(),
                           *,
                           mesh=None,
                           local_fun_and_grad: Optional[Callable] = None,
                           history_dtype=None,
                           device=None) -> SolveResult:
    """OWL-QN with ``x`` split over the ranks of ``mesh``
    (lbfgspp_tpu/parallel/sharded.py:237-268).  ``local_fun`` is the
    smooth part's partial; ``l1`` a scalar or a global ``[n]`` / ``[B,
    n]`` weight.  The orthant machinery is elementwise, so the L1 term's
    sum rides the objective's all-reduce and the rest are the
    unconstrained solver's sites."""
    group, x0, single = _start(x0, mesh, device)
    fg = make_sharded_fg(local_fun, local_fun_and_grad, group)
    lam = _local(0.0 if l1 is None else l1, group, x0).expand(x0.shape)
    res = owlqn._solve(fg, x0, lam, params, history_dtype, group)
    return lbfgs.unbatch(res) if single else res
