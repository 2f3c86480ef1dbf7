"""Cross-shard reductions on ``torch.distributed``, batched.

The port's counterpart of ``lbfgspp_tpu.parallel.collectives``.  When the
parameter vector is split over the ranks of a process group on its
feature axis, every inner product and norm of the solver (Eigen
``a.dot(b)``, LBFGS.h:123; ``m_grad.norm()``, LBFGS.h:92) becomes a local
reduction plus one all-reduce.  All solver code sends its reductions
through these helpers: ``group=None`` gives the single-process semantics
with no ``torch.distributed`` call at all, and a group turns each into one
all-reduce over it, even on a group of one rank, so that a card runs the
real path.

Every helper keeps the port's leading batch axis: a local ``[B, n_local]``
operand reduces to a ``[B]`` or ``[B, k]`` tensor in ONE call.  Every call
goes through :func:`_all_reduce`, which counts it by site in
:data:`COUNTS` (the collective audit and ``chip_smoke.py`` read them).

The JAX module's ``pvary`` marks shard-invariant values as varying for
``shard_map``'s type system; it is a typing artefact with no torch
counterpart, so there is none here.

Collectives are not differentiable (the reduced tensor is a new tensor
outside autograd) but :func:`psum_grad`, whose backward sums the
cotangents over the ranks.  gloo runs every reduction of this module on
CUDA tensors too (it stages them through host memory).
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import torch
import torch.distributed as dist

Tensor = torch.Tensor

#: All-reduce calls by site since the last ``clear()``.
COUNTS: collections.Counter = collections.Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def resolve_group(mesh):
    """The process group of ``mesh``: a 1-D ``DeviceMesh``, a
    ``ProcessGroup``, or None for the default group (which must be
    initialized)."""
    if mesh is None:
        if not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "torch.distributed.init_process_group or "
                               "pass mesh=")
        return dist.group.WORLD
    if hasattr(mesh, "get_group"):
        if mesh.ndim != 1:
            raise ValueError(f"mesh must be 1-D, got {mesh.ndim} dims")
        return mesh.get_group()
    return mesh


def _all_reduce(t: Tensor, op: str, group, site: str) -> Tensor:
    """``t`` reduced over ``group`` with ``op`` (``"sum"``, ``"max"`` or
    ``"min"``), counted at ``site``; ``t`` itself when ``group`` is None.
    The caller's tensor is not modified."""
    if group is None:
        return t
    COUNTS[site] += 1
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def psum(x: Tensor, group=None, site: str = "psum") -> Tensor:
    """Global sum of local partials ``x`` (any shape)."""
    return _all_reduce(x, "sum", group, site)


psum_scalar = psum


class _SumAcrossRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, site):
        ctx.group, ctx.site = group, site
        return _all_reduce(x, "sum", group, site)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, "sum", ctx.group,
                           ctx.site + ".backward"), None, None


def psum_grad(x: Tensor, group=None, site: str = "psum") -> Tensor:
    """:func:`psum` with a backward: the cotangent of every rank's partial
    is the sum of the ranks' cotangents of the total, the adjoint when
    the ranks' results add up to one objective (each rank's share of a
    replicated value counting ``1/world``).  An objective with
    collectives inside uses it so that the implicit adjoint can
    differentiate its gradient (:func:`..diff.implicit_minimize_sharded`)."""
    if group is None:
        return x
    return _SumAcrossRanks.apply(x, group, site)


def pdot(a: Tensor, b: Tensor, group=None, site: str = "pdot") -> Tensor:
    """Global inner products ``a.b`` of ``[B, n_local]`` rows, ``[B]``."""
    return psum(torch.linalg.vecdot(a, b), group, site)


def psqnorm(a: Tensor, group=None, site: str = "psqnorm") -> Tensor:
    """Global squared Euclidean norms, ``[B]``."""
    return pdot(a, a, group, site)


def pnorm(a: Tensor, group=None, site: str = "pnorm") -> Tensor:
    """Global Euclidean norms, ``[B]``."""
    return torch.sqrt(psqnorm(a, group, site))


def pmax(x: Tensor, group=None, site: str = "pmax") -> Tensor:
    """Global max of local values."""
    return _all_reduce(x, "max", group, site)


def pmin(x: Tensor, group=None, site: str = "pmin") -> Tensor:
    """Global min of local values."""
    return _all_reduce(x, "min", group, site)


def pall(x: Tensor, group=None, site: str = "pall") -> Tensor:
    """Global logical AND of local booleans (the masked set tests of
    BOXCQP, SubspaceMin.h:72-108, when the masks are feature-split)."""
    if group is None:
        return x
    return pmin(x.to(torch.int32), group, site) == 1


def pmax_abs(a: Tensor, group=None, site: str = "pmax_abs") -> Tensor:
    """Global infinity norms of ``[B, n_local]`` rows (Eigen
    ``.cwiseAbs().maxCoeff()``, LBFGSB.h:62-65), ``[B]``."""
    return pmax(a.abs().amax(dim=-1), group, site)


def pdot2(a1: Tensor, b1: Tensor, a2: Tensor, b2: Tensor, group=None,
          site: str = "pdot2"):
    """Two inner products of ``[B, n_local]`` rows in one all-reduce."""
    d = torch.stack([torch.linalg.vecdot(a1, b1),
                     torch.linalg.vecdot(a2, b2)], dim=1)
    d = psum(d, group, site)
    return d[:, 0], d[:, 1]


def pmatvec(mat: Tensor, v: Tensor, group=None,
            site: str = "pmatvec") -> Tensor:
    """Global ``mat @ v`` for ``mat [B, k, n_local]``, ``v [B, n_local]``:
    the k inner products in one all-reduce (the S'v / Y'v families,
    BFGSMat.h:315-320), ``[B, k]``."""
    local = torch.matmul(mat, v[:, :, None])[:, :, 0]
    return psum(local, group, site)


def pgram(mat: Tensor, group=None, site: str = "pgram") -> Tensor:
    """Global Gram matrices ``mat @ mat^T`` of ``[B, k, n_local]`` rows in
    one all-reduce (the masked ``WP'WP`` blocks of ``solve_PtBP``,
    BFGSMat.h:541-556), ``[B, k, k]``."""
    return psum(mat @ mat.transpose(1, 2), group, site)


def pfused(parts, group=None, site: str = "pfused"):
    """Global sums of several ``[B, ...]`` partials in one all-reduce:
    the parts ride one flattened ``[B, K]`` buffer and come back in their
    shapes, as XLA's all-reduce combiner merges independent ``psum``s."""
    if group is None:
        return list(parts)
    batch = parts[0].shape[0]
    flat = torch.cat([p.reshape(batch, -1) for p in parts], dim=1)
    red = psum(flat, group, site)
    out, at = [], 0
    for p in parts:
        k = p[0].numel()
        out.append(red[:, at:at + k].reshape(p.shape))
        at += k
    return out


class ShardedObjective:
    """A feature-split objective ``x_local [B, n_local] -> (fx [B],
    grad_local)`` whose value is a sum of per-rank partials.

    ``partial(x_local)`` returns this rank's partial value and the local
    gradient; calling the object adds the all-reduce of the value.
    :func:`evaluate` uses ``partial`` to fold other local sums into that
    all-reduce, as XLA merges a trial's objective ``psum`` with its
    directional derivative."""

    def __init__(self, partial: Callable, group):
        self.partial = partial
        self.group = group

    def __call__(self, x: Tensor):
        fx, grad = self.partial(x)
        return psum(fx, self.group, "objective"), grad


def evaluate(fg, x: Tensor, extra: Optional[Callable] = None, group=None,
             site: str = "objective"):
    """``(fx, grad, extra_sum)``: the objective at ``x`` and the global
    sums of ``extra(grad)`` (a ``[B, k]`` tensor of local partials, or
    None).  Under a group, a :class:`ShardedObjective` takes one
    all-reduce for both; any other oracle makes its own reductions and
    the extra sums take one more."""
    part = getattr(fg, "partial", None) if group is not None else None
    if part is not None:
        fx, grad = part(x)
        if extra is None:
            return psum(fx, group, site), grad, None
        red = psum(torch.cat([fx[:, None], extra(grad)], dim=1), group,
                   site)
        return red[:, 0], grad, red[:, 1:]
    fx, grad = fg(x)
    if extra is None:
        return fx, grad, None
    return fx, grad, psum(extra(grad), group, site + ".extra")


def block(total: int, group=None) -> tuple:
    """``(lo, hi)``: the contiguous block of ``total`` items this rank
    holds, the first ``total % world`` ranks one more (the whole range
    without a group)."""
    if group is None:
        return 0, total
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    base, extra = divmod(total, world)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (1 if rank < extra else 0)


def gather_rows(t: Tensor, total: int, group=None,
                site: str = "gather") -> Tensor:
    """The ``[total, ...]`` tensor whose rows ``block(total)`` are this
    rank's ``t``, assembled from every rank's block by one all-reduce of a
    zero-filled buffer (the JAX package's invariant gather,
    lbfgspp_tpu/ops/cauchy.py:572-582; gloo reduces CUDA tensors but
    does not gather them).  Booleans travel as int32."""
    if group is None:
        return t
    lo, hi = block(total, group)
    dtype = t.dtype
    wire = torch.int32 if dtype == torch.bool else dtype
    buf = torch.zeros((total,) + tuple(t.shape[1:]), dtype=wire,
                      device=t.device)
    buf[lo:hi] = t.to(wire)
    out = psum(buf, group, site)
    return out.to(dtype) if wire != dtype else out
