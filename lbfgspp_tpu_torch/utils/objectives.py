"""Benchmark objectives mirroring the reference example suite.

The port's counterpart of ``lbfgspp_tpu.utils.objectives``.  Each objective
is written for ONE instance, ``x [n]``; the solvers map it over the batch
with ``torch.func.vmap`` (see :func:`..types.make_fun_and_grad`).  The
``*_fg`` forms use the reference examples' hand-written gradients.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def rosenbrock(x: Tensor) -> Tensor:
    """Pairwise Rosenbrock (examples/example-rosenbrock.cpp:14-29): for even
    i, ``f += (1 - x_i)^2 + (10 (x_{i+1} - x_i^2))^2``."""
    p = x.reshape(-1, 2)
    xe = p[:, 0]
    xo = p[:, 1]
    t1 = 1.0 - xe
    t2 = 10.0 * (xo - xe * xe)
    return torch.sum(t1 * t1 + t2 * t2)


def rosenbrock_split(x: Tensor) -> Tensor:
    """Pairwise Rosenbrock with the split pair layout: pair i is
    ``(x_i, x_{i + n/2})``, the same problem as :func:`rosenbrock` under a
    fixed index permutation."""
    p = x.reshape(2, -1)
    xe = p[0]
    xo = p[1]
    t1 = 1.0 - xe
    t2 = 10.0 * (xo - xe * xe)
    return torch.sum(t1 * t1 + t2 * t2)


def rosenbrock_fg(x: Tensor):
    """Value and hand-written gradient (example-rosenbrock.cpp:18-27)."""
    p = x.reshape(-1, 2)
    xe = p[:, 0]
    xo = p[:, 1]
    t1 = 1.0 - xe
    t2 = 10.0 * (xo - xe * xe)
    fx = torch.sum(t1 * t1 + t2 * t2)
    go = 20.0 * t2
    ge = -2.0 * (xe * go + t1)
    grad = torch.stack([ge, go], dim=1).reshape(x.shape)
    return fx, grad


def quadratic(x: Tensor) -> Tensor:
    """``f(x) = ||x - d||^2`` with ``d = (0, 1, ..., n-1)``
    (examples/example-quadratic.cpp:9-18)."""
    d = torch.arange(x.shape[0], dtype=x.dtype, device=x.device)
    r = x - d
    return torch.sum(r * r)


def quadratic_fg(x: Tensor):
    d = torch.arange(x.shape[0], dtype=x.dtype, device=x.device)
    r = x - d
    return torch.sum(r * r), 2.0 * r


def rosenbrock_chained(x: Tensor) -> Tensor:
    """roptim-style chained Rosenbrock used by the box example
    (examples/example-rosenbrock-box.cpp:12-35):
    ``f = (x_0 - 1)^2 + sum_i 4 (x_i - x_{i-1}^2)^2``."""
    head = (x[0] - 1.0) ** 2
    tail = 4.0 * (x[1:] - x[:-1] * x[:-1]) ** 2
    return head + torch.sum(tail)


def rosenbrock_chained_fg(x: Tensor):
    """Value and the reference's hand-written gradient
    (example-rosenbrock-box.cpp:20-33), assembled without in-place writes so
    that it maps over a batch."""
    fx = rosenbrock_chained(x)
    g0 = 2.0 * (x[0] - 1.0) + 16.0 * (x[0] * x[0] - x[1]) * x[0]
    mid = 8.0 * (x[1:] - x[:-1] * x[:-1])                 # slots 1..n-1
    inner = 16.0 * (x[1:-1] * x[1:-1] - x[2:]) * x[1:-1]  # slots 1..n-2
    tail = mid + torch.cat([inner, torch.zeros_like(x[:1])])
    return fx, torch.cat([g0.reshape(1), tail])


def make_sharded_logreg(a_local: Tensor, b: Tensor, group=None):
    """Feature-split logistic regression for
    :func:`..parallel.sharded.minimize_sharded`
    (lbfgspp_tpu/utils/objectives.py:95-118).

    ``a_local`` is this rank's ``[rows, n_local]`` block of the design
    matrix (features split), ``b`` the replicated +/-1 labels.  The logit
    is a dot over all features, so each rank contributes a partial product
    and ONE all-reduce of the ``[B, rows]`` logits makes them global; the
    loss is then replicated and the local gradient is ``A_local' d``.  The
    oracle is batched, ``w_local [B, n_local] -> (fx [B], grad_local)``,
    as every oracle with its own collectives is; its all-reduce has a
    backward (:func:`..parallel.collectives.psum_grad`), so the implicit
    adjoint can differentiate the gradient it returns."""
    from ..parallel import collectives as coll

    def fg(w_local: Tensor):
        logits = coll.psum_grad(w_local @ a_local.T, group,
                                "logreg.logits")
        z = -b * logits
        fx = torch.logaddexp(torch.zeros_like(z), z).sum(dim=-1)
        dlogit = -b * torch.sigmoid(z)
        return fx, dlogit @ a_local

    return fg
