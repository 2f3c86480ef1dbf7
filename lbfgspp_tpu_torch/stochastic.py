"""Multi-batch (stochastic) L-BFGS with overlap-consistent curvature.

The port's counterpart of ``lbfgspp_tpu.stochastic`` (Berahas, Nocedal &
Takac, arXiv:1605.06049).  Consecutive minibatches share an overlap
``O_k``, and the curvature pair is taken on it,

    s_k = x_{k+1} - x_k,   y_k = grad f_{O_k}(x_{k+1}) - grad f_{O_k}(x_k),

so every stored pair measures the curvature of one fixed sub-objective.
The schedule is a window of ``batch_size`` rows sliding over a (shuffled
once, or given) order of the samples by ``batch_size - overlap`` rows per
step, wrapping around.  The history, the curvature gate and the two-loop
direction are the deterministic solver's: a run is one solve, a batch of
one in the port's history, and its direction launches the two-loop kernel
once per step on the card.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from .linesearch import get_line_search
from .ops import history as hist_ops
from .params import LBFGSParams
from .pytree import ravel_pytree
from .types import Status, resolve_device

Tensor = torch.Tensor


class StochasticResult(NamedTuple):
    """The fields of :class:`~.types.SolveResult` for one solve, and
    ``nskip``: the steps whose search failed (or, with a fixed step, whose
    loss was not finite), which kept ``x`` and the history."""

    x: Any
    fx: Tensor
    grad: Any
    gnorm: Tensor
    niter: Tensor
    nfev: Tensor
    status: Tensor
    history: Any
    nskip: Tensor


def _num_rows(data) -> int:
    leaves = pytree.tree_leaves(data)
    if not leaves:
        raise ValueError("'data' must contain at least one tensor")
    n = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != n:
            raise ValueError("all 'data' leaves must share the leading "
                             f"(sample) axis; got {leaf.shape[0]} vs {n}")
    return n


def minimize_stochastic(fun: Callable,
                        x0: Any,
                        data: Any,
                        params: LBFGSParams = LBFGSParams(),
                        *,
                        batch_size: int,
                        overlap_frac: float = 0.25,
                        step_size: Optional[float] = None,
                        line_search="backtracking",
                        generator: Optional[torch.Generator] = None,
                        history_dtype=None,
                        device=None) -> StochasticResult:
    """Run ``params.max_iterations`` multi-batch L-BFGS steps
    (lbfgspp_tpu/stochastic.py:61-202).

    ``fun(x, batch) -> scalar`` is the loss of the parameters ``x`` (a
    flat tensor or any tree of tensors) on a batch: ``data`` (a tensor or
    tree of tensors with a common leading sample axis) sliced along that
    axis.  ``batch_size`` rows per step, ``overlap_frac`` of them shared
    with the next batch.  ``step_size=None`` runs ``line_search`` on the
    current batch's objective (the first step from ``1 / ||d||``), else
    every step is ``x + step_size d``, kept only if the new loss is
    finite.  ``generator``: a ``torch.Generator`` that shuffles the sample
    order once (on its own device); None keeps the given order.  The
    same order is cycled.  ``history_dtype``: the (s, y) rows' storage
    dtype (reduced precision, as :func:`.lbfgs.solver` takes it).

    Returns a :class:`StochasticResult` of one solve (no batch axis):
    ``x``/``grad`` in ``x0``'s structure, ``fx``/``grad``/``gnorm`` of
    the last minibatch, ``status`` ``MAX_ITERATIONS`` (a fixed schedule),
    ``nfev`` the evaluations made.  A step whose search fails keeps ``x``
    and the history, and counts in ``nskip``.
    """
    if params.max_iterations <= 0:
        raise ValueError("stochastic mode needs params.max_iterations > 0 "
                         "(a fixed step schedule)")
    n_rows = _num_rows(data)
    if not 1 <= batch_size <= n_rows:
        raise ValueError(f"batch_size must be in [1, {n_rows}]")
    o = int(round(overlap_frac * batch_size))
    if not 1 <= o <= batch_size:
        raise ValueError("overlap_frac must give an overlap in "
                         "[1, batch_size] rows")
    shift = batch_size - o
    device = resolve_device(device)

    flat0, unravel = ravel_pytree(x0)
    x = flat0.to(device)[None].contiguous()
    dtype = x.dtype
    data = pytree.tree_map(lambda a: torch.as_tensor(a, device=device), data)

    def fun_flat(z, batch):
        return fun(unravel(z), batch)

    grad_value = torch.func.grad_and_value(fun_flat)

    def oracle(batch):
        """The batched (B = 1) value and gradient on ``batch``."""
        def fg(xb):
            g, f = grad_value(xb[0], batch)
            return f[None], g[None]
        return fg

    if generator is None:
        perm = torch.arange(n_rows, device=device)
    else:
        perm = torch.randperm(n_rows, generator=generator,
                              device=generator.device).to(device)
    # Tiled once, so a window starting anywhere in [0, N) is one slice.
    perm2 = torch.cat([perm, perm])

    def take(idx):
        return pytree.tree_map(lambda a: a.index_select(0, idx), data)

    search = get_line_search(line_search)
    hist = hist_ops.init_history(1, x.shape[1], params.m, dtype,
                                 store_dtype=history_dtype, device=device)
    nfev = torch.zeros(1, dtype=torch.int32, device=device)
    nskip = torch.zeros(1, dtype=torch.int32, device=device)
    fx1 = torch.zeros(1, dtype=dtype, device=device)
    g1 = torch.zeros_like(x)
    for k in range(params.max_iterations):
        start = (k * shift) % n_rows
        idx = perm2[start:start + batch_size]
        fg = oracle(take(idx))
        fx, g = fg(x)
        d = hist_ops.apply_hv(hist, g, -1.0)
        dg = torch.linalg.vecdot(g, d)
        if step_size is None:
            step0 = 1.0 / torch.linalg.vector_norm(d, dim=-1) if k == 0 \
                else torch.ones_like(fx)
            ls = search(fg, params, x, d, params.max_step, step0, fx, g, dg)
            ok = ls.status == Status.RUNNING
            x1 = torch.where(ok[:, None], ls.x, x)
            fx1 = torch.where(ok, ls.fx, fx)
            g1 = torch.where(ok[:, None], ls.grad, g)
            nfev = nfev + 1 + ls.nfev
        else:
            x1 = x + step_size * d
            fx1, g1 = fg(x1)
            ok = torch.isfinite(fx1)
            x1 = torch.where(ok[:, None], x1, x)
            nfev = nfev + 2
        # The overlap-consistent curvature pair (arXiv:1605.06049 eq.
        # 2.5): both gradients on O_k, the tail of this window.
        ofg = oracle(take(idx[batch_size - o:]))
        y = ofg(x1)[1] - ofg(x)[1]
        hist, _ = hist_ops.update_history(hist, x1 - x, y, ok)
        x = x1
        nfev = nfev + 2
        nskip = nskip + (~ok).to(torch.int32)

    return StochasticResult(
        x=unravel(x[0]), fx=fx1[0], grad=unravel(g1[0]),
        gnorm=torch.linalg.vector_norm(g1[0]),
        niter=torch.tensor(params.max_iterations, dtype=torch.int32,
                           device=device),
        nfev=nfev[0],
        status=torch.tensor(int(Status.MAX_ITERATIONS), dtype=torch.int32,
                            device=device),
        history=hist_ops.LBFGSHistory(*(None if t is None else t[0]
                                        for t in hist)),
        nskip=nskip[0])
