"""Full double-float (df64) solves.

The port's counterpart of ``lbfgspp_tpu.df64``: :func:`minimize_df64`
runs the whole solve in pair space, the solver on ``2n`` ordinary
coordinates ``[hi; lo]`` per instance while the objective and gradient are
evaluated at the exact sum ``hi + lo`` in pair arithmetic
(:mod:`.utils.doublefloat`).  Unconstrained only.

Convergence is tested on the pair-space gradient, whose norm is
``sqrt(2) * ||g||`` (the gradient is duplicated on both halves), so
``epsilon`` and ``epsilon_rel`` are multiplied by ``sqrt(2)``, keeping the
reference's test ``||g|| <= max(eps, eps_rel ||x||)`` (LBFGS.h:137) on the
underlying gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from . import lbfgs
from .ops import history as hist_ops
from .params import LBFGSParams
from .types import SolveResult, resolve_device
from .utils import doublefloat as dfl


def minimize_df64(fun: Optional[Callable] = None,
                  x0=None,
                  params: LBFGSParams = LBFGSParams(),
                  *,
                  fun_and_grad=None,
                  line_search: str = "morethuente",
                  device=None) -> SolveResult:
    """Minimize ``fun`` from ``x0`` ([n], or [B, n] for a batch) with every
    iterate in pair space (lbfgspp_tpu/df64.py:47-82).  The result is in
    the original space, with an empty [m, n] history (the curvature lives
    in pair space)."""
    if x0 is None:
        raise ValueError("x0 is required")
    device = resolve_device(device)
    single = torch.as_tensor(x0).dim() == 1
    x0 = lbfgs.as_batch(x0, device)
    batch, n = x0.shape
    fg2 = dfl.df64_pair_fun_and_grad(fun, fun_and_grad=fun_and_grad)
    pparams = dataclasses.replace(
        params, epsilon=params.epsilon * math.sqrt(2.0),
        epsilon_rel=params.epsilon_rel * math.sqrt(2.0))
    s = lbfgs._build_solver(fg2, pparams, line_search=line_search,
                            device=device)
    res2 = s.finalize(s.run(s.init(torch.cat([x0, torch.zeros_like(x0)],
                                             dim=1))))
    grad = res2.grad[:, :n].contiguous()
    res = SolveResult(
        x=dfl.pair_to_float(res2.x), fx=res2.fx, grad=grad,
        gnorm=torch.linalg.vector_norm(grad, dim=-1), niter=res2.niter,
        nfev=res2.nfev, status=res2.status,
        history=hist_ops.init_history(batch, n, params.m, x0.dtype,
                                      device=device))
    return lbfgs.unbatch(res) if single else res
