"""Per-iteration observability.

The port's counterpart of ``lbfgspp_tpu.utils.trace``: the reference's
commented-out iteration prints (LBFGS.h:96-97, :118, :132-134;
LBFGSB.h:142-143, :156-160, :208-210) as data.

* :func:`run_traced` drives any ``init/step/finalize`` solver for a fixed
  number of steps and returns every iteration's metrics as tensors;
* :func:`debug_print_state` prints the same quantities of one state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..types import tree_map

Tensor = torch.Tensor


class TraceRecord(NamedTuple):
    """Per-iteration history of a traced run, ``[T, B]`` (``[T]`` for a
    1-D ``x0``).

    ``valid[t]`` marks the entries of instances still running when step
    t began; later entries repeat the final state.  ``gnorm`` is the
    Euclidean gradient norm for L-BFGS and the projected-gradient infinity
    norm for L-BFGS-B, as in the results."""

    k: Tensor
    fx: Tensor
    gnorm: Tensor
    nfev: Tensor
    status: Tensor
    valid: Tensor


def _gnorm(state) -> Tensor:
    return state.projgnorm if hasattr(state, "projgnorm") else state.gnorm


def run_traced(solver, x0, num_iterations: int):
    """Run ``solver`` (an init/step/finalize triple) for ``num_iterations``
    steps, recording the metrics after each (lbfgspp_tpu/utils/trace.py:
    44-69).  Finished instances pass through frozen.  Returns
    ``(SolveResult, TraceRecord)``; a 1-D ``x0`` gives both without the
    batch axis."""
    single = torch.as_tensor(x0).dim() == 1
    state = solver.init(x0)
    rows = []
    for _ in range(num_iterations):
        was_done = state.done
        state = solver.step(state)
        rows.append((state.k, state.fx, _gnorm(state), state.nfev,
                     state.status, ~was_done))
    if rows:
        fields = [torch.stack(col) for col in zip(*rows)]
    else:
        fields = [torch.empty((0,) + t.shape, dtype=t.dtype,
                              device=t.device)
                  for t in (state.k, state.fx, _gnorm(state), state.nfev,
                            state.status, state.done)]
    trace = TraceRecord(*fields)
    res = solver.finalize(state)
    if single:
        res = tree_map(lambda t: t[0], res)
        trace = TraceRecord(*(t[:, 0] for t in trace))
    return res, trace


def debug_print_state(state, prefix: str = "") -> None:
    """Print one solver state's iteration, objective, gradient norm,
    evaluations and status, one line per instance
    (lbfgspp_tpu/utils/trace.py:72-79)."""
    for k, fx, g, n, s in zip(*(torch.atleast_1d(t).tolist() for t in (
            state.k, state.fx, _gnorm(state), state.nfev, state.status))):
        print(f"{prefix}iter {k}: fx = {fx}, ||grad|| = {g}, nfev = {n}, "
              f"status = {s}")
