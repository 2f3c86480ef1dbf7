"""Run this framework's L-BFGS inside a PyTorch training loop.

The port's counterpart of ``lbfgspp_tpu.optax_compat``, which puts the
reference solver (LBFGS.h:79-173: its line searches, curvature gate,
ring-buffer history and status codes) behind optax's update protocol.  In
PyTorch's idiom that protocol is a ``torch.optim.Optimizer`` whose
``step(closure)`` runs ONE outer solver iteration, line search included:

    opt = optax_compat.LBFGS(model.parameters(), LBFGSParams(m=8))

    def closure():
        opt.zero_grad()
        loss = loss_fn(model(inputs), targets)
        loss.backward()
        return loss

    for _ in range(steps):
        opt.step(closure)

The closure has ``torch.optim.LBFGS``'s contract: it clears the gradients,
evaluates the loss at the parameters' current values, calls ``backward``
and returns the loss.  The solver evaluates it at its trial points by
writing them into the parameters; after a step the parameters hold the
new iterate ``x_{k+1}``.  The state carries the objective and gradient at
the iterate, so a step evaluates only the line search's trials (the first
step also evaluates the starting point).  Once the solver has terminated
(convergence or failure: :func:`status`), further steps leave the
parameters unchanged, so a fixed-step loop is safe.  ``history_dtype``
stores the history's rows at reduced precision (:func:`.lbfgs.solver`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import lbfgs as _lbfgs
from .params import LBFGSParams

Tensor = torch.Tensor


class LBFGS(torch.optim.Optimizer):
    """The L-BFGS solver as an optimizer over one group of parameters
    (any shapes, one floating dtype, one device); they are raveled in
    their given order into the solver's flat ``[n]`` vector.  The
    counterpart of ``lbfgspp_tpu.optax_compat.lbfgs``
    (lbfgspp_tpu/optax_compat.py:94-158); see the module docstring."""

    def __init__(self, params, lbfgs_params: LBFGSParams = LBFGSParams(), *,
                 line_search: str = "nocedalwright", history_dtype=None):
        super().__init__(params, dict(lbfgs_params=lbfgs_params,
                                      line_search=line_search,
                                      history_dtype=history_dtype))
        if len(self.param_groups) != 1:
            raise ValueError("optax_compat.LBFGS takes one parameter group")
        self._params = self.param_groups[0]["params"]
        if len({(p.dtype, p.device) for p in self._params}) != 1:
            raise ValueError("optax_compat.LBFGS needs parameters of one "
                             "dtype on one device")

    def _flat(self) -> Tensor:
        return torch.cat([p.detach().reshape(-1) for p in self._params])

    @torch.no_grad()
    def _write(self, flat: Tensor) -> None:
        offset = 0
        for p in self._params:
            p.copy_(flat[offset:offset + p.numel()].view_as(p))
            offset += p.numel()

    def _oracle(self, closure: Callable):
        """The batched (B = 1) value and gradient: the closure at the
        parameters set to the trial point."""
        def fg(x: Tensor):
            self._write(x[0])
            with torch.enable_grad():
                loss = closure()
            grad = torch.cat([
                (p.grad if p.grad is not None else torch.zeros_like(p))
                .reshape(-1) for p in self._params])
            return (torch.as_tensor(loss).detach().to(x.dtype).reshape(1),
                    grad.to(x.dtype)[None])
        return fg

    @property
    def inner(self) -> Optional[_lbfgs.LBFGSState]:
        """The solver's state (B = 1), None before the first step."""
        return self.state[self._params[0]].get("inner")

    def step(self, closure: Callable) -> Tensor:
        """One outer solver iteration; returns the loss at the iterate the
        step started from (as ``torch.optim.LBFGS`` returns its first
        loss)."""
        if closure is None:
            raise ValueError("optax_compat.LBFGS.step needs a closure that "
                             "evaluates the loss and its gradient")
        group = self.param_groups[0]
        x = self._flat()[None]
        fg = self._oracle(closure)
        solver = _lbfgs._build_solver(
            fg, group["lbfgs_params"], line_search=group["line_search"],
            history_dtype=group["history_dtype"], device=x.device)
        state = self.state[self._params[0]]
        inner = state.get("inner")
        if inner is None:
            inner = solver.init(x, fg0=fg(x))
        if bool(inner.done.all()):
            nxt = inner         # terminated: the parameters stay put
        else:
            nxt = solver.step(inner)
        state["inner"] = nxt
        self._write(nxt.x[0])
        return inner.fx[0]


def status(opt: LBFGS) -> Tensor:
    """The solver's :class:`~.types.Status` code at the current iterate
    (``RUNNING`` while optimizing)."""
    return opt.inner.status[0]


def niter(opt: LBFGS) -> Tensor:
    """Outer solver iterations completed so far (the reference's return
    value, LBFGS.h:76)."""
    return opt.inner.k[0]
