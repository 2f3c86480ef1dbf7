"""A ``scipy.optimize.minimize``-style front end.

The port's counterpart of ``lbfgspp_tpu.scipy_compat``: the same option
map and result, on the port's solvers, so a call site written against
scipy switches with an import:

    from lbfgspp_tpu_torch.scipy_compat import minimize
    out = minimize(f, x0, jac=True, bounds=[(0, None)] * n,
                   options={"maxiter": 200, "gtol": 1e-6})

Semantics map (scipy name -> this framework / reference):

==============  =====================================================
``maxcor``      history size ``m`` (Param.h:86)
``gtol``        ``epsilon``: gradient-norm tolerance (Param.h:95;
                projected-gradient inf-norm in the box case)
``maxiter``     ``max_iterations`` (Param.h:117)
``maxls``       ``max_linesearch`` (Param.h:133)
``ftol``        objective-decrease tolerance ``delta`` with ``past=1``
                (Param.h:104-115)
``eps_rel``     extension: ``epsilon_rel`` (Param.h:99), 0 by default
==============  =====================================================

``disp``/``iprint``/``eps``/``finite_diff_rel_step``/``maxfun`` are
accepted and ignored.  ``fun`` is a PyTorch function of one ``[n]``
tensor (its gradient comes from ``torch.func`` unless ``jac`` gives it);
the solve runs on ``device`` (the card by default, ``device="cpu"`` for
the CPU), and the returned ``x`` is a tensor there.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import lbfgs as _lbfgs
from . import lbfgsb as _lbfgsb
from .params import LBFGSBParams, LBFGSParams
from .types import Status, resolve_device

__all__ = ["minimize", "fmin_l_bfgs_b", "OptimizeResult"]


class OptimizeResult(dict):
    """Attribute-accessible result dict mirroring
    ``scipy.optimize.OptimizeResult``."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    __setattr__ = dict.__setitem__


_MESSAGES = {
    int(Status.RUNNING): "maximum number of iterations reached",
    int(Status.CONVERGED_GRAD): "gradient tolerance satisfied",
    int(Status.CONVERGED_DELTA): "objective decrease below delta",
    int(Status.MAX_ITERATIONS): "maximum number of iterations reached",
}


def _normalize_bounds(bounds, n):
    """A scipy ``Bounds`` object or a sequence of (lo, hi) pairs (``None``
    meaning unbounded, as scipy does) as two float64 arrays."""
    if hasattr(bounds, "lb") and hasattr(bounds, "ub"):
        lb = np.broadcast_to(np.asarray(bounds.lb, np.float64), (n,))
        ub = np.broadcast_to(np.asarray(bounds.ub, np.float64), (n,))
        return np.array(lb), np.array(ub)
    bounds = list(bounds)
    if len(bounds) != n:
        raise ValueError(f"length of x0 != length of bounds "
                         f"({n} != {len(bounds)})")
    lb = np.empty(n)
    ub = np.empty(n)
    for i, (lo, hi) in enumerate(bounds):
        lb[i] = -np.inf if lo is None else lo
        ub[i] = np.inf if hi is None else hi
    return lb, ub


def _objective(fun, args, jac) -> dict:
    """``fun`` (with ``args``) as the solver's ``fun`` or ``fun_and_grad``:
    ``jac=True`` means ``fun`` returns ``(fx, grad)``, a callable ``jac``
    is evaluated beside it, anything else differentiates ``fun``."""
    if jac is True:
        return dict(fun_and_grad=(lambda x: fun(x, *args)) if args else fun)
    if callable(jac):
        return dict(fun_and_grad=lambda x: (fun(x, *args), jac(x, *args)))
    return dict(fun=(lambda x: fun(x, *args)) if args else fun)


def _bounds(bounds, n, x0):
    lb, ub = (np.full(n, -np.inf), np.full(n, np.inf)) if bounds is None \
        else _normalize_bounds(bounds, n)
    return (torch.as_tensor(lb, dtype=x0.dtype, device=x0.device),
            torch.as_tensor(ub, dtype=x0.dtype, device=x0.device))


def minimize(fun: Callable,
             x0,
             args: tuple = (),
             method: Optional[str] = None,
             jac=None,
             bounds: Optional[Sequence] = None,
             tol: Optional[float] = None,
             options: Optional[dict] = None,
             device=None) -> OptimizeResult:
    """``scipy.optimize.minimize``-compatible entry point
    (lbfgspp_tpu/scipy_compat.py:96-202).

    ``method`` may be ``None`` (L-BFGS-B when ``bounds`` is given, else
    L-BFGS), ``"L-BFGS"`` or ``"L-BFGS-B"``.  ``jac=True`` means ``fun``
    returns ``(fx, grad)``; a callable ``jac`` is evaluated alongside
    ``fun``; ``jac=None`` differentiates ``fun``.
    """
    options = dict(options or {})
    device = resolve_device(device)
    x0 = torch.as_tensor(x0, device=device)
    n = x0.shape[-1]

    if method is None:
        method = "L-BFGS-B" if bounds is not None else "L-BFGS"
    method = method.upper()
    if method not in ("L-BFGS", "L-BFGS-B", "LBFGS", "LBFGSB"):
        raise ValueError(f"unsupported method {method!r}")
    boxed = method in ("L-BFGS-B", "LBFGSB")
    if bounds is not None and not boxed:
        raise ValueError(f"method {method!r} cannot handle bounds; "
                         "use method='L-BFGS-B' (or method=None)")

    kw = {}
    if "maxcor" in options:
        kw["m"] = int(options.pop("maxcor"))
    if tol is not None and "gtol" not in options:
        options["gtol"] = tol
    if "gtol" in options:
        kw["epsilon"] = float(options.pop("gtol"))
    # scipy has no relative-gradient test; the solver's default
    # epsilon_rel would override a tight gtol for large solutions.
    kw["epsilon_rel"] = float(options.pop("eps_rel", 0.0))
    if "maxiter" in options:
        kw["max_iterations"] = int(options.pop("maxiter"))
    if "maxls" in options:
        kw["max_linesearch"] = int(options.pop("maxls"))
    if "ftol" in options:
        kw["delta"] = float(options.pop("ftol"))
        kw["past"] = int(options.pop("past", 1))
    elif "past" in options:
        kw["past"] = int(options.pop("past"))
    for ignored in ("disp", "iprint", "eps", "finite_diff_rel_step",
                    "maxfun"):
        options.pop(ignored, None)
    if options:
        raise ValueError(f"unknown options: {sorted(options)}")

    obj = _objective(fun, args, jac)
    if boxed:
        lb, ub = _bounds(bounds, n, x0)
        res = _lbfgsb.minimize(x0=x0, lb=lb, ub=ub,
                               params=LBFGSBParams(**kw), device=device,
                               **obj)
    else:
        res = _lbfgs.minimize(x0=x0, params=LBFGSParams(**kw),
                              device=device, **obj)

    status = int(res.status)
    return OptimizeResult(
        x=res.x, fun=float(res.fx), jac=res.grad,
        nit=int(res.niter), nfev=int(res.nfev), status=status,
        # scipy counts hitting maxiter as failure
        success=status in (int(Status.CONVERGED_GRAD),
                           int(Status.CONVERGED_DELTA)),
        message=_MESSAGES.get(status, Status(status).name.lower()),
        solver_result=res)


def _task_warnflag(status: int):
    """A solver ``Status`` as scipy's ``(task, warnflag)`` pair: line-search
    breakdown is ``warnflag=2``, an exhausted iteration budget 1."""
    if status == int(Status.CONVERGED_GRAD):
        return "CONVERGENCE: NORM OF PROJECTED GRADIENT <= PGTOL", 0
    if status == int(Status.CONVERGED_DELTA):
        return "CONVERGENCE: REL_REDUCTION_OF_F <= FACTR*EPSMCH", 0
    if status >= int(Status.LS_INVALID_STEP):
        return "ABNORMAL_TERMINATION_IN_LNSRCH", 2
    return "STOP: TOTAL NO. of ITERATIONS REACHED LIMIT", 1


def fmin_l_bfgs_b(func: Callable,
                  x0,
                  fprime: Optional[Callable] = None,
                  args: tuple = (),
                  approx_grad: bool = False,
                  bounds: Optional[Sequence] = None,
                  m: int = 10,
                  factr: float = 1e7,
                  pgtol: float = 1e-5,
                  epsilon: float = 1e-8,
                  iprint: int = -1,
                  maxfun: int = 15000,
                  maxiter: int = 15000,
                  disp=None,
                  callback: Optional[Callable] = None,
                  maxls: int = 20,
                  device=None):
    """``scipy.optimize.fmin_l_bfgs_b``-compatible front end
    (lbfgspp_tpu/scipy_compat.py:222-304): returns ``(x, f, info)`` with
    ``info`` carrying ``grad / task / funcalls / nit / warnflag``.
    ``factr`` maps onto ``past=1, delta = factr * eps``, ``pgtol`` onto
    ``epsilon``; ``fprime=None`` with ``approx_grad`` false means ``func``
    returns ``(fx, grad)``, ``approx_grad`` true differentiates ``func``
    exactly (``epsilon`` is unused).  ``callback(xk)`` is called with a
    numpy copy of each outer iterate (the solver then runs step by step).
    ``iprint``/``disp``/``maxfun`` are accepted and ignored."""
    device = resolve_device(device)
    x0 = torch.as_tensor(x0, device=device)
    lb, ub = _bounds(bounds, x0.shape[-1], x0)
    if approx_grad:
        obj = _objective(func, args, None)
    elif fprime is not None:
        obj = _objective(func, args, fprime)
    else:
        obj = _objective(func, args, True)
    params = LBFGSBParams(
        m=m, epsilon=float(pgtol), epsilon_rel=0.0, past=1,
        delta=float(factr) * float(np.finfo(np.float64).eps),
        max_iterations=int(maxiter), max_linesearch=int(maxls))

    if callback is None:
        res = _lbfgsb.minimize(x0=x0, lb=lb, ub=ub, params=params,
                               device=device, **obj)
    else:
        s = _lbfgsb.solver(lb=lb, ub=ub, params=params, device=device,
                           **obj)
        c = s.init(x0)
        while not bool(c.done.all()):
            c = s.step(c)
            callback(c.x[0].cpu().numpy())
        res = _lbfgs.unbatch(s.finalize(c))

    task, warnflag = _task_warnflag(int(res.status))
    info = {"grad": res.grad, "task": task, "funcalls": int(res.nfev),
            "nit": int(res.niter), "warnflag": warnflag}
    return res.x, float(res.fx), info
