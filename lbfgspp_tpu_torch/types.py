"""Core state types, status codes and the device rule.

The port's counterpart of ``lbfgspp_tpu.types``.  Every solver state here
is batch-explicit: each tensor has a leading batch axis ``B`` and a single
solve is ``B = 1``.  Where the JAX package relies on ``vmap`` of a
``lax.cond``/``lax.while_loop`` to freeze finished instances, the port runs
the update for the whole batch and selects per instance with
:func:`freeze_when` / :func:`tree_select`, which is the same frozen-carry
semantics written out.
"""

from __future__ import annotations

import contextlib
import enum
from typing import Any, Callable, NamedTuple, Optional

import torch

Tensor = torch.Tensor


class Status(enum.IntEnum):
    """Solver / line-search termination codes (same values as the JAX
    package's ``Status``)."""

    RUNNING = 0
    # Successful terminations
    CONVERGED_GRAD = 1       # gradient-norm test (LBFGS.h:137, LBFGSB.h:213)
    CONVERGED_DELTA = 2      # past/delta objective test (LBFGS.h:142-149)
    MAX_ITERATIONS = 3       # iteration cap reached (LBFGS.h:151)
    # Line-search failures (each maps to a reference `throw` site)
    LS_INVALID_STEP = 10     # 'step' must be positive / outside [min,max]
    LS_NOT_DESCENT = 11      # direction does not decrease f
    LS_MAX_LINESEARCH = 12   # backtracking/bracketing iteration cap
    LS_STEP_TOO_SMALL = 13   # step fell below param.min_step
    LS_STEP_TOO_LARGE = 14   # step exceeded param.max_step
    LS_BRACKET_INVERTED = 15  # bracketing lower bound passed upper bound
    LS_NUMERICAL = 16        # interpolation failure (NocedalWright zoom)


# Status values that are *successful* terminations of minimize().
SUCCESS_STATUSES = (Status.CONVERGED_GRAD, Status.CONVERGED_DELTA,
                    Status.MAX_ITERATIONS)


class LineSearchResult(NamedTuple):
    """Output of a batched line search: the accepted trial point of every
    instance.  ``step``/``fx``/``dg``/``status``/``nfev`` are [B];
    ``grad``/``x`` are [B, n]."""

    step: Tensor
    fx: Tensor
    grad: Tensor
    dg: Tensor
    x: Tensor
    status: Tensor   # int32, Status value
    nfev: Tensor     # int32, number of f/g evaluations performed


class SolveResult(NamedTuple):
    """Result of ``minimize``: every field carries the batch axis (a solve
    from a 1-D ``x0`` through :func:`..lbfgs.minimize` drops it again)."""

    x: Tensor
    fx: Tensor
    grad: Tensor
    gnorm: Tensor
    niter: Tensor    # int32, iterations used (reference return value)
    nfev: Tensor     # int32, total objective evaluations
    status: Tensor   # int32, Status value
    history: Any     # LBFGSHistory at the final iterate


# A batched value-and-gradient oracle: x [B, n] -> (fx [B], grad [B, n]).
ValueAndGrad = Callable[[Tensor], tuple]


def make_fun_and_grad(fun: Optional[Callable] = None,
                      fun_and_grad: Optional[Callable] = None,
                      with_data: bool = False) -> ValueAndGrad:
    """Build the batched objective oracle used by solvers and line searches.

    The user writes the objective for ONE instance, ``fun(x[n]) -> fx`` or
    ``fun_and_grad(x[n]) -> (fx, grad)``, as with the JAX package.  The
    port maps it over the batch with ``torch.func.vmap``; the gradient of a
    plain ``fun`` comes from ``torch.func.grad_and_value`` (the counterpart
    of ``jax.value_and_grad``).

    ``with_data``: the objective is ``fun(x[n], data_i)`` and the oracle
    ``(x [B, n], data) -> (fx, grad)`` maps both over the batch
    (``in_dims=(0, 0)``); ``data`` is a tensor or a tree of tensors with a
    leading ``[B]`` axis.  :func:`data_fun_and_grad` binds it.
    """
    in_dims = (0, 0) if with_data else 0
    if fun_and_grad is not None:
        return torch.func.vmap(fun_and_grad, in_dims=in_dims)
    if fun is None:
        raise ValueError("either 'fun' or 'fun_and_grad' must be provided")
    grad_value = torch.func.vmap(torch.func.grad_and_value(fun),
                                 in_dims=in_dims)

    def fg(x: Tensor, *data):
        grad, fx = grad_value(x, *data)
        return fx, grad

    return fg


def data_fun_and_grad(fun: Optional[Callable] = None,
                      fun_and_grad: Optional[Callable] = None,
                      data: Any = None) -> ValueAndGrad:
    """The batched oracle ``x [B, n] -> (fx [B], grad [B, n])`` of
    ``fun(x[n], data_i)`` with every instance's own ``data`` (a tensor or a
    tree of tensors with a leading ``[B]`` axis), or of ``fun(x[n])`` when
    ``data`` is None: the batch-explicit form of vmapping a JAX solve over
    a closure.  The oracle's calls must pass the whole batch."""
    if data is None:
        return make_fun_and_grad(fun, fun_and_grad)
    fgd = make_fun_and_grad(fun, fun_and_grad, with_data=True)
    return lambda x: fgd(x, data)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    The default is the CUDA card.  Without one, the caller must ask for
    the CPU explicitly (``device="cpu"``, as the tests do): an entry point
    never drops to the CPU on its own.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device


@contextlib.contextmanager
def matmul_tf32(allowed: bool):
    """Set ``torch.backends.cuda.matmul.allow_tf32`` to ``allowed`` inside
    the block and give the caller's value back on exit, exceptions
    included; also a decorator.  The port's products that must run in
    full float32 (the JAX package pins ``Precision.HIGHEST`` on its own
    einsums) take ``matmul_tf32(False)``, so a solve never changes the
    caller's setting."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = allowed
    try:
        yield
    finally:
        flags.allow_tf32 = before


def i32_like(value: int, like: Tensor) -> Tensor:
    """An int32 tensor of ``like``'s shape and device, filled with
    ``value`` (a status code, a counter)."""
    return torch.full_like(like, int(value), dtype=torch.int32)


def _bcast(pred: Tensor, like: Tensor) -> Tensor:
    """A [B] predicate viewed to broadcast against a [B, ...] tensor."""
    return pred.reshape(pred.shape + (1,) * (like.dim() - pred.dim()))


def tree_select(pred: Tensor, on_true, on_false):
    """Per-instance ``where`` over matching NamedTuples of [B, ...] tensors
    (``None`` fields stay ``None``): instance ``b`` takes ``on_true`` where
    ``pred[b]`` and ``on_false`` elsewhere."""
    if on_true is None:
        return None
    if isinstance(on_true, tuple):
        return type(on_true)(*(tree_select(pred, a, b)
                               for a, b in zip(on_true, on_false)))
    return torch.where(_bcast(pred, on_true), on_true, on_false)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of matching NamedTuples (``None`` fields
    stay ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(tree_map(fn, *leaves)
                            for leaves in zip(tree, *rest)))
    return fn(tree, *rest)


def freeze_when(pred: Tensor, state, update_fn):
    """``update_fn(state)`` for the instances where ``pred`` is False; the
    others pass through unchanged (the frozen carry that ``vmap`` of a
    ``lax.cond`` gives the JAX package).  The update runs for the whole
    batch and is then selected per instance."""
    return tree_select(pred, state, update_fn(state))
