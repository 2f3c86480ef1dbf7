"""Solver parameter dataclasses.

The port's own copy of ``lbfgspp_tpu.params``: the same fields, defaults and
``ValueError`` rules (LBFGS++ Param.h:68-219 for ``LBFGSParams``,
Param.h:225-377 for ``LBFGSBParams``), so a configuration written for the
JAX package carries over field for field.  The dataclasses are frozen, so an
instance can be shared between solves without being changed by one of them.
"""

from __future__ import annotations

import dataclasses


# Line search termination conditions
# (reference: Param.h:23-62, enum LINE_SEARCH_TERMINATION_CONDITION).
LINESEARCH_BACKTRACKING_ARMIJO = 1
LINESEARCH_BACKTRACKING = 2
LINESEARCH_BACKTRACKING_WOLFE = 2
LINESEARCH_BACKTRACKING_STRONG_WOLFE = 3


@dataclasses.dataclass(frozen=True)
class LBFGSParams:
    """Parameters for the unconstrained L-BFGS solver.

    Defaults mirror the reference (Param.h:168-184).
    """

    m: int = 6
    epsilon: float = 1e-5
    epsilon_rel: float = 1e-5
    past: int = 0
    delta: float = 0.0
    max_iterations: int = 0
    linesearch: int = LINESEARCH_BACKTRACKING_STRONG_WOLFE
    max_linesearch: int = 20
    min_step: float = 1e-20
    max_step: float = 1e20
    ftol: float = 1e-4
    wolfe: float = 0.9

    def __post_init__(self):
        check_lbfgs_params(self)


@dataclasses.dataclass(frozen=True)
class LBFGSBParams:
    """Parameters for the box-constrained L-BFGS-B solver.

    Defaults mirror the reference (Param.h:327-343): relative to
    :class:`LBFGSParams` the ``past``/``delta`` defaults change to ``1`` /
    ``1e-10``, ``max_submin`` is added, and the ``linesearch`` enum is absent
    (L-BFGS-B always uses the More-Thuente search).
    """

    m: int = 6
    epsilon: float = 1e-5
    epsilon_rel: float = 1e-5
    past: int = 1
    delta: float = 1e-10
    max_iterations: int = 0
    max_submin: int = 10
    max_linesearch: int = 20
    min_step: float = 1e-20
    max_step: float = 1e20
    ftol: float = 1e-4
    wolfe: float = 0.9

    def __post_init__(self):
        check_lbfgsb_params(self)


def _check_common(p) -> None:
    if p.m <= 0:
        raise ValueError("'m' must be positive")
    if p.epsilon < 0:
        raise ValueError("'epsilon' must be non-negative")
    if p.epsilon_rel < 0:
        raise ValueError("'epsilon_rel' must be non-negative")
    if p.past < 0:
        raise ValueError("'past' must be non-negative")
    if p.delta < 0:
        raise ValueError("'delta' must be non-negative")
    if p.max_iterations < 0:
        raise ValueError("'max_iterations' must be non-negative")
    if p.max_linesearch <= 0:
        raise ValueError("'max_linesearch' must be positive")
    if p.min_step < 0:
        raise ValueError("'min_step' must be positive")
    if p.max_step < p.min_step:
        raise ValueError("'max_step' must be greater than 'min_step'")
    if p.ftol <= 0 or p.ftol >= 0.5:
        raise ValueError("'ftol' must satisfy 0 < ftol < 0.5")
    if p.wolfe <= p.ftol or p.wolfe >= 1:
        raise ValueError("'wolfe' must satisfy ftol < wolfe < 1")


def check_lbfgs_params(p: LBFGSParams) -> None:
    """Eager validation mirroring Param.h:191-218 (raises ``ValueError``
    where the reference throws ``std::invalid_argument``)."""
    _check_common(p)
    if (p.linesearch < LINESEARCH_BACKTRACKING_ARMIJO
            or p.linesearch > LINESEARCH_BACKTRACKING_STRONG_WOLFE):
        raise ValueError("unsupported line search termination condition")


def check_lbfgsb_params(p: LBFGSBParams) -> None:
    """Eager validation mirroring Param.h:350-376."""
    _check_common(p)
    if p.max_submin < 0:
        raise ValueError("'max_submin' must be non-negative")
