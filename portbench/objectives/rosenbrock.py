"""Pairwise Rosenbrock (examples/example-rosenbrock.cpp:14-29), ONE instance.

``fun`` is written for the port's batched eager solvers (mapped over the
batch by autograd, and re-evaluated in pair arithmetic by the df64
polish, so it uses no fused operation); ``BUILTIN`` names the native
core's own copy of the same objective.
"""

import torch

BUILTIN = "rosenbrock"


def fun(x: torch.Tensor) -> torch.Tensor:
    """For even i, ``(1 - x_i)^2 + (10 (x_{i+1} - x_i^2))^2``, summed."""
    p = x.reshape(-1, 2)
    xe, xo = p[:, 0], p[:, 1]
    t1 = 1.0 - xe
    t2 = 10.0 * (xo - xe * xe)
    return torch.sum(t1 * t1 + t2 * t2)
