"""The inputs of the two-loop direction calls a solve makes, and their
error against f64: the yardsticks of the kernel's accuracy."""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from ..ops import fused


def capture_calls(run: Callable[[], object], every: int = 1) -> List[Tuple]:
    """Run ``run()`` and return the inputs (s, y, ys, theta, ptr, ncorr,
    sy, yy, rinv, v) of every ``every``-th ``fused.two_loop`` call it
    makes, cloned.  Every call launches as usual, but counts no launch:
    ``fused.two_loop`` counts on whatever it is bound to."""
    calls, seen = [], [0]
    real = fused.two_loop

    def keep(*args):
        if seen[0] % every == 0:
            calls.append(tuple(t.clone() if isinstance(t, torch.Tensor)
                               else t for t in args[:10]))
        seen[0] += 1
        return real(*args)

    fused.two_loop = fused.with_counts(keep)
    try:
        run()
    finally:
        fused.two_loop = real
    return calls


def rel_errors(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per instance, ``max|out - ref| / max|ref|`` on the CPU, in f64."""
    scale = ref.abs().max(dim=1).values.clamp_min(1e-300)
    return ((out.double() - ref).abs().max(dim=1).values / scale).cpu()
