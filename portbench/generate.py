"""The one input generator: seeds mixed from whole numbers, and starts
drawn on the device.

Every input of a run comes from ``--seed`` through :func:`mix`, so the same
seed gives the same inputs, and a seed of any size (beyond 32 bits too)
gives a valid generator seed.
"""

from __future__ import annotations

import numpy as np
import torch


def mix(*parts: int) -> int:
    """A 63-bit generator seed from whole numbers of any size."""
    return int(np.random.SeedSequence([int(p) for p in parts])
               .generate_state(1, np.uint64)[0] >> 1)


def uniform(seed: int, index: int, shape, low: float, high: float,
            dtype, device) -> torch.Tensor:
    """``shape`` values uniform in ``[low, high)``, drawn on ``device`` in
    ``dtype`` from a generator seeded by (seed, index)."""
    gen = torch.Generator(device=device).manual_seed(mix(seed, index))
    x = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    return x * (high - low) + low
