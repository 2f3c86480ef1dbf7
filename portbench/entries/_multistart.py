"""What the multistart entries share: the seeded starts, the sample kept for
the reference, and the per-batch count of solves.

A batch is one unit of work: ``batch`` starts (the configuration's, unless
the traffic sets its own) drawn on the device from a generator seeded by
(seed, batch index), uniform in the configuration's start box, solved by
the entry's call, its answers checked against the quality bar on the
device.  From every batch ``check.per_unit`` instances
(their indices drawn from (seed, batch index)) are copied aside; once the
window has closed, ``check.sample`` of them, drawn from the seed, go to
the reference.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from portbench.generate import mix, uniform
from portbench.yardstick import within


# the batch index of the set-up's warm batch, beyond any window's
WARM_INDEX = 1 << 40


class Multistart:
    """Base of the multistart entries; a subclass defines ``solve(x0s)``
    returning ``(x [B, n], fx [B] or None)`` and may add counters."""

    dtype = torch.float64

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.cfg, ctx.traffic
        self.batch = int(self.traffic["batch"] if "batch" in self.traffic
                         else self.cfg["batch"])
        self.n = int(self.cfg["n"])
        self.lo, self.hi = self.cfg["start_box"]
        self.check = self.traffic["check"]
        self.kept = []

    def draw(self, i: int) -> torch.Tensor:
        return uniform(self.ctx.seed, i, (self.batch, self.n), self.lo,
                       self.hi, self.dtype, self.ctx.device)

    def picks(self, i: int) -> torch.Tensor:
        rng = np.random.default_rng(mix(self.ctx.seed, i, 1))
        k = min(self.batch, int(self.check["per_unit"]))
        idx = np.sort(rng.choice(self.batch, k, replace=False))
        return torch.as_tensor(idx, device=self.ctx.device)

    def warm(self) -> None:
        """One whole unit at the cell's own shape (builds, plans, the
        allocator, every kernel of the draw and the check), drawn from an
        index the window never uses."""
        self.unit(WARM_INDEX)
        self.kept.clear()

    def unit(self, i: int):
        with record_function("portbench.draw"):
            x0 = self.draw(i)
            idx = self.picks(i)
            starts = x0[idx].clone()
        with record_function("portbench.solve"):
            x, fx = self.solve(x0)
        with record_function("portbench.check"):
            ok = within(x, self.cfg["bar"], self.cfg["x_star"])
            finite = torch.isfinite(x).all(1)
            self.kept.append((starts, x[idx].double(),
                              None if fx is None else fx[idx].double()))
            good, bad = int(ok.sum()), int((~finite).sum())
        return self.batch, bad, good

    def sample(self) -> dict:
        """The sample for the reference, as float64 NumPy; the program's
        answers beyond it are dropped."""
        if not self.kept:
            return dict(x0=np.zeros((0, self.n)), x=np.zeros((0, self.n)),
                        fx=None)
        x0 = torch.cat([k[0] for k in self.kept]).double().cpu().numpy()
        x = torch.cat([k[1] for k in self.kept]).cpu().numpy()
        fx = None if self.kept[0][2] is None else \
            torch.cat([k[2] for k in self.kept]).cpu().numpy()
        self.kept.clear()
        rng = np.random.default_rng(mix(self.ctx.seed, 2))
        take = np.sort(rng.choice(len(x0), min(len(x0),
                                               int(self.check["sample"])),
                                  replace=False))
        return dict(x0=x0[take], x=x[take],
                    fx=None if fx is None else fx[take])
