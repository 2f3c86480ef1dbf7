"""The box multistart on the port's normal path: ``native.minimize_b_batch``
on the card.

One launch of ``native_lbfgsb_batch`` (csrc/native/batch.cu, a warp per
instance) solves a whole batch of starts in float64 with a builtin
objective, each in the configuration's box: a ``[lo, hi]`` pair a
coordinate, ``null`` for no bound, the same ``[n]`` bounds for every
instance.  The base entry's raw kernel call gives way to the public one;
this entry also keeps the traced batches' counts for the yardstick, and
holds ``x_star`` as a tensor, so that the quality bar's check broadcasts.
"""

from __future__ import annotations

import math

import torch

from portbench.entries.native_box_batch import Entry as BoxEntry


class Entry(BoxEntry):

    def __init__(self, ctx):
        super().__init__(ctx)
        dev, f64 = ctx.device, torch.float64
        lo = [-math.inf if b[0] is None else b[0] for b in self.bounds]
        hi = [math.inf if b[1] is None else b[1] for b in self.bounds]
        self.lb = torch.tensor(lo, dtype=f64, device=dev)
        self.ub = torch.tensor(hi, dtype=f64, device=dev)
        self.cfg = dict(self.cfg, x_star=torch.tensor(
            self.cfg["x_star"], dtype=f64, device=dev))
        self.counts = []

    def solve(self, x0s):
        res = self.native.minimize_b_batch(self.fun, x0s, self.lb, self.ub,
                                           self.params,
                                           device=self.ctx.device)
        if self.ctx.trace:
            self.counts.append((res.niter, res.nfev))
        return res.x, res.fx

    def warm(self) -> None:
        super().warm()
        self.counts.clear()

    def extras(self) -> dict:
        """The traced batches' f64 flops (the yardstick's box count, a lower
        bound, from each instance's iterations and evaluations) and
        bytes."""
        from portbench import yardstick as ys
        flops = sum(ys.native_flops(k, e, self.n, self.params.m,
                                    ys.ROSENBROCK_FLOPS, box=True)
                    for k, e in self.counts)
        return dict(native_flops=flops,
                    native_bytes=len(self.counts) *
                    ys.native_bytes(self.batch, self.n, box=True))


def make(ctx):
    return Entry(ctx)
