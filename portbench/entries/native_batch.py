"""The native core's multistart: ``native.minimize_batch`` on the card.

One launch of ``native_lbfgs_batch`` (csrc/native/batch.cu, a warp per
instance) solves a whole batch of starts in float64 with a builtin
objective; the host only draws the starts, launches and checks.
"""

from __future__ import annotations

import torch

from portbench.entries._multistart import Multistart


class Entry(Multistart):
    dtype = torch.float64

    def __init__(self, ctx):
        super().__init__(ctx)
        from lbfgspp_tpu_torch import LBFGSParams, native
        self.native = native
        self.params = LBFGSParams(**self.traffic["params"])
        self.line_search = self.traffic["line_search"]
        self.fun = ctx.objective.BUILTIN
        self.counts = []

    def solve(self, x0s):
        res = self.native.minimize_batch(self.fun, x0s, self.params,
                                         self.line_search,
                                         device=self.ctx.device)
        if self.ctx.trace:
            self.counts.append((res.niter, res.nfev))
        return res.x, res.fx

    def warm(self) -> None:
        super().warm()
        self.counts.clear()

    def counters(self) -> dict:
        return {"native_launches":
                self.native.native_lbfgs_batch.launches}

    def extras(self) -> dict:
        """The traced batches' f64 flops and bytes (the yardstick's count
        from each instance's iterations and evaluations)."""
        from portbench import yardstick as ys
        flops = sum(ys.native_flops(k, e, self.n, self.params.m,
                                    ys.ROSENBROCK_FLOPS)
                    for k, e in self.counts)
        return dict(native_flops=flops,
                    native_bytes=len(self.counts) *
                    ys.native_bytes(self.batch, self.n))


def make(ctx):
    return Entry(ctx)
