"""The native core's box multistart: ``native_lbfgsb_batch`` on the card.

Not used by a cell yet (see PERF.md, Open questions): a box cell needs
only a configuration with ``bounds`` and a traffic file naming this entry.
One launch solves a whole batch of starts in float64 inside the
configuration's bounds, the same for every instance.
"""

from __future__ import annotations

import torch

from portbench.entries._multistart import Multistart


class Entry(Multistart):
    dtype = torch.float64

    def __init__(self, ctx):
        super().__init__(ctx)
        from lbfgspp_tpu_torch import LBFGSBParams, native
        self.native = native
        self.params = LBFGSBParams(**self.traffic["params"])
        self.fun = ctx.objective.BUILTIN
        self.bounds = self.cfg["bounds"]

    def solve(self, x0s):
        lb = torch.full_like(x0s, self.bounds[0])
        ub = torch.full_like(x0s, self.bounds[1])
        xs = x0s.clone()
        out = self.native.native_lbfgsb_batch(self.fun, xs, lb, ub,
                                              self.params)
        return xs, out.fx

    def counters(self) -> dict:
        return {"native_box_launches":
                self.native.native_lbfgsb_batch.launches}

    def extras(self) -> dict:
        return {}


def make(ctx):
    return Entry(ctx)
