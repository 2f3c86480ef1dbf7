"""The eager box path: ``minimize_b_batched`` on a batch of starts.

Not used by a cell yet (see PERF.md, Open questions).  The traffic's
``params`` (``LBFGSBParams``) and ``options`` (keyword arguments of
``minimize_b_batched``, such as ``gcp`` and ``polish_iters``) give the
recipe; the bounds are the configuration's, shared by every instance.
"""

from __future__ import annotations

import torch

from portbench.entries._multistart import Multistart


class Entry(Multistart):

    def __init__(self, ctx):
        super().__init__(ctx)
        import lbfgspp_tpu_torch as lt
        self.lt = lt
        self.dtype = getattr(torch, self.traffic["dtype"])
        self.params = lt.LBFGSBParams(**self.traffic["params"])
        self.options = dict(self.traffic.get("options", {}))
        self.fun = ctx.objective.fun
        self.bounds = self.cfg["bounds"]

    def solve(self, x0s):
        res = self.lt.minimize_b_batched(self.fun, x0s, self.bounds[0],
                                         self.bounds[1], self.params,
                                         device=self.ctx.device,
                                         **self.options)
        return res.x, None

    def counters(self) -> dict:
        from lbfgspp_tpu_torch.ops import fused
        return {"two_loop_launches": fused.two_loop.launches}

    def extras(self) -> dict:
        return {}


def make(ctx):
    return Entry(ctx)
