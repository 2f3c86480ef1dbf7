"""The eager batched path: ``minimize_batched`` on a batch of starts.

The traffic's ``params`` (the main phase), ``polish_params`` and
``options`` (keyword arguments of ``minimize_batched``) give the recipe;
the objective is a plain per-instance function that the port maps over
the batch.  The work falls on the solver step, the line searches,
``ops/history``, the two-loop kernel (csrc/two_loop.cu) and, in the
polish, the df64 pair arithmetic.
"""

from __future__ import annotations

import torch

from portbench.entries._multistart import Multistart


class Entry(Multistart):

    def __init__(self, ctx):
        super().__init__(ctx)
        import lbfgspp_tpu_torch as lt
        from lbfgspp_tpu_torch.ops import fused
        from lbfgspp_tpu_torch.utils import doublefloat
        self.lt, self.fused, self.dfl = lt, fused, doublefloat
        self.dtype = getattr(torch, self.traffic["dtype"])
        self.params = lt.LBFGSParams(**self.traffic["params"])
        self.options = dict(self.traffic.get("options", {}))
        if "polish_params" in self.traffic:
            self.options["polish_params"] = lt.LBFGSParams(
                **self.traffic["polish_params"])
        self.fun = ctx.objective.fun
        main = self.traffic["params"]
        self.kernel_shape = (self.batch, main.get("m", 6), self.n)

    def solve(self, x0s):
        res = self.lt.minimize_batched(self.fun, x0s, self.params,
                                       device=self.ctx.device,
                                       **self.options)
        return res.x, None

    def counters(self) -> dict:
        tl = self.fused.two_loop
        return {"two_loop_launches": tl.launches,
                "two_loop_plain_routes": tl.plain_routes,
                "df64_fallbacks": sum(self.dfl.FALLBACKS.values())}

    def extras(self) -> dict:
        """Bytes of one two-loop call at the main phase's shape (the
        polish's calls, at twice n in pair space, are counted at it too:
        a lower count, so the share read from it is a lower one)."""
        from portbench import yardstick as ys
        b, m, n = self.kernel_shape
        mode = self.options.get("direction", "sweeps")
        return dict(two_loop_bytes=ys.args_bytes(
            ys.two_loop_args(b, m, n, self.dtype), mode))


def make(ctx):
    return Entry(ctx)
