"""A feature-split L-BFGS solve stepped one iteration a unit.

Every rank holds its block of the features (``n / world`` columns of the
hashed design, built at set-up from the seed) and steps the solver that
``lbfgspp_tpu_torch.parallel.sharded.minimize_sharded`` runs, built the
same way (``lbfgs._build_solver`` on the split oracle, under the group,
with the traffic's ``direction``, ``history_dtype`` and ``on_ls_fail``).
A unit is one iteration of the running solve.  A solve ends at the
traffic's ``max_iterations`` (or when the solver stops it); the next unit
starts a new solve from w = 0, as a daily retrain does, and that start's
evaluation counts in that unit.

Once the window has closed, ``sample()`` hands the reference the solve
that was running, stepped on (untimed) until it has ``m + 2`` iterations:
its iterate, value, gradient, direction and correction pairs.
"""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from portbench import hashed_rows


class Entry:
    def __init__(self, ctx):
        from lbfgspp_tpu_torch import LBFGSParams, lbfgs
        from lbfgspp_tpu_torch.parallel import collectives as coll
        from lbfgspp_tpu_torch.parallel import sharded
        self.ctx, self.coll = ctx, coll
        cfg, traffic = ctx.cfg, ctx.traffic
        n, world = int(cfg["n"]), int(ctx.world)
        if n % world:
            raise ValueError(f"n = {n} does not divide over {world} ranks")
        self.n_local = n // world
        with record_function("portbench.design"):
            self.design = hashed_rows.local_design(
                cfg, ctx.seed, ctx.rank * self.n_local, self.n_local,
                ctx.device, values=getattr(ctx, "design_values", None))
        self.counts = dict(evals=0, iterations=0, solves=0, rises=0)
        fg = ctx.objective.make(self.design, float(cfg["l2"]), ctx.group,
                                ctx.rank, ctx.trace, self.counts)
        self.params = LBFGSParams(**traffic["params"])
        hist = traffic["history_dtype"]
        self.solver = lbfgs._build_solver(
            sharded.make_sharded_fg(local_fun_and_grad=fg, mesh=ctx.group),
            self.params, line_search=traffic["line_search"],
            direction=traffic["direction"],
            on_ls_fail=traffic["on_ls_fail"],
            history_dtype=hist and getattr(torch, hist),
            group=ctx.group, device=ctx.device)
        self.x0 = torch.zeros((1, self.n_local), device=ctx.device)
        self.state, self.steps, self.fx = None, 0, math.inf

    def _step(self) -> bool:
        """One iteration of the running solve (a new solve first if none
        runs); True when its value is finite."""
        if self.state is None or bool(self.state.done[0]):
            self.state = self.solver.init(self.x0)
            self.steps, self.fx = 0, float(self.state.fx[0])
            self.counts["solves"] += 1
        with record_function("portbench.step"):
            self.state = self.solver.step(self.state)
        fx = float(self.state.fx[0])
        self.counts["rises"] += int(fx > self.fx)
        self.steps, self.fx = self.steps + 1, fx
        self.counts["iterations"] += 1
        return math.isfinite(fx) and bool(
            torch.isfinite(self.state.gnorm[0]))

    def warm(self) -> None:
        """A short solve (its start, two iterations: every kernel and
        collective of an iteration), then the window starts afresh."""
        for _ in range(2):
            self._step()
        self.state = None
        self.counts.update(evals=0, iterations=0, solves=0, rises=0)

    def unit(self, i: int):
        ok = self._step()
        return 1, int(not ok), int(ok)

    def counters(self) -> dict:
        return dict(self.counts,
                    allreduces=sum(self.coll.COUNTS.values()))

    def extras(self) -> dict:
        from portbench.yardstick import logreg_eval_bytes
        d = self.design
        return dict(eval_bytes=logreg_eval_bytes(d["nnz"], d["rows"],
                                                 d["n_local"], d["touched"]),
                    nnz=d["nnz"], touched=d["touched"],
                    index_dtype=d["index_dtype"])

    def sample(self) -> dict:
        """The check: the running solve with at least ``m + 2``
        iterations (a solve that ended with the window's last unit keeps
        no pair for its last step, so a new one is started), and its
        correction pairs in age order (views of the history's rows).  The
        design and the rest of the state are dropped."""
        m = self.params.m
        if self.state is not None and bool(self.state.done[0]):
            self.state = None
        ok = True
        while self.state is None or (self.steps < m + 2 and
                                     not bool(self.state.done[0])):
            ok = self._step() and ok
        st, h = self.state, self.state.hist
        ncorr, ptr = int(h.ncorr[0]), int(h.ptr[0])
        order = [(ptr - ncorr + j) % m for j in range(ncorr)]
        out = dict(x=st.x[0], fx=float(st.fx[0]), g=st.grad[0],
                   d=st.drt[0], s=h.s[0], y=h.y[0], order=order, m=m,
                   steps=self.steps, finite=ok,
                   rises=self.counts["rises"], l2=float(self.ctx.cfg["l2"]))
        self.state = self.design = self.solver = None
        return out


def make(ctx):
    return Entry(ctx)
