"""Faults planted under the split cell's timed path, for its tests: each
kind is a rank's ``(prepare, answers)`` (portbench/run.py ``launch``'s
hooks).

* ``raise``: rank 1 raises during set-up;
* ``hang``: rank 1 never reaches the first collective;
* ``unchanged``: a solver step returns its state unchanged;
* ``half``: half of the rows left out, the mean taken over the rest;
* ``no_exchange``: the logits' all-reduce left out on every rank;
* ``altered``: the direction altered where the two-loop produces it.
"""

from __future__ import annotations

import time

import torch


def _raise(ctx):
    if ctx.rank == 1:
        raise RuntimeError("a planted failure")


def _hang(ctx):
    if ctx.rank == 1:
        while True:
            time.sleep(1)


def _unchanged(ctx):
    from lbfgspp_tpu_torch import lbfgs
    real = lbfgs._build_solver

    def build(*args, **kwargs):
        return real(*args, **kwargs)._replace(step=lambda c: c)
    lbfgs._build_solver = build


def _halve(d: dict) -> dict:
    """``d`` with the first half of its rows only."""
    half = d["rows"] // 2
    e = int(d["crow"][half])
    keep = d["trow"] < half
    before = torch.zeros(keep.numel() + 1, dtype=torch.long)
    before[1:] = torch.cumsum(keep.long(), 0)
    return dict(d, rows=half, crow=d["crow"][:half + 1], col=d["col"][:e],
                val=d["val"][:e], labels=d["labels"][:half],
                tcrow=before[d["tcrow"].long()].to(d["tcrow"].dtype),
                trow=d["trow"][keep], tval=d["tval"][keep])


def _half(ctx):
    real = ctx.objective

    class Halved:
        @staticmethod
        def make(design, *args, **kwargs):
            return real.make(_halve(design), *args, **kwargs)
    ctx.objective = Halved


def _no_exchange(ctx):
    from lbfgspp_tpu_torch.parallel import collectives as coll
    real = coll.psum

    def psum(x, group=None, site="psum"):
        return x.clone() if site == "logreg.logits" else real(x, group, site)
    coll.psum = psum


def _altered(ctx):
    from lbfgspp_tpu_torch.ops import history
    real = history.apply_hv

    def apply_hv(*args, **kwargs):
        return real(*args, **kwargs) * 1.01
    history.apply_hv = apply_hv


KINDS = {"raise": _raise, "hang": _hang, "unchanged": _unchanged,
         "half": _half, "no_exchange": _no_exchange, "altered": _altered}


def hooks(kind: str):
    return KINDS[kind], None
