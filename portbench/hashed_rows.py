"""Seeded rows of a hashed click log, and one rank's block of its design.

A row has the configuration's fields: ``integer_fields`` counts, each as
``log1p(count)`` at a fixed coordinate of its own; ``categorical_fields``
values, each one-hot (value 1) at a hashed coordinate; and a bias (value
1) at a fixed coordinate.  Field f's value is drawn from a power law over
its ``cardinalities[f]`` values (exponent ``zipf``), so a few values of
every field recur in many rows; a count is ``floor(u ** (-1 /
count_tail)) - 1``, capped at ``count_cap``.  The coordinate of (field,
value) is a fixed multiplicative hash mod ``n``, the same for every seed,
so every seed draws the same popular coordinates and the same amount of
work.  The label is +1 with probability ``sigmoid`` of a planted model's
logit (``planted``), else -1.

Rows come in blocks of ``block_rows``; block ``b`` is drawn on the device
from a generator seeded by (seed, b), so any rank, and the plain
reference, can draw any block again.  Both the program's set-up and the
reference take their rows from here.
"""

from __future__ import annotations

import torch

from portbench.generate import mix

# 2^64 / golden ratio, as a signed 64-bit integer (multiplication wraps)
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX2 = 0xBF58476D1CE4E5B9 - (1 << 64)
_LOW53 = (1 << 53) - 1


def _hash(x: torch.Tensor, mult: int) -> torch.Tensor:
    """53 well-mixed non-negative bits of each int64 in ``x``."""
    return ((x * mult) >> 11) & _LOW53


def fixed_coordinates(cfg) -> list:
    """The integer fields' and the bias's coordinates, spread over
    [0, n) so that each rank's block holds about its share of them."""
    k = int(cfg["integer_fields"]) + 1
    n = int(cfg["n"])
    return [i * (n // k) + 7 for i in range(k)]


def categorical_coordinates(field: int, value: torch.Tensor,
                            n: int) -> torch.Tensor:
    return _hash(value * 64 + field + 1, _GOLDEN) % n


def _unit(bits: torch.Tensor) -> torch.Tensor:
    return bits.double() * (1.0 / (1 << 53))


def block_count(cfg) -> int:
    rows, per = int(cfg["rows"]), int(cfg["block_rows"])
    return (rows + per - 1) // per


def block(cfg, seed: int, b: int, device):
    """Block ``b``: ``(cols [r, k] int64, vals [r, k] float32, labels [r]
    float32)``, each row's k = integer + categorical + 1 coordinates in
    ascending order."""
    rows, per = int(cfg["rows"]), int(cfg["block_rows"])
    r = min(per, rows - b * per)
    n = int(cfg["n"])
    ni, nc = int(cfg["integer_fields"]), int(cfg["categorical_fields"])
    gen = torch.Generator(device=device).manual_seed(mix(seed, b))
    u = torch.rand((r, ni + nc + 1), generator=gen, device=device,
                   dtype=torch.float64)
    fixed = torch.tensor(fixed_coordinates(cfg), device=device)
    # integer fields: heavy-tailed counts, log1p as the value
    tail, cap = float(cfg["count_tail"]), float(cfg["count_cap"])
    counts = torch.clamp(torch.floor(u[:, :ni].clamp(min=1e-300)
                                     ** (-1.0 / tail)) - 1.0, 0.0, cap)
    ivals = torch.log1p(counts)
    # categorical fields: bounded power law by the inverse CDF of its
    # continuous form, x in [1, C + 1) with density ~ x^-s
    card = torch.tensor(cfg["cardinalities"], device=device,
                        dtype=torch.float64)
    e = 1.0 - float(cfg["zipf"])
    top = (card + 1.0) ** e
    x = ((top - 1.0) * u[:, ni:ni + nc] + 1.0) ** (1.0 / e)
    value = torch.minimum(torch.floor(x) - 1.0, card - 1.0).clamp(min=0)
    field = torch.arange(nc, device=device)
    ccols = categorical_coordinates(field, value.long(), n)
    cols = torch.cat([fixed[:ni].expand(r, ni), ccols,
                      fixed[ni:].expand(r, 1)], dim=1)
    vals = torch.cat([ivals, torch.ones((r, nc + 1), device=device,
                                        dtype=torch.float64)], dim=1)
    # planted model: uniform weights from a seeded hash of the coordinate
    p = cfg["planted"]
    salt = mix(seed, 1 << 41) & ((1 << 62) - 1)
    w = 2.0 * _unit(_hash(cols ^ salt, _MIX2)) - 1.0
    scale = torch.cat([torch.full((ni,), float(p["integer_scale"])),
                       torch.full((nc,), float(p["categorical_scale"])),
                       torch.zeros(1)]).to(device=device,
                                           dtype=torch.float64)
    logit = (vals * w * scale).sum(1) + float(p["bias"])
    labels = torch.where(u[:, -1] < torch.sigmoid(logit), 1.0, -1.0)
    cols, order = torch.sort(cols, dim=1)
    vals = torch.gather(vals, 1, order)
    return cols, vals.float(), labels.float()


def local_design(cfg, seed: int, lo: int, n_local: int, device,
                 values=None) -> dict:
    """This rank's columns ``[lo, lo + n_local)`` (n_local < 2^31) of
    every row, as CSR ``(crow, col, val)`` of ``[rows, n_local]`` and its
    transpose ``(tcrow, trow, tval)`` of ``[n_local, rows]``, plus the
    labels.

    Indices are int32 while the nonzeros stay below 2^31, else int64
    (``index_dtype`` says which).  ``values(v)``, where given, replaces
    the design's values before they are stored (a control rounds them).
    The transpose is built by column ranges, each sorted stably, so that
    rows stay in order within a column and the sort's workspace stays a
    fraction of the design."""
    counts, cols, vals, labels = [], [], [], []
    for b in range(block_count(cfg)):
        c, v, y = block(cfg, seed, b, device)
        own = (c >= lo) & (c < lo + n_local)
        counts.append(own.sum(1))
        cols.append((c[own] - lo).to(torch.int32))
        vals.append(v[own])
        labels.append(y)
        del c, v, own
    counts = torch.cat(counts)
    nnz = int(counts.sum())
    idx = torch.int32 if nnz < 2 ** 31 - 1 else torch.int64
    col = torch.cat(cols).to(idx)
    del cols
    val = torch.cat(vals)
    del vals
    if values is not None:
        val = values(val)
    rows = counts.numel()
    crow = torch.zeros(rows + 1, dtype=idx, device=device)
    crow[1:] = torch.cumsum(counts, 0)
    row_of = torch.repeat_interleave(
        torch.arange(rows, dtype=idx, device=device), counts)
    del counts
    chunks = max(1, min(16, nnz // (1 << 27)))
    step = (n_local + chunks - 1) // chunks
    tcounts, trows, tvals = [], [], []
    for c0 in range(0, n_local, step):
        c1 = min(n_local, c0 + step)
        sel = ((col >= c0) & (col < c1)).nonzero().squeeze(1)
        sub = col[sel]
        _, perm = torch.sort(sub, stable=True)
        sel = sel[perm]
        tcounts.append(torch.bincount((sub - c0).long(),
                                      minlength=c1 - c0))
        trows.append(row_of[sel])
        tvals.append(val[sel])
        del sel, sub, perm
    del row_of
    tcounts = torch.cat(tcounts)
    tcrow = torch.zeros(n_local + 1, dtype=idx, device=device)
    tcrow[1:] = torch.cumsum(tcounts, 0)
    touched = int((tcounts > 0).sum())
    del tcounts
    trow = torch.cat(trows)
    del trows
    tval = torch.cat(tvals)
    del tvals
    return dict(crow=crow, col=col, val=val, tcrow=tcrow, trow=trow,
                tval=tval, labels=torch.cat(labels), rows=rows,
                n_local=n_local, nnz=nnz, touched=touched,
                index_dtype=str(idx).replace("torch.", ""))
