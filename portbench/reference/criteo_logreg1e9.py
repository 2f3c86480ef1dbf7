"""Plain reference of the split logistic regression: float64 from the rows.

It imports nothing of the port.  Every rank draws the rows again, block by
block, from the seed (:mod:`portbench.hashed_rows`, the inputs both sides
are handed), keeps its own columns, and sums across the ranks with its
own ``torch.distributed`` all-reduces, in float64.

What it judges is the solve that the window ran, at the iterate the
entry stopped at (``x_k``, at least m + 2 iterations in): from ``x_k`` and
the program's correction pairs it rebuilds the last ``K + 1`` iterates
(``x_{j} = x_{j+1} - s_j``, K the pairs held) and, in one pass over the
rows, the value and gradient at each.  The numbers:

* ``f_rel``: ``|f_prog - f| / |f|`` at ``x_k``;
* ``g_rel``: ``||g_prog - g|| / ||g||`` at ``x_k``;
* ``y_rel``: the worst pair's ``||y_j - (g_{j+1} - g_j)|| / ||g_{j+1} -
  g_j||``, the program's gradient differences against the reference's at
  the rebuilt iterates;
* ``d_rel``: ``||d_prog - d|| / ||d||``, d the textbook two-loop
  recursion (Nocedal and Wright, Algorithm 7.4, H0 = s'y / y'y) in
  float64 over the program's pairs and its gradient;
* ``f_rises_ref``: how often the reference's value rose from one rebuilt
  iterate to the next; ``f_rises``: how often the program's value rose
  from one iteration of a solve to the next, over the window and the
  steps after it;
* ``pairs_short``: m less the pairs held; ``not_finite``: 1 if a value
  of the check's steps was not finite.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from portbench import hashed_rows

F64 = torch.float64


def _allsum(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def _dot(a, b, group) -> float:
    t = torch.dot(a.to(F64), b.to(F64)).reshape(1)
    return float(_allsum(t, group)[0])


def two_loop(s, y, g, group) -> torch.Tensor:
    """``-H g`` by the two-loop recursion over the pairs ``s, y`` (oldest
    first), in float64, dots summed over the ranks."""
    q = g.to(F64).clone()
    rho = [1.0 / _dot(si, yi, group) for si, yi in zip(s, y)]
    alpha = [0.0] * len(s)
    for i in reversed(range(len(s))):
        alpha[i] = rho[i] * _dot(s[i], q, group)
        q -= alpha[i] * y[i].to(F64)
    if s:
        q *= _dot(s[-1], y[-1], group) / _dot(y[-1], y[-1], group)
    for i in range(len(s)):
        beta = rho[i] * _dot(y[i], q, group)
        q += (alpha[i] - beta) * s[i].to(F64)
    return -q


def _column_sums(col, p):
    """``(cols, sums)``: ``sums[:, i]`` is the sum of ``p[:, e]`` over the
    entries e in column ``cols[i]``, by a sort and a float64 prefix sum
    along the last axis (no atomic contention on the popular columns)."""
    srt, perm = torch.sort(col)
    cs = torch.cumsum(p[:, perm], 1)
    uniq, cnt = torch.unique_consecutive(srt, return_counts=True)
    ends = torch.cumsum(cnt, 0) - 1
    seg = cs[:, ends]
    seg[:, 1:] -= cs[:, ends[:-1]]
    return uniq, seg


# entries a step of the reference's passes, to bound its workspace
CHUNK = 1 << 24


def evaluate(cfg, seed, xs, lo, group):
    """Values ``[P]`` and gradients ``[P, n_local]`` of the objective at
    the rows of ``xs`` (``[P, n_local]`` float64, this rank's block)."""
    rows, l2 = int(cfg["rows"]), float(cfg["l2"])
    npts, n_local = xs.shape
    loss = torch.zeros(npts, dtype=F64, device=xs.device)
    grad = torch.zeros_like(xs)
    for b in range(hashed_rows.block_count(cfg)):
        c, v, lab = hashed_rows.block(cfg, seed, b, xs.device)
        own = (c >= lo) & (c < lo + n_local)
        row = own.nonzero()[:, 0]
        col = c[own] - lo
        val = v[own].to(F64)
        del c, v, own
        z = torch.zeros((npts, lab.numel()), dtype=F64, device=xs.device)
        for e in range(0, col.numel(), CHUNK):
            sl = slice(e, e + CHUNK)
            z.index_add_(1, row[sl], val[sl] * xs[:, col[sl]])
        z = _allsum(z, group).T
        t = -lab.to(F64)[:, None] * z
        loss += torch.logaddexp(torch.zeros_like(t), t).sum(0)
        dl = -lab.to(F64)[:, None] * torch.sigmoid(t) / rows
        del z, t
        dl = dl.T.contiguous()
        for e in range(0, col.numel(), CHUNK):
            sl = slice(e, e + CHUNK)
            uniq, seg = _column_sums(col[sl], val[sl] * dl[:, row[sl]])
            grad.index_add_(1, uniq, seg)
    sq = _allsum((xs * xs).sum(1), group)
    grad.add_(xs, alpha=l2)
    return loss / rows + 0.5 * l2 * sq, grad


def judge(sample, ctx) -> dict:
    cfg, group = ctx.cfg, ctx.group
    n_local = int(cfg["n"]) // int(ctx.world)
    lo = int(ctx.rank) * n_local
    s = [sample["s"][j] for j in sample["order"]]
    y = [sample["y"][j] for j in sample["order"]]
    xs = torch.empty((len(s) + 1, n_local), dtype=F64,
                     device=sample["x"].device)
    xs[-1] = sample["x"]
    for j in reversed(range(len(s))):
        torch.sub(xs[j + 1], s[j], out=xs[j])
    f, g = evaluate(cfg, ctx.seed, xs, lo, group)
    del xs

    def rel(a, b):
        num = _allsum(((a.to(F64) - b) ** 2).sum().reshape(1), group)
        den = _allsum((b * b).sum().reshape(1), group)
        return float(torch.sqrt(num / den)[0])

    y_rel = max([rel(y[j], g[j + 1] - g[j]) for j in range(len(y))],
                default=0.0)
    d = two_loop(s, y, sample["g"], group)
    fl = f.tolist()
    return dict(
        f_rel=abs(sample["fx"] - fl[-1]) / abs(fl[-1]),
        g_rel=rel(sample["g"], g[-1]),
        y_rel=y_rel,
        d_rel=rel(sample["d"], d),
        f_rises=float(sample["rises"]),
        f_rises_ref=float(sum(b > a for a, b in zip(fl, fl[1:]))),
        pairs_short=float(sample["m"] - len(s)),
        not_finite=float(not sample["finite"]),
        f=fl[-1], steps=float(sample["steps"]))
