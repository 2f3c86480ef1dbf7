"""The generalized Cauchy point (GCP) of L-BFGS-B, batched.

The port's counterpart of ``lbfgspp_tpu.ops.cauchy`` (LBFGS++'s
``Cauchy``, Cauchy.h:86-284).  The reference walks the coordinates'
break points in sorted order with data-dependent index sets; here the sets
are ``[B, n]`` boolean masks and every instance of the batch walks at once:

* :func:`cauchy_point` (``gcp="scan"``) is the reference-order walk: a
  stable argsort of the break points, then a loop over sorted positions
  with a per-instance stop flag (the JAX package's ``lax.scan``), one
  coordinate a step, which ends when every instance has stopped or run
  out of break points;
* :func:`cauchy_point_prefix` (``gcp="prefix"``) re-expresses the walk's
  no-stop trajectory as prefix sums and picks each instance's first stop
  at once: the same index sets, sums reassociated.  Sorted order comes
  from a stable argsort and row gathers (``perm="sort"``, the default
  here: batched gathers are cheap on the card) or from the JAX package's
  comparison counts and one-hot products (``perm="onehot"``); both give
  the same sorted rows, so the same result.

Ties are common (coordinates at a bound break at t=0, free ones with g=0
never break), and the stable sorts keep tied coordinates in index order,
as ``jnp.argsort`` does, so the walks visit them in the same order.

The sortless walks (``walk``, ``walk_chunked``, ``walk_auto``) never
sort: each round crosses the next break-point value's whole tie group,
so they serve feature-split solves, where every reduction is one
all-reduce over the group (``group``), and single solves alike.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from . import bmat
from .fused import _matvec
from ..parallel import collectives as coll
from ..types import tree_map

Tensor = torch.Tensor

# Target element count of one [B-instance, chunk, n] tile of the one-hot
# permutation (lbfgspp_tpu/ops/cauchy.py:227-230).
_PERM_TILE = 16384


class CauchyResult(NamedTuple):
    """The GCP of every instance (Cauchy::get_cauchy_point's out-params,
    Cauchy.h:86-88), index sets as masks."""

    xcp: Tensor          # [B, n] generalized Cauchy point
    vecc: Tensor         # [B, 2m] c = W'(xcp - x0), slot layout
    newact_mask: Tensor  # [B, n] coordinates that became active
    free_mask: Tensor    # [B, n] free-variable set


def _break_points(x0: Tensor, g: Tensor, lb: Tensor, ub: Tensor):
    """Break points, first direction and participation masks
    (Cauchy.h:111-129), with ``lb == ub -> brk = 0`` (Cauchy.h:113-114)."""
    inf = math.inf
    pinned = lb == ub
    brk = torch.where(pinned, 0.0,
                      torch.where(g < 0.0, (x0 - ub) / g,
                                  torch.where(g > 0.0, (x0 - lb) / g, inf)))
    iszero = brk == 0.0
    vecd = torch.where(iszero, 0.0, -g)
    free0 = brk == inf
    participates = (~free0) & (~iszero)
    return brk, vecd, free0, participates


def _finish(x0, vecd, lb, ub, free0, participates, crossed, crossed_all,
            t_last, fp, fpp, vecc_l, vecp_l) -> CauchyResult:
    """The ``fpp ~ 0`` rescue (Cauchy.h:258-262) and the free variables'
    final extension (Cauchy.h:264-282); per-instance scalars are [B]."""
    eps = torch.finfo(x0.dtype).eps
    deltatmin = torch.where(fpp < eps, -fp / eps, -fp / fpp)
    deltatmin = torch.clamp(deltatmin, min=0.0)
    tfinal = t_last + deltatmin
    vecc = torch.where(crossed_all[:, None], vecc_l,
                       vecc_l + deltatmin[:, None] * vecp_l)
    free_mask = free0 | (participates & (~crossed))
    xcp = torch.where(crossed, torch.where(vecd > 0.0, ub, lb), x0)
    extend = free_mask & (~crossed_all[:, None])
    xcp = torch.where(extend, x0 + tfinal[:, None] * vecd, xcp)
    return CauchyResult(xcp=xcp, vecc=vecc, newact_mask=crossed,
                        free_mask=free_mask)


def _start(bh: bmat.BHistory, vecd: Tensor):
    """``(vecp, fp, fpp)`` at t = 0 (Cauchy.h:150-161)."""
    vecp = bmat.apply_wtv(bh, vecd)
    fp = -(vecd * vecd).sum(dim=1)
    fpp = -bh.theta * fp - (vecp * bmat.apply_mv(bh, vecp)).sum(dim=1)
    return vecp, fp, fpp


def cauchy_point(bh: bmat.BHistory, x0: Tensor, g: Tensor, lb: Tensor,
                 ub: Tensor) -> CauchyResult:
    """The GCP by the reference-order walk (Cauchy.h:86-284;
    lbfgspp_tpu/ops/cauchy.py:103-216).

    Sorted position t is one step of the JAX package's scan for the whole
    batch: a tie group's members see ``deltat == 0``, so the stop test
    fires only on a group's first member, as the reference's grouped walk
    does.  The loop ends when every instance has stopped or crossed all
    its break points; the steps it skips would change nothing."""
    batch, n = x0.shape
    m = bh.m
    theta = bh.theta
    brk, vecd, free0, participates = _break_points(x0, g, lb, ub)
    nord = participates.sum(dim=1)

    key = torch.where(participates, brk, math.inf)
    order = torch.argsort(key, dim=1, stable=True)
    brk_o = key.gather(1, order)
    g_o = g.gather(1, order)
    z_o = (torch.where(vecd > 0.0, ub, lb) - x0).gather(1, order)
    w_o = bmat.w_columns(bh, order)                      # [B, n, 2m]

    vecp, fp, fpp = _start(bh, vecd)
    vecc = torch.zeros(batch, 2 * m, dtype=x0.dtype, device=x0.device)
    il = torch.zeros_like(fp)
    stopped = torch.zeros(batch, dtype=torch.bool, device=x0.device)
    crossed_o = torch.zeros(batch, n, dtype=torch.bool, device=x0.device)
    mdense = bh.mdense
    for t in range(n):
        if not bool((~stopped & (nord > t)).any()):
            break
        brk_t, g_t, z_t, w_t = brk_o[:, t], g_o[:, t], z_o[:, t], w_o[:, t]
        valid_t = nord > t
        deltat = brk_t - il
        deltatmin = -fp / fpp
        stop_now = valid_t & (~stopped) & (deltat > 0.0) & \
            (deltatmin < deltat)
        cross = valid_t & (~stopped) & (~stop_now)
        # select, never multiply by a mask: tail rows carry inf
        dt_c = torch.where(cross, deltat, 0.0)
        vecc = vecc + dt_c[:, None] * vecp
        fp = fp + dt_c * fpp
        # the per-coordinate updates (Cauchy.h:219-234)
        cache = _matvec(mdense, w_t)                     # M w
        gg = g_t * g_t
        fp = fp + torch.where(
            cross, gg + theta * g_t * z_t - g_t * (cache * vecc).sum(dim=1),
            0.0)
        fpp = fpp - torch.where(
            cross, theta * gg + 2.0 * g_t * (cache * vecp).sum(dim=1) +
            gg * (cache * w_t).sum(dim=1), 0.0)
        vecp = vecp + torch.where(cross, g_t, 0.0)[:, None] * w_t
        il = torch.where(cross, brk_t, il)
        stopped = stopped | stop_now
        crossed_o[:, t] = cross

    crossed = torch.zeros_like(crossed_o).scatter(1, order, crossed_o)
    crossed_all = (free0.sum(dim=1) == 0) & (crossed.sum(dim=1) == nord)
    return _finish(x0, vecd, lb, ub, free0, participates, crossed,
                   crossed_all, il, fp, fpp, vecc, vecp)


def _sorted_rows(key: Tensor, vals: Tensor, perm: str):
    """``(vals_s, rank)``: the rows of ``vals [B, n, K]`` in stable key
    order, and each coordinate's sorted position."""
    batch, n = key.shape
    dev = key.device
    idx = torch.arange(n, device=dev)
    if perm == "sort":
        order = torch.argsort(key, dim=1, stable=True)
        vals_s = vals.gather(1, order[:, :, None].expand_as(vals))
        rank = torch.empty_like(order).scatter_(
            1, order, idx.expand(batch, n))
        return vals_s, rank
    if perm != "onehot":
        raise ValueError(f"perm must be 'onehot' or 'sort', got {perm!r}")
    # Stable ranks by comparison counts, then one-hot products, in tiles
    # of c sorted positions (lbfgspp_tpu/ops/cauchy.py:315-348).
    c = max(1, min(n, _PERM_TILE // max(n, 1)))
    ranks = []
    for lo in range(0, n, c):
        kc = key[:, lo:lo + c]
        ic = idx[lo:lo + c]
        before = (key[:, None, :] < kc[:, :, None]) | \
            ((key[:, None, :] == kc[:, :, None]) &
             (idx[None, None, :] < ic[None, :, None]))
        ranks.append(before.sum(dim=2))
    rank = torch.cat(ranks, dim=1)
    tiles = []
    for lo in range(0, n, c):
        oh = (rank[:, None, :] == idx[lo:lo + c][None, :, None]).to(
            vals.dtype)
        tiles.append(oh @ vals)
    return torch.cat(tiles, dim=1), rank


def cauchy_point_prefix(bh: bmat.BHistory, x0: Tensor, g: Tensor,
                        lb: Tensor, ub: Tensor,
                        perm: str = "sort") -> CauchyResult:
    """The GCP with the walk's trajectory as prefix sums
    (lbfgspp_tpu/ops/cauchy.py:233-368).

    With ``u_i = M w_i`` and the running sums ``cumP = cumsum(g_i w_i)``
    and ``cumPT = cumsum(g_i t_i w_i)`` over sorted positions, ``fpp_j``
    and ``fp_j`` after each crossing are prefix sums, so the stop test is
    evaluated at every position at once and the first position where it
    fires selects the state, as the sequential walk would.  ``perm``
    chooses how rows reach sorted order (see the module docstring); the
    result does not depend on it."""
    batch, n = x0.shape
    m = bh.m
    dtype, dev = x0.dtype, x0.device
    theta = bh.theta[:, None]
    brk, vecd, free0, participates = _break_points(x0, g, lb, ub)
    nord = participates.sum(dim=1)

    key = torch.where(participates, brk, math.inf)
    bound = torch.where(vecd > 0.0, ub, lb)
    vals = torch.cat([
        torch.where(participates, brk, 0.0)[:, :, None],
        torch.where(participates, g, 0.0)[:, :, None],
        torch.where(participates, bound - x0, 0.0)[:, :, None],
        bmat.w_rows(bh)], dim=2)                         # [B, n, 2m+3]
    vals_s, rank = _sorted_rows(key, vals, perm)
    idx = torch.arange(n, device=dev)
    valid = idx[None, :] < nord[:, None]
    t_s = vals_s[:, :, 0]
    g_s = vals_s[:, :, 1]
    z_s = vals_s[:, :, 2]
    w_s = vals_s[:, :, 3:]       # rows past nord carry g = 0

    vecp0, fp0, fpp0 = _start(bh, vecd)
    u_s = w_s @ bh.mdense                                # rows M w_i
    kdiag = (u_s * w_s).sum(dim=2)

    def shifted(a, first):
        """``a`` moved one position later along axis 1, ``first`` in
        front."""
        return torch.cat([first, a[:, :-1]], dim=1)

    gg = g_s * g_s
    gw = g_s[:, :, None] * w_s
    cum_p = torch.cumsum(gw, dim=1)
    cum_pt = torch.cumsum(t_s[:, :, None] * gw, dim=1)
    zero_row = torch.zeros(batch, 1, 2 * m, dtype=dtype, device=dev)
    a_vec = (u_s * shifted(cum_p, zero_row)).sum(dim=2)
    b_vec = (u_s * shifted(cum_pt, zero_row)).sum(dim=2)
    uv0 = _matvec(u_s, vecp0)

    dec = theta * gg + 2.0 * g_s * (uv0 + a_vec) + gg * kdiag
    fpp_pref = fpp0[:, None] - torch.cumsum(dec, dim=1)
    fpp_prev = shifted(fpp_pref, fpp0[:, None])
    t_prev = shifted(t_s, torch.zeros(batch, 1, dtype=dtype, device=dev))
    dt = torch.where(valid, t_s - t_prev, 0.0)
    ucj = t_s * (uv0 + a_vec) - b_vec
    per = torch.where(valid, gg + theta * g_s * z_s - g_s * ucj, 0.0)
    fp_pref = fp0[:, None] + torch.cumsum(dt * fpp_prev, dim=1) + \
        torch.cumsum(per, dim=1)
    fp_prev = shifted(fp_pref, fp0[:, None])

    stop = valid & (dt > 0.0) & (-fp_prev / fpp_prev < dt)
    any_stop = stop.any(dim=1)
    jstar = torch.argmax(stop.to(torch.int8), dim=1)     # the first stop
    ncross = torch.where(any_stop, jstar, nord)
    crossed = rank < ncross[:, None]
    crossed_all = (free0.sum(dim=1) == 0) & (crossed.sum(dim=1) == nord)

    # The state after the last crossed position, ncross - 1 (none: the
    # start's).
    none = ncross == 0
    last = torch.clamp(ncross - 1, min=0)
    at_last = last[:, None]
    fp = torch.where(none, fp0, fp_pref.gather(1, at_last)[:, 0])
    fpp = torch.where(none, fpp0, fpp_pref.gather(1, at_last)[:, 0])
    il = torch.where(none, 0.0, t_s.gather(1, at_last)[:, 0])
    rows_last = at_last[:, :, None].expand(-1, 1, 2 * m)
    cum_p_last = torch.where(none[:, None], 0.0,
                             cum_p.gather(1, rows_last)[:, 0])
    cum_pt_last = torch.where(none[:, None], 0.0,
                              cum_pt.gather(1, rows_last)[:, 0])
    vecp_l = vecp0 + cum_p_last
    vecc_l = il[:, None] * vecp0 + il[:, None] * cum_p_last - cum_pt_last
    return _finish(x0, vecd, lb, ub, free0, participates, crossed,
                   crossed_all, il, fp, fpp, vecc_l, vecp_l)


def cauchy_point_prefix_sorted(bh: bmat.BHistory, x0: Tensor, g: Tensor,
                               lb: Tensor, ub: Tensor) -> CauchyResult:
    """:func:`cauchy_point_prefix` with the argsort permutation
    (lbfgspp_tpu/ops/cauchy.py:656-664)."""
    return cauchy_point_prefix(bh, x0, g, lb, ub, perm="sort")


class _Walk(NamedTuple):
    """A sortless walk's data and carry, per instance: the break points
    and masks of :func:`_break_points`, ``z = bound - x0`` on the
    participating coordinates, and the walk state."""

    brk: Tensor           # [B, n]
    vecd: Tensor          # [B, n]
    free0: Tensor         # [B, n]
    participates: Tensor  # [B, n]
    z: Tensor             # [B, n]
    nord: Tensor          # [B] int64, participating coordinates (global)
    nfree0: Tensor        # [B] int64, never-breaking coordinates (global)
    t: Tensor             # [B] last crossed break-point value
    fp: Tensor            # [B]
    fpp: Tensor           # [B]
    vecp: Tensor          # [B, 2m]
    vecc: Tensor          # [B, 2m]
    crossed: Tensor       # [B, n] bool
    stopped: Tensor       # [B] bool
    rounds: Tensor        # [B] int64, rounds taken (trip-count bound)


def _walk_start(bh: bmat.BHistory, x0: Tensor, g: Tensor, lb: Tensor,
                ub: Tensor, group) -> _Walk:
    """The walk's start (Cauchy.h:111-161): ``vecp = W'd``, ``fp =
    -d.d`` in one all-reduce and the two counts in another."""
    m = bh.m
    brk, vecd, free0, participates = _break_points(x0, g, lb, ub)
    yv, sv = _matvec(bh.base.y, vecd), _matvec(bh.base.s, vecd)
    dd = (vecd * vecd).sum(dim=1)
    counts = torch.stack([participates.sum(dim=1), free0.sum(dim=1)], 1)
    if group is not None:
        yv, sv, dd = coll.pfused([yv, sv, dd], group, "cauchy.walk_start")
        counts = coll.psum(counts, group, "cauchy.walk_counts")
    vecp = torch.cat([yv, sv * bh.theta[:, None]], dim=1)
    fp = -dd
    fpp = -bh.theta * fp - (vecp * bmat.apply_mv(bh, vecp)).sum(dim=1)
    bound = torch.where(vecd > 0.0, ub, lb)
    batch = x0.shape[0]
    zeros = torch.zeros(batch, dtype=torch.int64, device=x0.device)
    return _Walk(
        brk=brk, vecd=vecd, free0=free0, participates=participates,
        z=torch.where(participates, bound - x0, 0.0),
        nord=counts[:, 0], nfree0=counts[:, 1],
        t=torch.zeros_like(fp), fp=fp, fpp=fpp, vecp=vecp,
        vecc=torch.zeros(batch, 2 * m, dtype=x0.dtype, device=x0.device),
        crossed=torch.zeros_like(participates),
        stopped=torch.zeros_like(participates[:, 0]), rounds=zeros)


def _walk_step(w: _Walk, bh: bmat.BHistory, tk: Tensor, gvec: Tensor,
               sum_gg: Tensor, sum_gz: Tensor, live: Tensor):
    """One break-point value ``tk`` crossed by its whole tie group, in the
    order-free group form (lbfgspp_tpu/ops/cauchy.py:448-467): ``gvec =
    W'g`` over the group, W-scaled.  Returns the new ``(t, fp, fpp, vecp,
    vecc)``, the per-instance stop test and the advance mask ``live &
    ~stop``."""
    theta = bh.theta
    deltat = tk - w.t
    # First-member stop test; tk == inf means every participating
    # coordinate is crossed (and keeps a NaN from walking on).
    stop_now = ((-w.fp / w.fpp) < deltat) | (tk == math.inf)
    mg = bmat.apply_mv(bh, gvec)
    vecc_new = w.vecc + deltat[:, None] * w.vecp
    fp_new = w.fp + deltat * w.fpp + sum_gg + theta * sum_gz - \
        (mg * vecc_new).sum(dim=1)
    fpp_new = w.fpp - theta * sum_gg - 2.0 * (mg * w.vecp).sum(dim=1) - \
        (mg * gvec).sum(dim=1)
    adv = live & ~stop_now
    a1 = adv[:, None]
    return (torch.where(adv, tk, w.t), torch.where(adv, fp_new, w.fp),
            torch.where(adv, fpp_new, w.fpp),
            torch.where(a1, w.vecp + gvec, w.vecp),
            torch.where(a1, vecc_new, w.vecc)), stop_now, adv


def _walk_finish(w: _Walk, x0: Tensor, lb: Tensor, ub: Tensor,
                 group) -> CauchyResult:
    ncrossed = coll.psum(w.crossed.sum(dim=1), group, "cauchy.walk_end")
    crossed_all = (w.nfree0 == 0) & (ncrossed == w.nord)
    return _finish(x0, w.vecd, lb, ub, w.free0, w.participates, w.crossed,
                   crossed_all, w.t, w.fp, w.fpp, w.vecc, w.vecp)


def _lockstep(w: _Walk, round_fn) -> _Walk:
    """Rounds for the batch until every instance has stopped or taken
    ``nord`` rounds (each live round crosses at least one participating
    coordinate, so ``nord`` bounds the trip count); the flags are
    replicated, so every rank leaves the loop together.  Counts the
    rounds in :data:`WALK_COUNTS`."""
    while True:
        live = (~w.stopped) & (w.rounds < w.nord)
        if not bool(live.any()):
            return w
        WALK_COUNTS["rounds"] += 1
        w = round_fn(w, live)


#: Lockstep rounds of the sortless walks since the last ``clear()``.
WALK_COUNTS: collections.Counter = collections.Counter()


def cauchy_point_walk(bh: bmat.BHistory, x0: Tensor, g: Tensor,
                      lb: Tensor, ub: Tensor, group=None) -> CauchyResult:
    """The GCP as a sortless segment walk (lbfgspp_tpu/ops/cauchy.py:
    382-497), batched and lockstep: the feature-split GCP.

    Each round advances to the next break-point value ``t = min(remaining
    brk)`` (one all-reduce MIN under a group) and crosses its whole tie
    group at once with the order-free closed forms (``G = W'g`` over the
    group, one all-reduce of ``[G; sum gg; sum gz]``).  Tie members see
    ``deltat == 0``, so the stop test fires only on a group's first
    value, as in the reference (Cauchy.h:193-256).  An instance's trip
    count is the number of distinct break points it crosses; the batch
    runs to its slowest instance.  Works with ``group=None`` too."""
    m = bh.m
    w = _walk_start(bh, x0, g, lb, ub, group)

    def one_round(w: _Walk, live: Tensor) -> _Walk:
        remaining = w.participates & (~w.crossed)
        tnext = coll.pmin(torch.where(remaining, w.brk, math.inf)
                          .amin(dim=1), group, "cauchy.walk_next")
        grp = remaining & (w.brk == tnext[:, None])
        gv = torch.where(grp, g, 0.0)
        loc = torch.cat([_matvec(bh.base.y, gv), _matvec(bh.base.s, gv),
                         (gv * gv).sum(dim=1, keepdim=True),
                         (gv * w.z).sum(dim=1, keepdim=True)], dim=1)
        red = coll.psum(loc, group, "cauchy.walk_group")
        gvec = torch.cat([red[:, :m], red[:, m:2 * m] * bh.theta[:, None]],
                         dim=1)
        (t, fp, fpp, vecp, vecc), stop_now, adv = _walk_step(
            w, bh, tnext, gvec, red[:, 2 * m], red[:, 2 * m + 1], live)
        return w._replace(
            t=t, fp=fp, fpp=fpp, vecp=vecp, vecc=vecc,
            crossed=w.crossed | (grp & adv[:, None]),
            stopped=torch.where(live, stop_now, w.stopped),
            rounds=w.rounds + live.to(w.rounds.dtype))

    return _walk_finish(_lockstep(w, one_round), x0, lb, ub, group)


def cauchy_point_walk_chunked(bh: bmat.BHistory, x0: Tensor, g: Tensor,
                              lb: Tensor, ub: Tensor, group=None,
                              chunk: int = 64) -> CauchyResult:
    """The segment walk advancing up to ``chunk`` break-point values a
    round (lbfgspp_tpu/ops/cauchy.py:499-654), batched and lockstep.

    Per round: each rank's ``K`` smallest remaining break points, gathered
    and merged into the ``K`` globally smallest; ONE all-reduce of the
    per-value group sums ``[K, 2m+2]`` (membership by first occurrence,
    so duplicate candidates are empty zero-width steps; found by binary
    search and summed by scatter-add, O(n) a round where the JAX
    package's one-hot product is O(nK)); then a replicated K-step scan of
    the walk recurrence with the stop test per value.  The same GCP as
    :func:`cauchy_point_walk` up to the summation order."""
    m = bh.m
    batch, n = x0.shape
    k_ = min(chunk, n)
    w = _walk_start(bh, x0, g, lb, ub, group)
    # Per-coordinate rows [B, n, 2m+2]: g y | g s | g^2 | g z (the s block
    # is theta-scaled after the all-reduce, as in the plain walk).
    v_rows = torch.cat([(bh.base.y * g[:, None, :]).transpose(1, 2),
                        (bh.base.s * g[:, None, :]).transpose(1, 2),
                        (g * g)[:, :, None], (g * w.z)[:, :, None]], dim=2)

    def one_round(w: _Walk, live: Tensor) -> _Walk:
        remaining = w.participates & (~w.crossed)
        loc = torch.where(remaining, w.brk, math.inf)
        ts_local = torch.topk(loc, k_, dim=1, largest=False,
                              sorted=True).values
        # every rank's candidates side by side, [B, world*K]
        world = 1 if group is None else dist.get_world_size(group)
        cands = coll.gather_rows(ts_local[None], world, group,
                                 "cauchy.walk_gather")
        ts = torch.sort(cands.permute(1, 0, 2).reshape(batch, -1),
                        dim=1).values[:, :k_]
        # Each remaining coordinate joins the first candidate equal to its
        # break point (a duplicate candidate stays empty): the sorted
        # position from a binary search, the sums by scatter-add into a
        # row per candidate and one spare row for the others.
        pos = torch.searchsorted(ts, w.brk)
        hit = remaining & (pos < k_) & \
            (ts.gather(1, pos.clamp(max=k_ - 1)) == w.brk)
        rows = torch.where(hit, pos, k_)[:, :, None].expand_as(v_rows)
        sums = v_rows.new_zeros(batch, k_ + 1, 2 * m + 2).scatter_add_(
            1, rows, v_rows)[:, :k_]
        red = coll.psum(sums, group, "cauchy.walk_group")
        gvecs = torch.cat([red[:, :, :m],
                           red[:, :, m:2 * m] * bh.theta[:, None, None]],
                          dim=2)
        stopped = torch.zeros_like(live)
        for j in range(k_):
            (t, fp, fpp, vecp, vecc), stop_now, _ = _walk_step(
                w, bh, ts[:, j], gvecs[:, j], red[:, j, 2 * m],
                red[:, j, 2 * m + 1], live & ~stopped)
            w = w._replace(t=t, fp=fp, fpp=fpp, vecp=vecp, vecc=vecc)
            stopped = stopped | stop_now
        # Everything at or below the reached value is crossed; values
        # beyond the stop stay remaining.
        crossed = w.crossed | (remaining & (w.brk <= w.t[:, None]) &
                               live[:, None])
        return w._replace(crossed=crossed,
                          stopped=torch.where(live, stopped, w.stopped),
                          rounds=w.rounds + live.to(w.rounds.dtype))

    return _walk_finish(_lockstep(w, one_round), x0, lb, ub, group)


def cauchy_point_walk_auto(bh: bmat.BHistory, x0: Tensor, g: Tensor,
                           lb: Tensor, ub: Tensor, group=None,
                           threshold: int = 16,
                           chunk: int = 64) -> CauchyResult:
    """The walk routed per instance (lbfgspp_tpu/ops/cauchy.py:667-714):
    the chunked walk where the estimated crossing count ``#(brk <= dt1)``,
    ``dt1 = -fp'/fp''`` of the first segment, reaches ``threshold`` (a
    cold interior start), the plain walk elsewhere (an endgame iteration
    near its active set).  The estimate takes the start's all-reduces and
    one more; the two routes then run on their own instances, which every
    rank selects alike from the replicated counts."""
    w = _walk_start(bh, x0, g, lb, ub, group)
    fpp_safe = torch.where(w.fpp > 0, w.fpp, 1.0)
    dt1 = torch.clamp(-w.fp / fpp_safe, min=0.0)
    c_est = coll.psum((w.participates & (w.brk <= dt1[:, None])).sum(dim=1),
                      group, "cauchy.walk_estimate")
    chunked = c_est >= threshold
    if bool(chunked.all()):
        return cauchy_point_walk_chunked(bh, x0, g, lb, ub, group, chunk)
    if not bool(chunked.any()):
        return cauchy_point_walk(bh, x0, g, lb, ub, group)
    parts = []
    for sel, fn in ((chunked, functools.partial(cauchy_point_walk_chunked,
                                                chunk=chunk)),
                    (~chunked, cauchy_point_walk)):
        idx = sel.nonzero()[:, 0]
        pick = functools.partial(torch.index_select, dim=0, index=idx)
        parts.append((idx, fn(tree_map(pick, bh), pick(x0), pick(g),
                              pick(lb), pick(ub), group)))
    (i1, r1), (i2, r2) = parts
    order = torch.argsort(torch.cat([i1, i2]))
    return tree_map(lambda a, b: torch.cat([a, b])[order], r1, r2)


GCP_IMPLS = {"scan": cauchy_point, "prefix": cauchy_point_prefix,
             "prefix_sorted": cauchy_point_prefix_sorted,
             "walk": cauchy_point_walk,
             "walk_chunked": cauchy_point_walk_chunked,
             "walk_auto": cauchy_point_walk_auto}
