"""The port's sortless walk Cauchy points (``gcp="walk"``,
``"walk_chunked"``, ``"walk_auto"``), unsharded, against the JAX
package's walks and the port's own reference-order ``scan``, in f64
(mirroring tests/test_cauchy_walk.py).

The batch is tests/test_torch_cauchy.py's: random boxes with infinite
bounds, tie-heavy instances (coordinates at a bound, ``lb == ub``, g = 0,
equal break points), pinned coordinates and a gradient pushing every
coordinate out, at fill levels 0 to 9 of m = 6.  Bars: the walks give the
scan's and JAX's index sets exactly, and their ``xcp`` and ``vecc`` at
rtol 1e-10 (the group form reassociates the sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgspp_tpu.ops import cauchy as jcauchy
from lbfgspp_tpu_torch.ops import cauchy as tcauchy

from test_torch_bmat import make_histories
from test_torch_cauchy import KINDS, M, N, NCORRS, as_t, box_case

WALKS = {"walk": (tcauchy.cauchy_point_walk, jcauchy.cauchy_point_walk),
         "walk_chunked": (
             lambda *a: tcauchy.cauchy_point_walk_chunked(*a, chunk=4),
             lambda *a: jcauchy.cauchy_point_walk_chunked(*a, chunk=4)),
         # routed per instance between the two above (JAX's lax.cond under
         # vmap runs both): held against the scan alone; at threshold 1
         # the batch's first instance takes the chunked walk, the others
         # the plain one
         "walk_auto": (
             lambda *a: tcauchy.cauchy_point_walk_auto(*a, threshold=1),
             None)}


@pytest.fixture(scope="module")
def case():
    th, jh, _, _ = make_histories(N, M, NCORRS, seed=42)
    rng = np.random.default_rng(11)
    cols = [box_case(N, rng, kind) for kind in KINDS]
    x0, g, lb, ub = (np.stack(c) for c in zip(*cols))
    return th, jh, x0, g, lb, ub


def assert_same_gcp(got, want, b=None, rtol=1e-10):
    pick = (lambda t: t[b]) if b is not None else (lambda t: t)
    np.testing.assert_array_equal(got.newact_mask.numpy(),
                                  np.asarray(pick(want.newact_mask)))
    np.testing.assert_array_equal(got.free_mask.numpy(),
                                  np.asarray(pick(want.free_mask)))
    np.testing.assert_allclose(got.xcp.numpy(), np.asarray(pick(want.xcp)),
                               rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got.vecc.numpy(), np.asarray(pick(want.vecc)),
                               rtol=rtol, atol=rtol)


def one(res, b):
    return tcauchy.CauchyResult(*(t[b] for t in res))


@pytest.mark.parametrize("name", list(WALKS))
def test_walk_matches_scan_and_jax(case, name):
    """Every instance of the batch (N = 15 is no multiple of the chunk
    of 4): the port's batched walk against the port's scan and against
    the JAX walk vmapped over the same histories."""
    th, jh, x0, g, lb, ub = case
    ours, theirs = WALKS[name]
    args = as_t(x0, g, lb, ub)
    res = ours(th, *args)
    scan = tcauchy.cauchy_point(th, *args)
    for b in range(len(NCORRS)):
        assert_same_gcp(one(res, b), one(scan, b))
    if theirs is not None:
        hist = jax.tree.map(lambda *leaves: jnp.stack(leaves), *jh)
        want = jax.vmap(theirs)(hist, *(jnp.asarray(a)
                                        for a in (x0, g, lb, ub)))
        for b in range(len(NCORRS)):
            assert_same_gcp(one(res, b), want, b)
    if name == "walk_auto":
        w = tcauchy._walk_start(th, *args, None)
        dt1 = torch.clamp(-w.fp / torch.where(w.fpp > 0, w.fpp, 1.0), min=0)
        est = (w.participates & (w.brk <= dt1[:, None])).sum(1)
        assert 0 < int((est >= 1).sum()) < len(NCORRS)   # both routes


def test_walk_trip_count_is_the_distinct_break_points():
    """One instance, no history, every coordinate with its own break point
    and a gradient pushing all out of the box: the walk crosses each
    value (the last round stops there, the minimizer on the segment), so
    it takes n rounds; with all break points equal, one round crosses the
    group and one more finds none left.  Both as the scan."""
    n = 9
    th, _, _, _ = make_histories(n, M, (0,), seed=1, with_jax=False)
    x0 = np.zeros((1, n))
    lb, ub = -np.ones((1, n)), np.ones((1, n))
    for g, rounds in ((np.arange(1.0, n + 1)[None], n),
                      (np.ones((1, n)), 2)):
        tcauchy.WALK_COUNTS.clear()
        res = tcauchy.cauchy_point_walk(th, *as_t(x0, g, lb, ub))
        assert tcauchy.WALK_COUNTS["rounds"] == rounds
        assert_same_gcp(res, tcauchy.cauchy_point(th, *as_t(x0, g, lb, ub)))
        np.testing.assert_allclose(res.xcp.numpy(), -np.ones((1, n)),
                                   rtol=0, atol=1e-13)
