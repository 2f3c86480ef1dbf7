"""The port's generalized Cauchy point (lbfgspp_tpu_torch.ops.cauchy)
against the NumPy index-set oracle (tests/oracle_b.py) and the JAX
package's, in f64.

Each batch mixes instances of different kinds and fill levels: random
boxes with infinite bounds, tie-heavy ones (coordinates at their bounds,
``lb == ub``, ``g = 0``, equal break points), one whose gradient pushes
every coordinate out of the box.  Bars: the reference-order walk
(``gcp="scan"``) gives the oracle's index sets and ``xcp`` at rtol 1e-12;
the prefix forms give the JAX package's and the walk's index sets, and
their ``xcp`` and ``vecc`` at rtol 1e-10; the two permutations of the
prefix form give the same result bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgspp_tpu.ops import cauchy as jcauchy
from lbfgspp_tpu_torch.ops import cauchy as tcauchy
from oracle_b import cauchy_point as oracle_cauchy

from test_torch_bmat import make_histories

N, M = 15, 6
KINDS = ("random", "ties", "pinned", "zero_g", "outward", "random")
NCORRS = (0, 2, 6, 9, 3, 7)


def box_case(n, rng, kind):
    """``(x0, g, lb, ub)`` of one instance."""
    lb = rng.standard_normal(n) - 2.0
    ub = lb + 1.0 + 2.0 * rng.random(n)
    which = rng.random(n)
    lb = np.where(which < 0.1, -np.inf, lb)
    ub = np.where(which > 0.9, np.inf, ub)
    x0 = np.clip(rng.standard_normal(n), lb, ub)
    g = rng.standard_normal(n)
    if kind == "ties":
        at_lo = rng.random(n) < 0.3
        x0 = np.where(at_lo & np.isfinite(lb), lb, x0)
        g = np.where(at_lo, np.abs(g), g)          # pushes out: brk = 0
        same = rng.random(n) < 0.4                 # equal break points
        lb = np.where(same, -3.0, lb)
        x0 = np.where(same, -2.5, x0)
        ub = np.where(same, np.maximum(ub, 1.0), ub)
        g = np.where(same, 1.0, g)
        g = np.where(rng.random(n) < 0.15, 0.0, g)
    elif kind == "pinned":
        pin = rng.random(n) < 0.4
        mid = np.where(np.isfinite(lb), lb + 0.5, 0.0)
        lb = np.where(pin, mid, lb)
        ub = np.where(pin, mid, ub)
        x0 = np.clip(x0, lb, ub)
    elif kind == "zero_g":
        g = np.where(rng.random(n) < 0.5, 0.0, g)
    elif kind == "outward":
        lb, ub = np.zeros(n), np.ones(n)
        x0 = np.where(rng.random(n) < 0.5, 0.0, 1.0)
        g = np.where(x0 == 0.0, 1.0, -1.0)
    return x0, g, lb, ub


@pytest.fixture(scope="module")
def case():
    th, jh, oh, _ = make_histories(N, M, NCORRS, seed=42)
    rng = np.random.default_rng(5)
    cols = [box_case(N, rng, kind) for kind in KINDS]
    x0, g, lb, ub = (np.stack(c) for c in zip(*cols))
    return th, jh, oh, x0, g, lb, ub


def as_t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def compact(v2m, ncorr):
    c = min(ncorr, M)
    return np.concatenate([v2m[:c], v2m[M:M + c]])


def sets(res, b):
    return (set(np.flatnonzero(res.newact_mask[b].numpy())),
            set(np.flatnonzero(res.free_mask[b].numpy())))


def test_scan_matches_oracle(case):
    th, jh, oh, x0, g, lb, ub = case
    res = tcauchy.cauchy_point(th, *as_t(x0, g, lb, ub))
    for b, o in enumerate(oh):
        xcp, vecc, newact, free = oracle_cauchy(o, x0[b], g[b], lb[b], ub[b])
        assert sets(res, b) == (set(newact), set(free))
        np.testing.assert_allclose(res.xcp[b].numpy(), xcp, rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(compact(res.vecc[b].numpy(), NCORRS[b]),
                                   vecc, rtol=1e-9, atol=1e-10)


def test_scan_matches_jax(case):
    th, jh, oh, x0, g, lb, ub = case
    res = tcauchy.cauchy_point(th, *as_t(x0, g, lb, ub))
    for b, h in enumerate(jh):
        want = jcauchy.cauchy_point(h, *(jnp.asarray(a[b])
                                         for a in (x0, g, lb, ub)))
        np.testing.assert_array_equal(res.newact_mask[b].numpy(),
                                      np.asarray(want.newact_mask))
        np.testing.assert_array_equal(res.free_mask[b].numpy(),
                                      np.asarray(want.free_mask))
        np.testing.assert_allclose(res.xcp[b].numpy(), np.asarray(want.xcp),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(res.vecc[b].numpy(),
                                   np.asarray(want.vecc), rtol=1e-12,
                                   atol=1e-13)


PREFIX = {"prefix onehot": lambda *a: tcauchy.cauchy_point_prefix(
              *a, perm="onehot"),
          "prefix sort": lambda *a: tcauchy.cauchy_point_prefix(
              *a, perm="sort"),
          "prefix_sorted": tcauchy.cauchy_point_prefix_sorted}


@pytest.mark.parametrize("label", list(PREFIX))
def test_prefix_matches_jax_and_scan(case, label):
    th, jh, oh, x0, g, lb, ub = case
    args = as_t(x0, g, lb, ub)
    res = PREFIX[label](th, *args)
    scan = tcauchy.cauchy_point(th, *args)
    for b, h in enumerate(jh):
        want = jcauchy.cauchy_point_prefix(h, *(jnp.asarray(a[b])
                                                for a in (x0, g, lb, ub)))
        for other in (want, tcauchy.CauchyResult(*(t[b] for t in scan))):
            np.testing.assert_array_equal(res.newact_mask[b].numpy(),
                                          np.asarray(other.newact_mask))
            np.testing.assert_array_equal(res.free_mask[b].numpy(),
                                          np.asarray(other.free_mask))
            np.testing.assert_allclose(res.xcp[b].numpy(),
                                       np.asarray(other.xcp), rtol=1e-10,
                                       atol=1e-12)
            np.testing.assert_allclose(res.vecc[b].numpy(),
                                       np.asarray(other.vecc), rtol=1e-10,
                                       atol=1e-11)


def test_prefix_permutations_agree_bit_for_bit(case):
    """The card's route (``perm="sort"``) and the JAX package's default
    (``perm="onehot"``) put the same rows in the same order."""
    th, jh, oh, x0, g, lb, ub = case
    args = as_t(x0, g, lb, ub)
    a = tcauchy.cauchy_point_prefix(th, *args, perm="onehot")
    b = tcauchy.cauchy_point_prefix(th, *args, perm="sort")
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_outward_instance_crosses_nothing(case):
    """Every coordinate at a bound with the gradient pushing out: all
    break points are 0, nothing is crossed or free, xcp = x0
    (Cauchy.h:140-145)."""
    th, jh, oh, x0, g, lb, ub = case
    b = KINDS.index("outward")
    for fn in (tcauchy.cauchy_point, tcauchy.cauchy_point_prefix):
        res = fn(th, *as_t(x0, g, lb, ub))
        assert not res.newact_mask[b].any() and not res.free_mask[b].any()
        assert torch.equal(res.xcp[b], torch.as_tensor(x0[b]))


def test_walk_family_raises(case):
    """The sortless walks no longer raise: each entry of the walk family
    in ``GCP_IMPLS`` gives the scan's index sets and its xcp on the batch
    (tests/test_torch_cauchy_walk.py holds them against JAX's)."""
    th, jh, oh, x0, g, lb, ub = case
    args = as_t(x0, g, lb, ub)
    scan = tcauchy.cauchy_point(th, *args)
    for name in ("walk", "walk_chunked", "walk_auto"):
        res = tcauchy.GCP_IMPLS[name](th, *args)
        assert torch.equal(res.newact_mask, scan.newact_mask), name
        assert torch.equal(res.free_mask, scan.free_mask), name
        np.testing.assert_allclose(res.xcp.numpy(), scan.xcp.numpy(),
                                   rtol=1e-10, atol=1e-12)
