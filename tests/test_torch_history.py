"""The port's batched history against vmapped JAX ``ops.history``.

The same (s, y) pairs, drawn with numpy, go through ``vmap`` of the JAX
functions and through the port's batched ones, over wrapped rings with
mixed fill levels and rejected pairs.  Tolerances: ring contents are
copies (exact); Grams, R^{-1} and directions agree at rtol 1e-12 in f64,
the same arithmetic summed in another order.  The case structure mirrors
tests/test_history.py (TestTriSolveModes, TestSoftReset,
TestRinvFromGrams).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgspp_tpu.ops import history as JH
from lbfgspp_tpu_torch.ops import history as TH

RTOL = 1e-12
ATOL = 1e-13
F64 = torch.float64

_j_update = jax.jit(jax.vmap(JH.update_history))


def _pairs(steps, batch, n, seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((steps, batch, n))
    y = s * rng.uniform(0.5, 2.0, (steps, batch, 1)) \
        + 0.3 * rng.standard_normal((steps, batch, n))
    flip = np.einsum("tbn,tbn->tb", s, y) < 0
    y[flip] = -y[flip]
    return s, y


def build_both(batch, n, m, counts, with_rinv=False, seed=0, reject=()):
    """JAX (vmapped) and port histories after ``counts[b]`` offered pairs
    per instance; ``reject`` lists (step, instance) pairs given negative
    curvature, which the gate must skip."""
    steps = max(counts)
    s, y = _pairs(steps, batch, n, seed)
    for t, b in reject:
        y[t, b] = -s[t, b]
    jh = jax.vmap(lambda _: JH.init_history(n, m, jnp.float64,
                                            with_rinv=with_rinv))(
        jnp.arange(batch))
    th = TH.init_history(batch, n, m, F64, device="cpu",
                         with_rinv=with_rinv)
    counts = np.asarray(counts)
    for t in range(steps):
        allow = t < counts
        jh, jacc = _j_update(jh, jnp.asarray(s[t]), jnp.asarray(y[t]),
                             jnp.asarray(allow))
        th, tacc = TH.update_history(th, torch.as_tensor(s[t]),
                                     torch.as_tensor(y[t]),
                                     torch.as_tensor(allow))
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    return jh, th


def assert_history_close(jh, th):
    for name in ("s", "y"):
        np.testing.assert_array_equal(getattr(th, name).numpy(),
                                      np.asarray(getattr(jh, name)))
    for name in ("ncorr", "ptr"):
        np.testing.assert_array_equal(getattr(th, name).numpy(),
                                      np.asarray(getattr(jh, name)))
    for name in ("ys", "theta", "sy", "yy", "rinv"):
        jv = getattr(jh, name)
        if jv is None:
            assert getattr(th, name) is None
            continue
        np.testing.assert_allclose(getattr(th, name).numpy(),
                                   np.asarray(jv), rtol=RTOL, atol=ATOL)


COUNTS = (0, 1, 3, 5, 9, 13)    # empty, partial, full, wrapped rings


@pytest.mark.parametrize("with_rinv", [False, True])
def test_update_history_matches_jax_over_wrapped_rings(with_rinv):
    jh, th = build_both(6, 20, 5, COUNTS, with_rinv=with_rinv, seed=1,
                        reject=((2, 4), (7, 5)))
    assert_history_close(jh, th)
    np.testing.assert_array_equal(th.ncorr.numpy(), [0, 1, 3, 5, 5, 5])


@pytest.mark.parametrize("tri", ["sweeps", "rinv", "doubling"])
@pytest.mark.parametrize("m", [5, 16])
def test_apply_hv_matches_vmapped_jax(tri, m):
    counts = tuple(c * m // 5 for c in COUNTS)
    jh, th = build_both(6, 20, m, counts, with_rinv=tri == "rinv", seed=m)
    v = np.random.default_rng(3).standard_normal((6, 20))
    want = jax.vmap(lambda h, vv: JH.apply_hv(h, vv, -1.0, tri=tri))(
        jh, jnp.asarray(v))
    got = TH.apply_hv(th, torch.as_tensor(v), -1.0, tri=tri)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_apply_hv_reference_matches_jax_and_compact_form():
    jh, th = build_both(6, 20, 5, COUNTS, seed=4)
    v = np.random.default_rng(5).standard_normal((6, 20))
    want = jax.vmap(lambda h, vv: JH.apply_hv_reference(h, vv, 2.0))(
        jh, jnp.asarray(v))
    got = TH.apply_hv_reference(th, torch.as_tensor(v), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    compact = TH.apply_hv(th, torch.as_tensor(v), 2.0)
    np.testing.assert_allclose(compact.numpy(), got.numpy(), rtol=1e-10,
                               atol=1e-12)


class TestTriSolveModes:
    CASES = [(4, 2), (4, 4), (4, 9), (6, 6), (16, 40), (5, 7)]

    @pytest.mark.parametrize("tri", ["doubling", "rinv"])
    def test_matches_sweeps(self, tri):
        for i, (m, count) in enumerate(self.CASES):
            _, th = build_both(3, 20, m, (count, max(count - 1, 0), 1),
                               with_rinv=True, seed=10 + i)
            v = torch.as_tensor(
                np.random.default_rng(i).standard_normal((3, 20)))
            d0 = TH.apply_hv(th, v, -1.0)
            d1 = TH.apply_hv(th, v, -1.0, tri=tri)
            np.testing.assert_allclose(d1.numpy(), d0.numpy(), rtol=RTOL,
                                       atol=RTOL)

    def test_rinv_is_inverse_of_age_ordered_triu_gram(self):
        m, n = 5, 14
        _, th = build_both(2, n, m, (13, 7), with_rinv=True, seed=3)
        for b in range(2):
            idx = (int(th.ptr[b]) - int(th.ncorr[b]) + np.arange(m)) % m
            s_age = th.s[b].numpy()[idx]
            y_age = th.y[b].numpy()[idx]
            r = np.triu(s_age @ y_age.T)
            np.testing.assert_allclose(th.rinv[b].numpy()[np.ix_(idx, idx)],
                                       np.linalg.inv(r), rtol=1e-11,
                                       atol=1e-12)

    def test_rejected_pair_leaves_instance_untouched(self):
        m, n = 4, 10
        _, th = build_both(3, n, m, (3, 5, 2), with_rinv=True, seed=4)
        s, y = _pairs(1, 3, n, seed=5)
        accept = torch.tensor([False, True, False])
        th2 = TH.add_correction(th, torch.as_tensor(s[0]),
                                torch.as_tensor(y[0]), accept)
        for before, after in zip(th, th2):
            assert torch.equal(before[0], after[0])
            assert torch.equal(before[2], after[2])
        assert int(th2.ncorr[1]) == min(int(th.ncorr[1]) + 1, m)

    def test_rinv_requires_maintained_history(self):
        th = TH.init_history(2, 8, 4, F64, device="cpu")
        with pytest.raises(ValueError):
            TH.apply_hv(th, torch.ones(2, 8, dtype=F64), -1.0, tri="rinv")
        with pytest.raises(ValueError):
            TH.apply_hv(th, torch.ones(2, 8, dtype=F64), -1.0, tri="nope")

    def test_default_history_has_no_rinv(self):
        assert TH.init_history(2, 8, 4, F64, device="cpu").rinv is None


class TestSoftReset:
    """The restart path's soft reset (ncorr = 0, theta = 1, stale rows left
    in place) acts like a fresh history, in the port and in JAX alike."""

    @pytest.mark.parametrize("with_rinv", [False, True])
    def test_soft_reset_equals_fresh(self, with_rinv):
        n, m, batch = 12, 5, 3
        jh, th = build_both(batch, n, m, (m + 2, m + 4, m), seed=6,
                            with_rinv=with_rinv)
        soft = th._replace(ncorr=torch.zeros_like(th.ncorr),
                           theta=torch.ones_like(th.theta))
        fresh = TH.init_history(batch, n, m, F64, device="cpu",
                                with_rinv=with_rinv)
        tri = "rinv" if with_rinv else "sweeps"
        rng = np.random.default_rng(9)
        v = torch.as_tensor(rng.standard_normal((batch, n)))
        assert torch.equal(TH.apply_hv(soft, v, -1.0, tri=tri),
                           TH.apply_hv(fresh, v, -1.0, tri=tri))
        s = torch.as_tensor(rng.standard_normal((batch, n)))
        y = s * 1.3
        ok = torch.ones(batch, dtype=torch.bool)
        h1, _ = TH.update_history(soft, s, y, ok)
        h2, _ = TH.update_history(fresh, s, y, ok)
        np.testing.assert_allclose(TH.apply_hv(h1, v, -1.0, tri=tri).numpy(),
                                   TH.apply_hv(h2, v, -1.0, tri=tri).numpy(),
                                   rtol=1e-15)
        # and the JAX package does the same on the same soft-reset state
        jsoft = jh._replace(ncorr=jnp.zeros_like(jh.ncorr),
                            theta=jnp.ones_like(jh.theta))
        jh1, _ = _j_update(jsoft, jnp.asarray(s.numpy()),
                           jnp.asarray(y.numpy()), jnp.ones(batch, bool))
        assert_history_close(jh1, h1)
        want = jax.vmap(lambda h, vv: JH.apply_hv(h, vv, -1.0, tri=tri))(
            jh1, jnp.asarray(v.numpy()))
        np.testing.assert_allclose(TH.apply_hv(h1, v, -1.0, tri=tri).numpy(),
                                   np.asarray(want), rtol=RTOL, atol=ATOL)


class TestRinvFromGrams:
    def test_matches_maintained_and_jax(self):
        for i, (m, count) in enumerate([(4, 2), (4, 9), (6, 6), (16, 40),
                                        (5, 7)]):
            jh, th = build_both(2, 20, m, (count, max(count - 2, 0)),
                                with_rinv=True, seed=20 + i)
            rec = TH.rinv_from_grams(th._replace(rinv=None))
            np.testing.assert_allclose(rec.numpy(), th.rinv.numpy(),
                                       rtol=1e-10, atol=1e-12)
            want = jax.vmap(JH.rinv_from_grams)(jh._replace(rinv=None))
            np.testing.assert_allclose(rec.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)

    def test_empty_history(self):
        th = TH.init_history(2, 10, 4, F64, device="cpu")
        assert torch.equal(TH.rinv_from_grams(th),
                           torch.zeros(2, 4, 4, dtype=F64))


@pytest.mark.parametrize("entry", ["minimize", "minimize_b", "bmat",
                                   "raises"])
def test_solves_leave_the_callers_tf32_setting(entry):
    """The history's and bmat's products run with TF32 off and give the
    caller's ``allow_tf32`` back, also when the objective raises; the
    objective itself runs at the caller's setting."""
    import lbfgspp_tpu_torch as lt
    from lbfgspp_tpu_torch.ops import bmat as TB

    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    seen = []

    def fun(x):
        seen.append(flags.allow_tf32)
        if entry == "raises" and len(seen) > 3:   # after history updates
            raise RuntimeError("objective failed")
        return torch.sum((x - 1.0) ** 2) + torch.sum(x ** 4)

    x0 = torch.zeros(3, 4, dtype=F64)
    p = lt.LBFGSParams(epsilon=1e-8, max_iterations=20)
    flags.allow_tf32 = True
    try:
        if entry in ("minimize", "raises"):
            if entry == "raises":
                with pytest.raises(RuntimeError, match="objective failed"):
                    lt.minimize(fun, x0, p, device="cpu")
            else:
                res = lt.minimize(fun, x0, p, device="cpu")
                assert int(res.niter.max()) > 1
        elif entry == "minimize_b":
            lt.minimize_b(fun, x0, torch.full((4,), -0.5, dtype=F64),
                          torch.full((4,), 0.5, dtype=F64),
                          lt.LBFGSBParams(epsilon=1e-8, max_iterations=20),
                          device="cpu")
        else:
            _, th = build_both(2, 10, 4, (5, 2), seed=7)
            TH.bmat(th)
            TH.hmat(th)
            TB.solve_ptbp(TB.init_b_history(2, 10, 4, F64, device="cpu"),
                          torch.ones(2, 10, dtype=torch.bool),
                          torch.ones(2, 10, dtype=F64))
        assert flags.allow_tf32 is True
        assert all(seen) and (entry == "bmat" or seen)
    finally:
        flags.allow_tf32 = before
