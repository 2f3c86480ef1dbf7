"""The port's compact-form L-BFGS-B matrix (lbfgspp_tpu_torch.ops.bmat),
bmat/hmat and the final approximations, against the JAX package's in f64.

A batch of port histories is built from the same random corrections as
one JAX history per instance (the instances take different numbers of
corrections, so the batch mixes fill levels and a wrapped ring); every
product of the W/M family, the Gauss-Jordan inverse (a zero pivot and its
``info`` included) and the updates are held to the JAX results per
instance at rtol 1e-12.  The helpers here serve the Cauchy-point and
subspace tests too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbfgspp_tpu as J
import lbfgspp_tpu_torch as T
from lbfgspp_tpu.ops import bmat as jbmat
from lbfgspp_tpu.ops import history as jhist
from lbfgspp_tpu_torch.ops import bmat as tbmat
from lbfgspp_tpu_torch.ops import history as thist
from lbfgspp_tpu_torch.types import tree_map
from oracle_b import OracleBHistory

RTOL, ATOL = 1e-12, 1e-13
NCORRS = (0, 1, 3, 6, 9)          # m=6: empty, partial, full, wrapped
M, N = 6, 14


def make_histories(n, m, ncorrs, seed=0, with_jax=True):
    """``(port BHistory [B], [JAX BHistory], [oracle history], rng)``, one
    JAX and one oracle history per instance, after ``ncorrs[b]`` accepted
    random corrections of instance b (no JAX ones without ``with_jax``)."""
    rng = np.random.default_rng(seed)
    batch = len(ncorrs)
    th = tbmat.init_b_history(batch, n, m, torch.float64, device="cpu")
    jh = [jbmat.init_b_history(n, m, jnp.float64) for _ in range(batch)]
    oh = [OracleBHistory(n, m) for _ in range(batch)]
    for t in range(max(ncorrs)):
        s = rng.standard_normal((batch, n))
        y = rng.standard_normal((batch, n))
        y = np.where((s * y).sum(1, keepdims=True) < 0, -y, y) + 0.1 * s
        accept = np.asarray(ncorrs) > t
        th = tbmat.add_correction_b(th, torch.as_tensor(s),
                                    torch.as_tensor(y),
                                    torch.as_tensor(accept))
        jh = [jbmat.add_correction_b(h, jnp.asarray(s[b]), jnp.asarray(y[b]),
                                     jnp.asarray(bool(accept[b])))
              if accept[b] and with_jax else h for b, h in enumerate(jh)]
        for b in np.flatnonzero(accept):
            oh[b].add_correction(s[b], y[b])
    return th, jh, oh, rng


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def hists():
    return make_histories(N, M, NCORRS, seed=3)


def test_state_matches_jax(hists):
    th, jh, _, _ = hists
    for b, h in enumerate(jh):
        close(th.minv[b], h.minv)
        close(th.mdense[b], h.mdense)
        close(th.theta[b], h.theta)
        assert int(th.info[b]) == int(h.info) == 0
        assert int(th.base.ncorr[b]) == int(h.base.ncorr)
        assert int(th.base.ptr[b]) == int(h.base.ptr)


PRODUCTS = ("apply_wtv", "apply_mv", "w_matvec", "apply_wtpv", "apply_ptwmv",
            "compute_ftbab", "solve_ptbp", "apply_ptbqv", "w_rows",
            "w_columns")


@pytest.mark.parametrize("name", PRODUCTS)
def test_products_match_jax(hists, name):
    th, jh, _, _ = hists
    rng = np.random.default_rng(len(name))
    batch = len(jh)
    v = rng.standard_normal((batch, N))
    v2 = rng.standard_normal((batch, 2 * M))
    p_mask = rng.random((batch, N)) < 0.5
    q_mask = (~p_mask) & (rng.random((batch, N)) < 0.6)
    idx = np.stack([rng.permutation(N) for _ in range(batch)])
    tv, tv2 = torch.as_tensor(v), torch.as_tensor(v2)
    tp, tq = torch.as_tensor(p_mask), torch.as_tensor(q_mask)
    calls = {
        "apply_wtv": (lambda: tbmat.apply_wtv(th, tv),
                      lambda h, b: jbmat.apply_wtv(h, jnp.asarray(v[b]))),
        "apply_mv": (lambda: tbmat.apply_mv(th, tv2),
                     lambda h, b: jbmat.apply_mv(h, jnp.asarray(v2[b]))),
        "w_matvec": (lambda: tbmat.w_matvec(th, tv2),
                     lambda h, b: jbmat.w_matvec(h, jnp.asarray(v2[b]))),
        "apply_wtpv": (lambda: tbmat.apply_wtpv(th, tp, tv),
                       lambda h, b: jbmat.apply_wtpv(
                           h, jnp.asarray(p_mask[b]), jnp.asarray(v[b]))),
        "apply_ptwmv": (lambda: tbmat.apply_ptwmv(th, tp, tv2, -1.0),
                        lambda h, b: jbmat.apply_ptwmv(
                            h, jnp.asarray(p_mask[b]), jnp.asarray(v2[b]),
                            -1.0)),
        "compute_ftbab": (lambda: tbmat.compute_ftbab(th, tp, tq, tv2, tv),
                          lambda h, b: jbmat.compute_ftbab(
                              h, jnp.asarray(p_mask[b]),
                              jnp.asarray(q_mask[b]), jnp.asarray(v2[b]),
                              jnp.asarray(v[b]))),
        "solve_ptbp": (lambda: tbmat.solve_ptbp(th, tp, tv)[0],
                       lambda h, b: jbmat.solve_ptbp(
                           h, jnp.asarray(p_mask[b]), jnp.asarray(v[b]))[0]),
        "apply_ptbqv": (lambda: tbmat.apply_ptbqv(th, tp, tq, tv),
                        lambda h, b: jbmat.apply_ptbqv(
                            h, jnp.asarray(p_mask[b]),
                            jnp.asarray(q_mask[b]), jnp.asarray(v[b]))),
        "w_rows": (lambda: tbmat.w_rows(th),
                   lambda h, b: jbmat.w_rows(h)),
        "w_columns": (lambda: tbmat.w_columns(th, torch.as_tensor(idx)),
                      lambda h, b: jbmat.w_columns(h, jnp.asarray(idx[b]))),
    }
    mine, theirs = calls[name]
    got = mine()
    for b, h in enumerate(jh):
        close(got[b], theirs(h, b))


def test_solve_ptbp_info_and_middle_solves(hists):
    th, _, _, rng = hists
    mask = torch.as_tensor(rng.random((len(NCORRS), N)) < 0.7)
    v = torch.as_tensor(rng.standard_normal((len(NCORRS), N)))
    gj, info_gj = tbmat.solve_ptbp(th, mask, v, "gj")
    bk, info_bk = tbmat.solve_ptbp(th, mask, v, "bkldlt")
    close(gj, bk, rtol=1e-9, atol=1e-11)
    assert not info_gj.any() and not info_bk.any()


def test_dense_inv_matches_jax_with_a_zero_pivot():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((4, 12, 12))
    a[1, :, 3] = 0.0                      # a zero column: a zero pivot
    a[2] = np.eye(12)                     # ties everywhere
    a[3, :2, :2] = [[0.0, 1.0], [1.0, 0.0]]   # first pivot needs a swap
    a[3, :2, 2:] = 0.0
    a[3, 2:, :2] = 0.0
    inv, info = tbmat._dense_inv(torch.as_tensor(a))
    for b in range(4):
        jinv, jinfo = jbmat._dense_inv(jnp.asarray(a[b]))
        close(inv[b], jinv)
        assert int(info[b]) == int(jinfo)
    assert info.tolist() == [0, 1, 0, 0]
    close(inv[0] @ torch.as_tensor(a[0]), np.eye(12), atol=1e-10)


def test_update_history_b_gates_like_jax():
    """The curvature gate s'y > eps y'y, instance by instance."""
    rng = np.random.default_rng(11)
    batch, n, m = 4, 9, 3
    th = tbmat.init_b_history(batch, n, m, torch.float64, device="cpu")
    jh = [jbmat.init_b_history(n, m, jnp.float64) for _ in range(batch)]
    for t in range(5):
        s = rng.standard_normal((batch, n))
        y = rng.standard_normal((batch, n))
        y[0] = -s[0]                      # negative curvature: rejected
        allow = np.array([True, True, t % 2 == 0, True])
        th, acc = tbmat.update_history_b(th, torch.as_tensor(s),
                                         torch.as_tensor(y),
                                         torch.as_tensor(allow))
        for b in range(batch):
            jh[b], jacc = jbmat.update_history_b(
                jh[b], jnp.asarray(s[b]), jnp.asarray(y[b]),
                jnp.asarray(bool(allow[b])))
            assert bool(acc[b]) == bool(jacc)
    for b in range(batch):
        close(th.minv[b], jh[b].minv)
        close(th.mdense[b], jh[b].mdense)
        close(th.base.s[b], jh[b].base.s)
    assert int(th.base.ncorr[0]) == 0


@pytest.mark.parametrize("which", ("bmat", "hmat"))
def test_dense_approximations_match_jax(hists, which):
    th, jh, _, _ = hists
    got = getattr(thist, which)(th.base)
    for b, h in enumerate(jh):
        close(got[b], getattr(jhist, which)(h.base))
    # B and H are inverses of each other
    eye = torch.eye(N, dtype=torch.float64)
    close(thist.bmat(th.base) @ thist.hmat(th.base),
          eye.expand(len(NCORRS), N, N), rtol=0, atol=1e-9)


def test_final_approx_accessors_match_jax():
    """A solve's final approximate Hessian and its inverse, batched and
    from a 1-D start, against ``lbfgspp_tpu.final_approx_*``."""
    rng = np.random.default_rng(2)
    n = 8
    d = rng.uniform(1.0, 5.0, n)

    def tfg(x):
        return 0.5 * torch.sum(torch.as_tensor(d) * x * x), \
            torch.as_tensor(d) * x

    def jfg(x):
        return 0.5 * jnp.sum(jnp.asarray(d) * x * x), jnp.asarray(d) * x

    x0 = rng.uniform(-1, 1, n)
    p = T.LBFGSParams(epsilon=1e-9, max_iterations=50)
    single = T.minimize(fun_and_grad=tfg, x0=torch.as_tensor(x0), params=p,
                        device="cpu")
    batched = T.minimize(fun_and_grad=tfg, x0=torch.as_tensor(x0[None]),
                         params=p, device="cpu")
    want = J.minimize(fun_and_grad=jfg, x0=jnp.asarray(x0),
                      params=J.LBFGSParams(epsilon=1e-9, max_iterations=50))
    for name in ("final_approx_hessian", "final_approx_inverse_hessian"):
        ref = getattr(J, name)(want)
        close(getattr(T, name)(single), ref, rtol=1e-12, atol=1e-12)
        close(getattr(T, name)(batched)[0], ref, rtol=1e-12, atol=1e-12)
    assert tree_map(lambda t: t.shape[0], batched.history).s == 1
