"""The port's OWL-QN (``lbfgspp_tpu_torch.owlqn``) against vmapped
``lbfgspp_tpu.owlqn.minimize_owlqn``.

Inputs are made from a numpy seed and go through both packages in f64 on
the CPU; every lasso instance has its own data (``data=`` in the port, a
vmapped closure in JAX) and, where stated, its own lambda.  Tolerances:
iteration and evaluation counts and statuses equal; x to 1e-10
(absolute); zero patterns identical.  The exit tolerances stay above the
f64 rounding floor of the Armijo test (~3e-10, tests/test_owlqn.py:81-84),
where the last trials of the two packages' differently ordered sums part.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgspp_tpu import LBFGSParams as JP
from lbfgspp_tpu.owlqn import minimize_owlqn as j_owlqn
from lbfgspp_tpu.owlqn import pseudo_gradient as j_pseudo_gradient
import lbfgspp_tpu_torch as lt
from lbfgspp_tpu_torch import owlqn
from lbfgspp_tpu_torch.owlqn import minimize_owlqn, pseudo_gradient

F64 = torch.float64
XTOL = 1e-10


def lassos(batch, rows=40, n=16, seed=0, noise=0.05):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, rows, n)) / np.sqrt(rows)
    w = np.zeros((batch, n))
    w[:, :4] = rng.standard_normal((batch, 4)) * 3.0
    b = np.einsum("brn,bn->br", a, w) + noise * rng.standard_normal(
        (batch, rows))
    return a, b


def t_loss(x, d):
    return 0.5 * torch.sum((d["A"] @ x - d["b"]) ** 2)


def j_solve(a, b, lam, x0, params, **kw):
    """Vmapped JAX OWL-QN over per-instance (A, b, lambda, x0)."""
    def one(ai, bi, li, xi):
        return j_owlqn(lambda x: 0.5 * jnp.sum((ai @ x - bi) ** 2), xi, li,
                       params, **kw)
    return jax.jit(jax.vmap(one))(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(lam), jnp.asarray(x0))


def t_solve(a, b, lam, x0, params, **kw):
    return minimize_owlqn(
        t_loss, torch.as_tensor(x0), torch.as_tensor(np.float64(lam)),
        lt.LBFGSParams(**dataclasses.asdict(params)),
        data={"A": torch.as_tensor(a), "b": torch.as_tensor(b)},
        device="cpu", **kw)


def assert_same(jr, tr):
    np.testing.assert_array_equal(tr.niter.numpy(), np.asarray(jr.niter))
    np.testing.assert_array_equal(tr.nfev.numpy(), np.asarray(jr.nfev))
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    x = tr.x.numpy()
    np.testing.assert_allclose(x, np.asarray(jr.x), rtol=0, atol=XTOL)
    np.testing.assert_array_equal(x == 0, np.asarray(jr.x) == 0)
    # Zeros are +0.0, as the JAX package's where(..., 0.0, ...) writes.
    assert not np.signbit(x[x == 0]).any()


def test_pseudo_gradient_cases():
    x = np.array([1.0, -2.0, 0.0, 0.0, 0.0])
    g = np.array([0.3, 0.4, -2.0, 2.0, 0.5])
    lam = np.ones(5)
    pg = pseudo_gradient(*(torch.as_tensor(v) for v in (x, g, lam)))
    np.testing.assert_allclose(pg.numpy(), [1.3, -0.6, -1.0, 1.0, 0.0])
    np.testing.assert_array_equal(
        pg.numpy(), np.asarray(j_pseudo_gradient(jnp.asarray(x),
                                                 jnp.asarray(g),
                                                 jnp.asarray(lam))))


def test_separable_quartic_l1_batch_matches_jax():
    """A separable quartic + L1 batch: counts equal and x equal."""
    rng = np.random.default_rng(1)
    batch, n = 5, 12
    t = rng.uniform(-1.0, 1.0, (batch, n))
    c = rng.uniform(0.1, 2.0, (batch, n))
    lam = rng.uniform(0.0, 0.3, (batch, n))
    lam[:, 0] = 0.0                       # one unpenalized coordinate
    x0 = rng.uniform(-1.0, 1.0, (batch, n))
    # fx is O(1): below ~1e-8 its Armijo decrease is under one ulp.
    p = JP(epsilon=1e-7, epsilon_rel=0.0, max_iterations=200)

    def jf(ti, ci):
        return lambda x: jnp.sum(ci * ((x - ti) ** 2) ** 2
                                 + 0.5 * (x - ti) ** 2)

    jr = jax.jit(jax.vmap(lambda ti, ci, li, xi: j_owlqn(
        jf(ti, ci), xi, li, p)))(*(jnp.asarray(v) for v in (t, c, lam, x0)))
    tr = minimize_owlqn(
        lambda x, d: torch.sum(d[1] * ((x - d[0]) ** 2) ** 2
                               + 0.5 * (x - d[0]) ** 2),
        torch.as_tensor(x0), torch.as_tensor(lam),
        lt.LBFGSParams(epsilon=1e-7, epsilon_rel=0.0, max_iterations=200),
        data=(torch.as_tensor(t), torch.as_tensor(c)), device="cpu")
    assert_same(jr, tr)
    assert (tr.x.numpy() == 0).any()


def test_lassos_match_jax_and_count_lockstep_work():
    a, b = lassos(4)
    p = JP(epsilon=1e-8, epsilon_rel=0.0, max_iterations=300)
    x0 = np.zeros((4, 16))
    jr = j_solve(a, b, np.full(4, 0.02), x0, p)
    owlqn.COUNTS.clear()
    tr = t_solve(a, b, 0.02, x0, p)
    assert_same(jr, tr)
    assert (tr.x.numpy() == 0).sum() > 0
    # The batch runs until its slowest instance stops; every iteration
    # takes at least one lockstep trial after the start point's.
    assert owlqn.COUNTS["iterations"] == int(tr.niter.max())
    assert owlqn.COUNTS["evaluations"] >= 1 + owlqn.COUNTS["iterations"]
    want = 0.5 * ((np.einsum("brn,bn->br", a, tr.x.numpy()) - b) ** 2).sum(1)\
        + 0.02 * np.abs(tr.x.numpy()).sum(1)
    np.testing.assert_allclose(tr.fx.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("kind", ["per_coordinate", "per_instance"])
def test_lambda_shapes_match_jax(kind):
    """``l1`` of shape [n] (one unpenalized coordinate) and [B, n] (a
    regularization path, the batch-explicit form of vmap over lambda)."""
    a, b = lassos(4, seed=4)
    if kind == "per_coordinate":
        lam = np.full(16, 0.02)
        lam[0] = 0.0
        lam_b, lam_t = np.broadcast_to(lam, (4, 16)), lam
    else:
        lam_b = np.outer([0.002, 0.01, 0.05, 0.2], np.ones(16))
        lam_t = lam_b
    p = JP(epsilon=1e-8, epsilon_rel=0.0, max_iterations=400)
    x0 = np.zeros((4, 16))
    assert_same(j_solve(a, b, lam_b, x0, p), t_solve(a, b, lam_t, x0, p))


def test_past_delta_matches_jax():
    a, b = lassos(3, seed=6)
    p = JP(epsilon=1e-12, epsilon_rel=0.0, past=3, delta=1e-6,
           max_iterations=300)
    x0 = np.zeros((3, 16))
    jr = j_solve(a, b, np.full(3, 0.03), x0, p)
    tr = t_solve(a, b, 0.03, x0, p)
    assert_same(jr, tr)
    assert (tr.status.numpy() == int(lt.Status.CONVERGED_DELTA)).all()


def test_strong_l1_gives_the_zero_solution():
    a, b = lassos(2, seed=3)
    lam = 1.01 * np.abs(np.einsum("brn,br->bn", a, b)).max()
    p = JP(epsilon=1e-10, epsilon_rel=0.0, max_iterations=300)
    x0 = np.full((2, 16), 0.3)
    tr = t_solve(a, b, lam, x0, p)
    np.testing.assert_array_equal(tr.x.numpy(), 0.0)
    assert_same(j_solve(a, b, np.full(2, lam), x0, p), tr)


def test_fast_phase_epsilon_sums_counters_and_scopes_tf32():
    """Two phases: the counters add up to the two separate runs', the
    result is the second run's, and the objective runs with TF32 allowed
    in phase 1 only (the caller's flag is back afterwards)."""
    a, b = lassos(3, seed=0)
    pt = lt.LBFGSParams(epsilon=1e-6, epsilon_rel=0.0, max_iterations=200)
    data = {"A": torch.as_tensor(a), "b": torch.as_tensor(b)}
    flags = torch.backends.cuda.matmul
    seen = []

    def loss(x, d):
        seen.append(flags.allow_tf32)
        return t_loss(x, d)

    before = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        two = minimize_owlqn(loss, torch.zeros(3, 16, dtype=F64), 0.02, pt,
                             data=data, fast_phase_epsilon=1e-3,
                             device="cpu")
        assert flags.allow_tf32 is False
    finally:
        flags.allow_tf32 = before
    n1 = seen.index(False)
    assert n1 > 0 and all(seen[:n1]) and not any(seen[n1:])
    r1 = minimize_owlqn(t_loss, torch.zeros(3, 16, dtype=F64), 0.02,
                        dataclasses.replace(pt, epsilon=1e-3), data=data,
                        device="cpu")
    r2 = minimize_owlqn(t_loss, r1.x, 0.02, pt, data=data, device="cpu")
    np.testing.assert_array_equal(two.niter.numpy(),
                                  (r1.niter + r2.niter).numpy())
    np.testing.assert_array_equal(two.nfev.numpy(),
                                  (r1.nfev + r2.nfev).numpy())
    np.testing.assert_array_equal(two.x.numpy(), r2.x.numpy())
    assert (two.gnorm.numpy() <= 1e-6).all()
    jr = j_solve(a, b, np.full(3, 0.02), np.zeros((3, 16)),
                 JP(epsilon=1e-6, epsilon_rel=0.0, max_iterations=200),
                 fast_phase_epsilon=1e-3)
    assert_same(jr, two)


def test_single_solve_and_options():
    a, b = lassos(1, seed=8)
    res = minimize_owlqn(
        lambda x: 0.5 * torch.sum((torch.as_tensor(a[0]) @ x
                                   - torch.as_tensor(b[0])) ** 2),
        torch.zeros(16, dtype=F64), 0.02,
        lt.LBFGSParams(epsilon=1e-8, epsilon_rel=0.0, max_iterations=300),
        device="cpu")
    assert res.x.shape == (16,) and res.niter.dim() == 0
    assert int(res.status) == int(lt.Status.CONVERGED_GRAD)
    # bf16 history rows (tests/test_torch_history_dtype.py holds them
    # against JAX): the same solution of this well-conditioned lasso
    rows = minimize_owlqn(
        lambda x: 0.5 * torch.sum((torch.as_tensor(a[0]) @ x
                                   - torch.as_tensor(b[0])) ** 2),
        torch.zeros(16, dtype=F64), 0.02,
        lt.LBFGSParams(epsilon=1e-8, epsilon_rel=0.0, max_iterations=300),
        history_dtype=torch.bfloat16, device="cpu")
    assert rows.history.s.dtype == torch.bfloat16
    assert int(rows.status) == int(lt.Status.CONVERGED_GRAD)
    np.testing.assert_allclose(rows.x.numpy(), res.x.numpy(), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(rows.x.numpy() == 0, res.x.numpy() == 0)
