"""The port's active-orthant df64 polish (``batch.polish_solve_owlqn``)
against ``lbfgspp_tpu.batch.polish_solve_owlqn`` on the same f32 inputs.

The cases of tests/test_polish.py:637-677: an f32 OWL-QN lasso solution
(per-instance data, the port's own) must come out with a smaller
f64-evaluated KKT residual, its exact zeros kept and a full L1 objective
no larger (the JAX test's bar, 1e-12); a start whose support is wrong
must never come out worse; the pair interpreter takes the lasso graph
without a fallback.  From the same f32 start the JAX package's polish on
the CPU also improves the KKT residual, and the port's result is at least
as good by both f64 measures (on the CPU the port's reaches ~1e-7 where
JAX's stops at ~1e-5 after the same 60 iterations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lbfgspp_tpu import LBFGSParams as JP
from lbfgspp_tpu.batch import polish_solve_owlqn as j_polish
import lbfgspp_tpu_torch as lt
from lbfgspp_tpu_torch import batch
from lbfgspp_tpu_torch.utils import doublefloat as dfl

LAM = 0.01
POLP = dict(epsilon=1e-9, epsilon_rel=0.0, max_iterations=100, m=8)


def lasso(seed, batch_size, rows=48, n=24):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(batch_size, rows, n)) / np.sqrt(rows)).astype(
        np.float32)
    w = np.zeros((batch_size, n))
    w[:, :5] = rng.normal(size=(batch_size, 5)) * 2
    y = (np.einsum("brn,bn->br", a.astype(np.float64), w)
         + 0.01 * rng.normal(size=(batch_size, rows))).astype(np.float32)
    return a, y


def kkt64(a, y, x):
    a, y, x = (np.asarray(v, np.float64) for v in (a, y, x))
    g = np.einsum("brn,br->bn", a, np.einsum("brn,bn->br", a, x) - y)
    pg = np.where(x != 0, g + LAM * np.sign(x),
                  np.where(g + LAM < 0, g + LAM,
                           np.where(g - LAM > 0, g - LAM, 0.0)))
    return np.abs(pg).max(axis=1)


def full64(a, y, x):
    a, y, x = (np.asarray(v, np.float64) for v in (a, y, x))
    r = np.einsum("brn,bn->br", a, x) - y
    return 0.5 * (r * r).sum(1) + LAM * np.abs(x).sum(1)


def t_loss(x, d):
    r = d["A"] @ x - d["y"]
    return 0.5 * torch.dot(r, r)


def j_loss(ai, yi):
    return lambda w: 0.5 * jnp.dot(ai @ w - yi, ai @ w - yi)


def t_polish(a, y, x0, iters, **kw):
    return batch.polish_solve_owlqn(
        t_loss, torch.as_tensor(np.asarray(x0)), LAM, lt.LBFGSParams(**POLP),
        iters, data={"A": torch.as_tensor(a), "y": torch.as_tensor(y)},
        device="cpu", **kw)


def test_polish_improves_kkt_keeps_zeros_and_beats_jax():
    a, y = lasso(5, 3)
    data = {"A": torch.as_tensor(a), "y": torch.as_tensor(y)}
    prior = lt.minimize_owlqn(
        t_loss, torch.zeros(3, 24), LAM,
        lt.LBFGSParams(epsilon=1e-7, max_iterations=500), data=data,
        device="cpu")
    x0 = prior.x.numpy()
    dfl.FALLBACKS.clear()
    pol = t_polish(a, y, x0, 30, prior=prior, on_ls_fail="restart",
                   restarts=2)
    assert sum(dfl.FALLBACKS.values()) == 0, dict(dfl.FALLBACKS)
    x = pol.x.numpy()
    assert x.dtype == np.float32
    assert ((x0 == 0).sum(1) >= 5).all()      # genuinely sparse starts
    assert (kkt64(a, y, x) < kkt64(a, y, x0)).all()
    assert (full64(a, y, x) <= full64(a, y, x0) + 1e-12).all()
    # The zeros of the start stay exact +0.0.
    assert (x[x0 == 0] == 0).all() and not np.signbit(x[x == 0]).any()
    # prior=: counters cumulative, the OWL-QN status kept.
    assert (pol.niter.numpy() > prior.niter.numpy()).all()
    np.testing.assert_array_equal(pol.status.numpy(), prior.status.numpy())
    np.testing.assert_allclose(pol.gnorm.numpy(), kkt64(a, y, x),
                               rtol=1e-3, atol=1e-7)
    # The JAX package's polish of the same f32 start: the port's result
    # is at least as good by both f64 measures.
    jx = np.asarray(jax.jit(lambda z: j_polish(
        j_loss(jnp.asarray(a[0]), jnp.asarray(y[0])), z, LAM, JP(**POLP),
        30, on_ls_fail="restart", restarts=2).x)(jnp.asarray(x0[0])))[None]
    assert (kkt64(a[:1], y[:1], jx) < kkt64(a[:1], y[:1], x0[:1])).all()
    assert kkt64(a[:1], y[:1], x[:1]) <= kkt64(a[:1], y[:1], jx)
    assert full64(a[:1], y[:1], x[:1]) <= full64(a[:1], y[:1], jx) + 1e-12
    assert (jx[x0[:1] == 0] == 0).all()


def test_polish_misclassification_safety():
    """Starts whose support is wrong (perturbed vectors, not OWL-QN
    results): the df64 acceptance test never returns a worse point."""
    a, y = lasso(9, 2)
    rng = np.random.default_rng(0)
    x_bad = (rng.normal(size=(2, 24)) * 0.3).astype(np.float32)
    x_bad[:, :3] = 0.0          # zeros that are not KKT-consistent
    pol = t_polish(a, y, x_bad, 20)
    assert (full64(a, y, pol.x.numpy()) <=
            full64(a, y, x_bad) + 1e-12).all()
