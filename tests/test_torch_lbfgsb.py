"""The port's L-BFGS-B solver (lbfgspp_tpu_torch.lbfgsb) against the NumPy
trajectory oracle (tests/oracle_b.py) and the JAX package's, in f64.

Bars, from tests/test_lbfgsb.py: the random coupled quadratics take the
oracle's iteration count, with fx at rtol 1e-9 and x at rtol 1e-7; the
README box example and the reference's box example take the oracle's
count too.  The solver's steps equal the JAX package's one by one; the
pathological-direction rescue resets the direction and the whole matrix
as JAX's does.  All solves use ``gcp="scan"``, the reference-order walk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbfgspp_tpu_torch as T
from lbfgspp_tpu import lbfgsb as jlbfgsb
from lbfgspp_tpu_torch import lbfgsb as tlbfgsb
from lbfgspp_tpu_torch.utils import objectives as to
import oracle_b


def np_fg(tfg):
    def fg(x):
        fx, g = tfg(torch.as_tensor(x))
        return float(fx), g.numpy()
    return fg


def solve(tfg, x0, lb, ub, params=T.LBFGSBParams(), **kw):
    return T.minimize_b(fun_and_grad=tfg, x0=torch.as_tensor(x0),
                        lb=torch.as_tensor(lb), ub=torch.as_tensor(ub),
                        params=params, gcp="scan", device="cpu", **kw)


def coupled(seed):
    """tests/test_lbfgsb.py:107-122: a random coupled quadratic in a
    random box."""
    rng = np.random.default_rng(100 + seed)
    n = 9
    a_half = rng.standard_normal((n, n)) / np.sqrt(n)
    a = a_half @ a_half.T + 0.5 * np.eye(n)
    b = rng.standard_normal(n)
    lb = rng.standard_normal(n) - 1.5
    ub = lb + 1.0 + rng.random(n)
    x0 = np.clip(rng.standard_normal(n), lb, ub)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)

    def tfg(x):
        ax = at @ x
        return 0.5 * x @ ax + bt @ x, ax + bt

    aj, bj = jnp.asarray(a), jnp.asarray(b)

    def jfg(x):
        ax = aj @ x
        return 0.5 * x @ ax + bj @ x, ax + bj

    return tfg, jfg, x0, lb, ub


@pytest.mark.parametrize("seed", range(4))
def test_coupled_quadratics_match_oracle(seed):
    tfg, _, x0, lb, ub = coupled(seed)
    res = solve(tfg, x0, lb, ub)
    xo, fo, go, pgo, ko = oracle_b.lbfgsb_minimize(
        np_fg(tfg), x0, oracle_b.default_b_params(), lb, ub)
    assert int(res.niter) == ko
    np.testing.assert_allclose(float(res.fx), fo, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res.x.numpy(), xo, rtol=1e-7, atol=1e-9)


def test_readme_box_example():
    """README.md:164-193: Rosenbrock n=10 in [2, 4]^10 from 3."""
    n = 10
    x0, lb, ub = np.full(n, 3.0), np.full(n, 2.0), np.full(n, 4.0)
    res = solve(to.rosenbrock_fg, x0, lb, ub,
                T.LBFGSBParams(epsilon=1e-6, max_iterations=100))
    assert int(res.status) in (int(T.Status.CONVERGED_GRAD),
                               int(T.Status.CONVERGED_DELTA))
    xo, fo, go, pgo, ko = oracle_b.lbfgsb_minimize(
        np_fg(to.rosenbrock_fg), x0,
        oracle_b.default_b_params(epsilon=1e-6, max_iterations=100), lb, ub)
    assert int(res.niter) == ko
    np.testing.assert_allclose(float(res.fx), fo, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res.x.numpy(), xo, rtol=1e-8, atol=1e-10)


def test_reference_box_example():
    """example-rosenbrock-box.cpp:38-53: n=25, x[2] free, mixed starts on
    the bounds."""
    n = 25
    lb, ub = np.full(n, 2.0), np.full(n, 4.0)
    lb[2], ub[2] = -np.inf, np.inf
    x0 = np.full(n, 3.0)
    x0[0] = x0[1] = 2.0
    x0[5] = x0[7] = 4.0
    res = solve(to.rosenbrock_chained_fg, x0, lb, ub)
    xo, fo, go, pgo, ko = oracle_b.lbfgsb_minimize(
        np_fg(to.rosenbrock_chained_fg), x0, oracle_b.default_b_params(),
        lb, ub)
    assert int(res.niter) == ko
    np.testing.assert_allclose(res.x.numpy(), xo, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(res.fx), fo, rtol=1e-10)


def test_pinned_outside_and_early_exit_in_one_batch():
    """lb == ub pins a variable (Cauchy.h:113-114); a start outside the box
    is projected first (LBFGSB.h:126-128); a start at the minimizer exits
    at once (LBFGSB.h:146-149): three instances of one batch, each with
    its own bounds."""
    n = 8
    d = np.arange(n, dtype=float)
    dt = torch.as_tensor(d)

    def tfg(x):
        r = x - dt
        return torch.sum(r * r), 2.0 * r

    lb = np.stack([np.full(n, -5.0), np.zeros(n), d - 1.0])
    ub = np.stack([np.full(n, 5.0), np.ones(n), d + 1.0])
    lb[0, 3] = ub[0, 3] = 2.5
    lb[0, 6] = ub[0, 6] = -0.5
    x0 = np.stack([np.zeros(n), np.full(n, -100.0), d])
    res = T.minimize_b(fun_and_grad=tfg, x0=torch.as_tensor(x0),
                       lb=torch.as_tensor(lb), ub=torch.as_tensor(ub),
                       params=T.LBFGSBParams(epsilon=1e-8, epsilon_rel=0.0),
                       device="cpu")
    np.testing.assert_allclose(res.x[0].numpy(), np.clip(d, lb[0], ub[0]),
                               atol=1e-6)
    assert float(res.x[0, 3]) == 2.5 and float(res.x[0, 6]) == -0.5
    np.testing.assert_allclose(res.x[1].numpy(), np.clip(d, 0.0, 1.0),
                               atol=1e-8)
    assert int(res.niter[2]) == 1
    assert int(res.status[2]) == int(T.Status.CONVERGED_GRAD)


def _jax_solver(jfg, lb, ub):
    return jlbfgsb.solver(fun_and_grad=jfg, lb=jnp.asarray(lb),
                          ub=jnp.asarray(ub))


def _assert_state_close(ts, js, b=0):
    np.testing.assert_allclose(ts.x[b].numpy(), np.asarray(js.x),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(ts.fx[b]), float(js.fx), rtol=1e-11,
                               atol=1e-13)
    np.testing.assert_allclose(ts.drt[b].numpy(), np.asarray(js.drt),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(ts.hist.minv[b].numpy(),
                               np.asarray(js.hist.minv), rtol=1e-9,
                               atol=1e-11)
    for field in ("k", "nfev", "status", "done"):
        assert int(getattr(ts, field)[b]) == int(getattr(js, field)), field
    assert int(ts.hist.base.ncorr[b]) == int(js.hist.base.ncorr)


def test_solver_steps_match_jax():
    tfg, jfg, x0, lb, ub = coupled(1)
    ts = tlbfgsb.solver(fun_and_grad=tfg, lb=torch.as_tensor(lb),
                        ub=torch.as_tensor(ub), device="cpu")
    js = _jax_solver(jfg, lb, ub)
    tst = ts.init(torch.as_tensor(x0))
    jst = js.init(jnp.asarray(x0))
    step = jax.jit(js.step)
    _assert_state_close(tst, jst)
    for _ in range(8):
        tst, jst = ts.step(tst), step(jst)
        _assert_state_close(tst, jst)
    fin = ts.finalize(tst)
    assert float(fin.gnorm[0]) == pytest.approx(float(jst.projgnorm),
                                                rel=1e-9, abs=1e-14)


def test_pathological_direction_resets_the_matrix():
    """An ascent direction (dg >= 0) is replaced by ``xcp - x`` and the
    whole matrix is reset (LBFGSB.h:181-197), as in the JAX package."""
    tfg, jfg, x0, lb, ub = coupled(2)
    ts = tlbfgsb.solver(fun_and_grad=tfg, lb=torch.as_tensor(lb),
                        ub=torch.as_tensor(ub), device="cpu")
    js = _jax_solver(jfg, lb, ub)
    tst = ts.init(torch.as_tensor(x0))
    jst = js.init(jnp.asarray(x0))
    step = jax.jit(js.step)
    for _ in range(3):
        tst, jst = ts.step(tst), step(jst)
    assert int(tst.hist.base.ncorr[0]) >= 2
    tst = tst._replace(drt=tst.grad.clone())
    jst = jst._replace(drt=jst.grad)
    tst, jst = ts.step(tst), step(jst)
    _assert_state_close(tst, jst)
    assert int(tst.hist.base.ncorr[0]) <= 1


def test_walk_gcps_raise():
    """The walk GCPs no longer raise: a solve through each takes the
    scan's iterations to the scan's solution."""
    x0 = torch.full((4,), 3.0, dtype=torch.float64)
    p = T.LBFGSBParams(epsilon=1e-8, max_iterations=100)
    scan = T.minimize_b(to.rosenbrock, x0, 2.0, 4.0, p, gcp="scan",
                        device="cpu")
    for gcp in ("walk", "walk_chunked", "walk_auto"):
        res = T.minimize_b(to.rosenbrock, x0, 2.0, 4.0, p, gcp=gcp,
                           device="cpu")
        assert int(res.niter) == int(scan.niter), gcp
        np.testing.assert_allclose(res.x.numpy(), scan.x.numpy(),
                                   rtol=1e-10)
