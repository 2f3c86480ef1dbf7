"""The port's batched L-BFGS solver against vmapped JAX ``lbfgs`` and the
numpy oracle (tests/oracle.py).

Bars (PERF.md, "Record of the JAX package"): on diagonal quadratics and
separable quartics the iteration and evaluation counts equal JAX's and the
oracle's exactly, since their arithmetic decides no branch on a last ulp;
on Rosenbrock, summation-order ulps may flip a line-search branch, so the
bar is the same optimum (1e-8 relative at a tight tolerance) and the same
statuses.  All in f64.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbfgspp_tpu as J
import lbfgspp_tpu_torch as T
import oracle
from lbfgspp_tpu.utils import objectives as jo
from lbfgspp_tpu_torch import interop
from lbfgspp_tpu_torch.utils import objectives as to


def _coefficients(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 10.0, n), rng.uniform(-1.0, 1.0, n),
            rng.uniform(0.1, 2.0, n), rng.uniform(-1.0, 1.0, n))


def make_fg(kind, coeffs, lib):
    """The same objective for numpy (oracle), JAX and the port; the
    quartic keeps the reference fuzz's operation order
    (scripts/reference_binary/fuzz_compare.py:220-230)."""
    conv = torch.as_tensor if lib is torch else lib.asarray
    d, b, c, t = (conv(a) for a in coeffs)
    if kind == "quadratic":
        def fg(x):
            g = d * x - b
            return 0.5 * (x * (d * x)).sum() - (b * x).sum(), g
    else:
        def fg(x):
            e = x - t
            e2 = e * e
            return (c * e2 * e2 + 0.5 * d * e2).sum(), \
                4.0 * c * e2 * e + d * e
    return fg


def _np_fg(fg):
    def f(x):
        fx, g = fg(x)
        return float(fx), np.asarray(g, float)
    return f


@pytest.mark.parametrize("kind", ["quadratic", "quartic"])
@pytest.mark.parametrize("n,m,eps", [(10, 6, 1e-8), (20, 3, 1e-6)])
def test_counts_equal_jax_and_oracle(kind, n, m, eps):
    coeffs = _coefficients(n, seed=n + m)
    x0 = np.random.default_rng(n).uniform(-2.0, 2.0, (6, n))
    jp = J.LBFGSParams(m=m, epsilon=eps, max_iterations=1000)
    tp = T.LBFGSParams(m=m, epsilon=eps, max_iterations=1000)
    jfg = make_fg(kind, coeffs, jnp)
    want = jax.jit(jax.vmap(lambda x: J.minimize(fun_and_grad=jfg, x0=x,
                                                 params=jp)))(
        jnp.asarray(x0))
    got = T.minimize(fun_and_grad=make_fg(kind, coeffs, torch),
                     x0=torch.as_tensor(x0), params=tp, device="cpu")
    for field in ("niter", "nfev", "status"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-10, atol=1e-12)
    op = oracle.default_params(m=m, epsilon=eps, max_iterations=1000)
    ofg = _np_fg(make_fg(kind, coeffs, np))
    for i in range(len(x0)):
        ores = oracle.lbfgs_minimize(ofg, x0[i], op, "nocedalwright")
        assert int(got.niter[i]) == ores["niter"]
        assert int(got.nfev[i]) == ores["nfev"]


@pytest.mark.parametrize("direction", ["rinv", "doubling"])
def test_other_schedules_count_like_sweeps_on_quadratics(direction):
    coeffs = _coefficients(10, seed=3)
    x0 = torch.as_tensor(np.random.default_rng(3).uniform(-2, 2, (6, 10)))
    p = T.LBFGSParams(epsilon=1e-8, max_iterations=1000)
    fg = make_fg("quadratic", coeffs, torch)
    a = T.minimize(fun_and_grad=fg, x0=x0, params=p, device="cpu")
    b = T.minimize(fun_and_grad=fg, x0=x0, params=p, device="cpu",
                   direction=direction)
    assert torch.equal(a.niter, b.niter)
    # the schedules agree to reassociation rounding
    np.testing.assert_allclose(b.x.numpy(), a.x.numpy(), rtol=0, atol=1e-9)


class TestRosenbrock:
    def test_readme_anchor_22_iterations(self):
        """README.md:88-94: n=10 from zeros, eps=1e-6 converges in 22
        iterations under the current convergence test, as in JAX."""
        p = T.LBFGSParams(epsilon=1e-6, max_iterations=100)
        res = T.minimize(to.rosenbrock, torch.zeros(10, dtype=torch.float64),
                         p, device="cpu")
        assert res.x.shape == (10,)
        assert int(res.niter) == 22
        assert int(res.status) == T.Status.CONVERGED_GRAD
        jres = J.minimize(jo.rosenbrock, jnp.zeros(10),
                          J.LBFGSParams(epsilon=1e-6, max_iterations=100))
        assert int(jres.niter) == 22
        np.testing.assert_allclose(float(res.fx), float(jres.fx), rtol=1e-6)

    def test_same_optimum_as_jax(self):
        x0 = np.random.default_rng(5).uniform(-1.5, 1.5, (4, 8))
        jp = J.LBFGSParams(epsilon=1e-10, epsilon_rel=0.0,
                           max_iterations=400)
        tp = T.LBFGSParams(epsilon=1e-10, epsilon_rel=0.0,
                           max_iterations=400)
        want = jax.jit(jax.vmap(lambda x: J.minimize(jo.rosenbrock, x, jp)))(
            jnp.asarray(x0))
        got = T.minimize(to.rosenbrock, torch.as_tensor(x0), tp,
                         device="cpu")
        np.testing.assert_array_equal(got.status.numpy(),
                                      np.asarray(want.status))
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   rtol=1e-8)

    def test_bench_phase_one_batch_matches_vmapped_jax(self):
        """bench.py:81-116 phase 1 (m=16, 162 iterations, mls=2, restart,
        rinv) on 16 starts, f64, n=20.  Counts may differ by branch flips;
        statuses must agree, and every x stops at the eps=1e-5 gradient
        test, within 1e-4 of the optimum and of JAX's x."""
        x0 = np.random.default_rng(0).uniform(-2.0, 2.0, (16, 20))
        kw = dict(epsilon=1e-5, max_iterations=162, m=16, max_linesearch=2)
        want = jax.jit(jax.vmap(lambda x: J.minimize(
            jo.rosenbrock, x, J.LBFGSParams(**kw), direction="rinv",
            on_ls_fail="restart")))(jnp.asarray(x0))
        got = T.minimize_batched(to.rosenbrock, torch.as_tensor(x0),
                                 T.LBFGSParams(**kw), direction="rinv",
                                 on_ls_fail="restart", device="cpu")
        np.testing.assert_array_equal(got.status.numpy(),
                                      np.asarray(want.status))
        assert np.abs(got.x.numpy() - np.asarray(want.x)).max() <= 1e-4
        assert np.abs(got.x.numpy() - 1.0).max() <= 1e-4
        same = (got.niter.numpy() == np.asarray(want.niter)).mean()
        assert same >= 0.5, same


@pytest.mark.parametrize("direction", ["sweeps", "rinv"])
@pytest.mark.parametrize("batched", [False, True])
def test_one_step_from_a_jax_state_matches_jax(direction, batched):
    """A JAX mid-solve state, carried over through ``interop``, takes one
    port step to JAX's next state (rtol 1e-10: one step's arithmetic in
    another summation order)."""
    p = dict(epsilon=1e-10, max_iterations=100, m=5, past=2, delta=1e-12)
    js = J.lbfgs.solver(jo.rosenbrock, J.LBFGSParams(**p),
                        direction=direction)
    ts = T.solver(to.rosenbrock, T.LBFGSParams(**p), direction=direction,
                  device="cpu")
    x0 = np.random.default_rng(1).uniform(-1.5, 1.5, (3, 8))
    if batched:
        step = jax.jit(jax.vmap(js.step))
        st = jax.vmap(js.init)(jnp.asarray(x0))
    else:
        step = jax.jit(js.step)
        st = js.init(jnp.asarray(x0[0]))
    for _ in range(7):          # past the m=5 ring's wrap
        st = step(st)
    ported = interop.state_from_numpy(jax.tree.map(np.asarray, st),
                                      device="cpu")
    want = jax.tree.map(np.asarray, step(st))
    got = ts.step(ported)
    if not batched:
        got = T.lbfgs.unbatch(got)
    for name, g, w in zip(T.LBFGSState._fields, got, want):
        if name == "hist":
            for hname, hg, hw in zip(got.hist._fields, g, w):
                if hw is None:
                    assert hg is None
                else:
                    np.testing.assert_allclose(hg.numpy(), hw, rtol=1e-10,
                                               atol=1e-14, err_msg=hname)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                       atol=1e-14, err_msg=name)


def test_result_carries_over_through_interop():
    res = J.minimize(jo.rosenbrock, jnp.zeros(6),
                     J.LBFGSParams(max_iterations=5), direction="rinv")
    got = interop.state_from_numpy(jax.tree.map(np.asarray, res),
                                   device="cpu")
    assert isinstance(got, T.SolveResult)
    assert got.x.shape == (1, 6) and got.history.s.shape == (1, 6, 6)
    assert got.niter.dtype == torch.int32
    np.testing.assert_array_equal(got.history.rinv[0].numpy(),
                                  np.asarray(res.history.rinv))


def test_drive_fixed_equals_while():
    x0 = torch.as_tensor(np.random.default_rng(2).uniform(-2, 2, (5, 10)))
    p = T.LBFGSParams(epsilon=1e-6, max_iterations=60)
    a = T.minimize_batched(to.rosenbrock, x0, p, device="cpu")
    b = T.minimize_batched(to.rosenbrock, x0, p, drive="fixed",
                           device="cpu")
    for x, y in zip(a[:-1], b[:-1]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="drive"):
        T.minimize_batched(to.rosenbrock, x0, p, drive="sometimes",
                           device="cpu")
    with pytest.raises(ValueError, match="max_iterations"):
        T.minimize_batched(to.rosenbrock, x0, T.LBFGSParams(),
                           drive="fixed", device="cpu")


def test_termination_paths():
    p = T.LBFGSParams()
    # x0 already optimal: one iteration, no search (LBFGS.h:100-103)
    res = T.minimize(to.quadratic, torch.arange(6, dtype=torch.float64), p,
                     device="cpu")
    assert int(res.niter) == 1 and int(res.status) == T.Status.CONVERGED_GRAD
    res = T.minimize(to.rosenbrock, torch.zeros(10, dtype=torch.float64),
                     T.LBFGSParams(epsilon=1e-14, epsilon_rel=0.0,
                                   max_iterations=3), device="cpu")
    assert int(res.status) == T.Status.MAX_ITERATIONS and int(res.niter) == 3
    res = T.minimize(to.rosenbrock, torch.zeros(10, dtype=torch.float64),
                     T.LBFGSParams(epsilon=0.0, epsilon_rel=0.0, past=3,
                                   delta=1e-8), device="cpu")
    assert int(res.status) == T.Status.CONVERGED_DELTA


def test_restart_suppresses_past_delta_on_failed_iterations():
    """tests/test_lbfgs.py's case: a permanently failing search under
    restart reports MAX_ITERATIONS (not CONVERGED_DELTA); stop reports
    the failure."""
    def flat_fg(x):
        return torch.ones((), dtype=x.dtype), torch.ones_like(x)

    p = T.LBFGSParams(epsilon=1e-8, max_iterations=25, past=3, delta=1e-9,
                      max_linesearch=3)
    x0 = torch.zeros(2, 4, dtype=torch.float64)
    res = T.minimize(fun_and_grad=flat_fg, x0=x0, params=p,
                     on_ls_fail="restart", device="cpu")
    assert (res.status == T.Status.MAX_ITERATIONS).all()
    stop = T.minimize(fun_and_grad=flat_fg, x0=x0, params=p, device="cpu")
    assert (stop.status >= 10).all()
    jres = J.minimize(fun_and_grad=lambda x: (jnp.ones((), x.dtype),
                                              jnp.ones_like(x)),
                      x0=jnp.zeros(4), params=J.LBFGSParams(
                          epsilon=1e-8, max_iterations=25, past=3,
                          delta=1e-9, max_linesearch=3))
    assert int(stop.status[0]) == int(jres.status)
    assert int(stop.niter[0]) == int(jres.niter)


def test_restart_continues_failed_instances_in_f32():
    """The restart path (soft reset, 1/||g|| restart step) in f32, where
    capped searches fail (tests/test_lbfgs.py::test_on_ls_fail_restart):
    no instance reports a search failure, and instances whose searches
    never failed end exactly where the stop path leaves them."""
    x0 = np.random.default_rng(1).uniform(-2.0, 2.0, (16, 20))
    kw = dict(epsilon=1e-5, max_iterations=60, m=16, max_linesearch=2)
    got = T.minimize_batched(to.rosenbrock,
                             torch.as_tensor(x0, dtype=torch.float32),
                             T.LBFGSParams(**kw), direction="rinv",
                             on_ls_fail="restart", device="cpu")
    assert got.x.dtype == torch.float32
    assert (got.status < 10).all()
    assert torch.isfinite(got.x).all()
    stop = T.minimize_batched(to.rosenbrock,
                              torch.as_tensor(x0, dtype=torch.float32),
                              T.LBFGSParams(**kw), direction="rinv",
                              device="cpu")
    ok = stop.status < 10
    assert torch.equal(got.x[ok], stop.x[ok])


def test_solver_argument_checks():
    with pytest.raises(ValueError, match="on_ls_fail"):
        T.solver(to.quadratic, T.LBFGSParams(), on_ls_fail="retry",
                 device="cpu")
    with pytest.raises(ValueError, match="max_iterations"):
        T.solver(to.quadratic, T.LBFGSParams(), on_ls_fail="restart",
                 device="cpu")
    with pytest.raises(ValueError, match="direction"):
        T.solver(to.quadratic, T.LBFGSParams(), direction="diagonal",
                 device="cpu")
    with pytest.warns(UserWarning, match="rinv"):
        T.solver(to.quadratic, T.LBFGSParams(m=24), direction="rinv",
                 device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.solver(to.quadratic, T.LBFGSParams(m=16), direction="rinv",
                 device="cpu")
        T.solver(to.quadratic, T.LBFGSParams(m=32), direction="sweeps",
                 device="cpu")
