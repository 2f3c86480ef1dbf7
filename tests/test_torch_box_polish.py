"""The port's box-constrained batch solve and its active-set df64 polish
(lbfgspp_tpu_torch.batch.minimize_b_batched, polish_solve_b, best_result)
against the JAX package's.

The cases are tests/test_polish.py's: the bench's box recipe (Rosenbrock
n=10 in [2, 4], f32, the prefix GCP) reaches frac_within_1e-4 == 1.0 only
after the polish, which pins every bound-active coordinate exactly; the
polish refines a free coordinate in pair space; a wrong pin is rejected
by the df64 acceptance test; ``prior=`` makes the counters cumulative.
Bars: the polished iterates equal the JAX package's on the pinned
coordinates bit for bit and agree to 1e-6 on free ones (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbfgspp_tpu as J
import lbfgspp_tpu_torch as T
from lbfgspp_tpu import batch as JB
from lbfgspp_tpu.utils import objectives as jo
from lbfgspp_tpu_torch import batch as TB
from lbfgspp_tpu_torch.utils import doublefloat as dfl
from lbfgspp_tpu_torch.utils import objectives as to

BN = 10
XSTAR = np.tile([2.0, 4.0], BN // 2)
BOX = T.LBFGSBParams(epsilon=1e-6, max_iterations=60)
POLISH = T.LBFGSParams(epsilon=1e-7, max_iterations=60, m=6)


def err(x):
    return np.max(np.abs(np.asarray(x, np.float64) - XSTAR), axis=1)


@pytest.fixture(scope="module")
def recipe():
    """The bench's box recipe at B=64 (bench.py:139-175): the box solve,
    then the same solve with ``polish_iters=4``."""
    x0s = torch.as_tensor(np.random.default_rng(0).uniform(
        2.0, 4.0, (64, BN)), dtype=torch.float32)
    lb, ub = torch.full((BN,), 2.0), torch.full((BN,), 4.0)
    base = T.minimize_b_batched(to.rosenbrock, x0s, lb, ub, BOX,
                                gcp="prefix", device="cpu")
    res = T.minimize_b_batched(to.rosenbrock, x0s, lb, ub, BOX,
                               gcp="prefix", polish_iters=4, device="cpu")
    return x0s, lb, ub, base, res


def test_box_recipe_reaches_the_gate(recipe):
    x0s, lb, ub, base, res = recipe
    assert float(np.mean(err(base.x) <= 1e-4)) < 1.0   # the f32 plateau
    assert float(np.mean(err(res.x) <= 1e-4)) == 1.0
    assert float(err(res.x).max()) == 0.0             # pinned exactly
    assert bool(torch.isfinite(res.x).all())
    # the box solve's status stays; the counters add up
    assert torch.equal(res.status, base.status)
    assert bool((res.nfev > base.nfev).all())
    assert bool((res.niter >= base.niter).all())


def test_box_polish_pins_like_jax(recipe):
    """The port's polish and the JAX package's, from the port's box
    iterates: both land every instance on the optimum exactly."""
    x0s, lb, ub, base, res = recipe
    jl, ju = jnp.full((BN,), 2.0, jnp.float32), jnp.full((BN,), 4.0,
                                                         jnp.float32)
    p = J.LBFGSParams(epsilon=1e-7, max_iterations=60, m=6)
    want = jax.jit(jax.vmap(lambda x: JB.polish_solve_b(
        jo.rosenbrock, x, jl, ju, p, 4)))(jnp.asarray(base.x.numpy()))
    got = TB.polish_solve_b(to.rosenbrock, base.x, lb, ub, POLISH, 4,
                            device="cpu")
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.x.numpy(), res.x.numpy())


def test_shared_and_per_instance_bounds_agree(recipe):
    x0s, lb, ub, base, res = recipe
    per = T.minimize_b_batched(to.rosenbrock, x0s, lb.expand(64, BN),
                               ub.expand(64, BN), BOX, gcp="prefix",
                               polish_iters=4, device="cpu")
    for a, b in zip(per[:7], res[:7]):
        assert torch.equal(a, b)


def _chained_case():
    n = 25
    lb = np.full(n, 2.0, np.float32)
    ub = np.full(n, 4.0, np.float32)
    lb[2], ub[2] = -np.inf, np.inf
    x0 = np.full(n, 3.0)
    x0[0] = x0[1] = 2.0
    x0[5] = x0[7] = 4.0
    return x0, lb, ub


def test_polish_refines_a_free_coordinate():
    """example-rosenbrock-box.cpp:47-48 keeps x[2] unbounded: the polish
    moves it 100x closer to the f64 solution, in the JAX package's
    steps."""
    x0, lb, ub = _chained_case()
    fg = to.rosenbrock_chained_fg
    r32 = T.minimize_b(fun_and_grad=fg, x0=torch.as_tensor(x0,
                                                           dtype=torch.float32),
                       lb=torch.as_tensor(lb), ub=torch.as_tensor(ub),
                       device="cpu")
    r64 = T.minimize_b(fun_and_grad=fg, x0=torch.as_tensor(x0), lb=lb,
                       ub=ub, device="cpu")
    params = T.LBFGSParams(epsilon=1e-9, max_iterations=40)
    pol = TB.polish_solve_b(None, r32.x, lb, ub, params, 20,
                            fun_and_grad=fg, device="cpu")
    before = abs(float(r32.x[2]) - float(r64.x[2]))
    after = abs(float(pol.x[2]) - float(r64.x[2]))
    assert after < before / 100.0, (before, after)
    assert bool((pol.x >= torch.as_tensor(lb)).all())
    assert bool((pol.x <= torch.as_tensor(ub)).all())
    want = JB.polish_solve_b(None, jnp.asarray(r32.x.numpy()),
                             jnp.asarray(lb), jnp.asarray(ub),
                             J.LBFGSParams(epsilon=1e-9, max_iterations=40),
                             20, fun_and_grad=jo.rosenbrock_chained_fg)
    pinned = np.asarray(want.x) != np.asarray(want.x)[2]
    np.testing.assert_array_equal(pol.x.numpy()[pinned],
                                  np.asarray(want.x)[pinned])
    np.testing.assert_allclose(pol.x.numpy(), np.asarray(want.x), rtol=1e-6)


def test_wrong_pins_keep_the_start():
    """An absurd ``active_tol`` pins wrongly; the df64 acceptance test
    keeps the original iterate (or a better one), as JAX's does."""
    x0, lb, ub = _chained_case()
    fg = to.rosenbrock_chained_fg
    r32 = T.minimize_b(fun_and_grad=fg, x0=torch.as_tensor(x0,
                                                           dtype=torch.float32),
                       lb=lb, ub=ub, device="cpu")
    params = T.LBFGSParams(epsilon=1e-9, max_iterations=40)
    pol = TB.polish_solve_b(None, r32.x, lb, ub, params, 10,
                            fun_and_grad=fg, active_tol=2.5, device="cpu")
    want = JB.polish_solve_b(None, jnp.asarray(r32.x.numpy()),
                             jnp.asarray(lb), jnp.asarray(ub),
                             J.LBFGSParams(epsilon=1e-9, max_iterations=40),
                             10, fun_and_grad=jo.rosenbrock_chained_fg,
                             active_tol=2.5)

    def f64(x):
        return float(fg(torch.as_tensor(np.asarray(x), dtype=torch.float64))[0])

    assert f64(pol.x) <= f64(r32.x) + 1e-9
    assert torch.equal(pol.x, r32.x) == bool(np.array_equal(
        np.asarray(want.x), r32.x.numpy()))


def test_prior_merges_counters():
    """With ``prior=`` the counters are cumulative and the box solve's
    status and history stay (tests/test_polish.py:493-515)."""
    n = 6
    lb, ub = torch.full((n,), 2.0, dtype=torch.float64), \
        torch.full((n,), 4.0, dtype=torch.float64)
    box = T.minimize_b(to.rosenbrock, torch.full((n,), 3.0,
                                                 dtype=torch.float64),
                       lb, ub, T.LBFGSBParams(epsilon=1e-6,
                                              max_iterations=50),
                       device="cpu")
    pp = T.LBFGSParams(epsilon=1e-8, max_iterations=30, m=6)
    alone = TB.polish_solve_b(to.rosenbrock, box.x, lb, ub, pp, 4,
                              device="cpu")
    merged = TB.polish_solve_b(to.rosenbrock, box.x, lb, ub, pp, 4,
                               prior=box, device="cpu")
    assert torch.equal(merged.x, alone.x)
    assert int(merged.niter) == int(box.niter) + int(alone.niter)
    assert int(merged.nfev) == int(box.nfev) + int(alone.nfev)
    assert int(merged.status) == int(box.status)
    assert torch.equal(merged.history.base.s, box.history.base.s)
    want = JB.polish_solve_b(jo.rosenbrock, jnp.asarray(box.x.numpy()),
                             jnp.asarray(lb.numpy()), jnp.asarray(ub.numpy()),
                             J.LBFGSParams(epsilon=1e-8, max_iterations=30,
                                           m=6), 4)
    np.testing.assert_allclose(alone.x.numpy(), np.asarray(want.x),
                               rtol=1e-12)
    assert int(alone.nfev) == int(want.nfev)
    assert int(alone.niter) == int(want.niter)


def test_two_calls_with_different_active_sets():
    """The pinned objective takes ``active`` and ``xpin`` as data, not as
    constants of its recorded graph: calls with different active sets
    give each its own result, in any order."""
    rng = np.random.default_rng(3)
    lb, ub = torch.full((BN,), 2.0), torch.full((BN,), 4.0)
    near_lo = torch.as_tensor(2.0 + rng.uniform(0, 1e-4, (8, BN)),
                              dtype=torch.float32)
    near_star = torch.as_tensor(XSTAR + rng.uniform(-1e-4, 1e-4, (8, BN)),
                                dtype=torch.float32).clamp(2.0, 4.0)

    def polish(x):
        return TB.polish_solve_b(to.rosenbrock, x, lb, ub, POLISH, 4,
                                 device="cpu")

    dfl._TRACES.clear()
    first_b = polish(near_star)
    dfl._TRACES.clear()
    a1 = polish(near_lo)
    b = polish(near_star)
    a2 = polish(near_lo)
    for u, v in zip(a1[:7], a2[:7]):
        assert torch.equal(u, v)
    for u, v in zip(b[:7], first_b[:7]):
        assert torch.equal(u, v)
    assert not torch.equal(a1.x, b.x[:, :])
    assert float(err(b.x).max()) == 0.0


def test_best_result_matches_jax():
    rng = np.random.default_rng(9)
    batch, n = 6, 3
    fx = np.array([3.0, 1.0, np.nan, 0.5, -2.0, 0.25])
    status = np.array([1, 2, 1, 3, 12, 1], dtype=np.int32)
    fields = dict(x=rng.standard_normal((batch, n)), fx=fx,
                  grad=rng.standard_normal((batch, n)),
                  gnorm=rng.random(batch),
                  niter=np.arange(batch, dtype=np.int32),
                  nfev=np.arange(batch, dtype=np.int32) + 3, status=status)
    for prefer in (True, False):
        for fxs in (fx, np.full(batch, np.nan)):
            f = dict(fields, fx=fxs)
            got = TB.best_result(T.SolveResult(
                **{k: torch.as_tensor(v) for k, v in f.items()},
                history=None), prefer_success=prefer)
            want = JB.best_result(J.SolveResult(
                **{k: jnp.asarray(v) for k, v in f.items()},
                history=None), prefer_success=prefer)
            assert int(got.niter) == int(want.niter)
    # the lowest fx among the successes (index 4's -2.0 failed its search)
    assert int(TB.best_result(T.SolveResult(
        **{k: torch.as_tensor(v) for k, v in fields.items()},
        history=None)).niter) == 5
