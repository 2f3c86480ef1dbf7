"""The port's batched More-Thuente, backtracking, bracketing and speculative
searches against the JAX searches (vmapped) and, where one exists, the
numpy oracle (tests/oracle.py), per instance.

Many random 1-D slices of Rosenbrock (n=8, f64) go through ONE batched
port search, so instances with different trial counts, exits and intervals
share every trial.  Counts (nfev, status) must match exactly; step, fx and
x at rtol 1e-12 and dg at rtol 1e-10 (the bars of
tests/test_torch_linesearch.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from lbfgspp_tpu import linesearch as jax_ls
from lbfgspp_tpu.params import LBFGSParams as JParams
from lbfgspp_tpu.utils import objectives as jo
from lbfgspp_tpu_torch import LBFGSParams, Status, make_fun_and_grad
from lbfgspp_tpu_torch.linesearch import get_line_search
from lbfgspp_tpu_torch.utils import objectives as to

from test_torch_linesearch import _np_fg, random_cases

COUNT = 48


class CountingFG:
    def __init__(self):
        self.fg = make_fun_and_grad(fun_and_grad=to.rosenbrock_fg)
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        return self.fg(x)


def run_both(name, case, step0, step_max=1e20, **param):
    xp, drt, fx, grad, dg = case
    count = xp.shape[0]
    step0 = np.broadcast_to(np.asarray(step0, float), (count,)).copy()
    fg = CountingFG()
    got = get_line_search(name)(
        fg, LBFGSParams(**param), *(torch.as_tensor(a) for a in (xp, drt)),
        step_max, torch.as_tensor(step0),
        *(torch.as_tensor(a) for a in (fx, grad, dg)))
    jp = JParams(**param)
    search = jax_ls.get_line_search(name)
    want = jax.jit(jax.vmap(
        lambda x, d, s, f, g, gd: search(jo.rosenbrock_fg, jp, x, d,
                                         step_max, s, f, g, gd)))(
        *(jnp.asarray(a) for a in (xp, drt, step0, fx, grad, dg)))
    return got, want, step0, fg.calls


def assert_same(got, want, b):
    assert int(got.status[b]) == int(want.status[b]), b
    assert int(got.nfev[b]) == int(want.nfev[b]), b
    np.testing.assert_allclose(float(got.step[b]), float(want.step[b]),
                               rtol=1e-12)
    np.testing.assert_allclose(float(got.fx[b]), float(want.fx[b]),
                               rtol=1e-12)
    np.testing.assert_allclose(got.x[b].numpy(), np.asarray(want.x[b]),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(float(got.dg[b]), float(want.dg[b]),
                               rtol=1e-10, atol=1e-13)


def assert_matches_oracle(name, got, case, step0, b, step_max=1e20,
                          **param):
    """The oracle raises where the reference throws; the port reports a
    failure status there and the oracle's point elsewhere.  The oracle
    More-Thuente returns its best-so-far point on exhaustion, which the
    port reports with status RUNNING."""
    xp, drt, fx, grad, dg = case
    op = oracle.default_params(**param)
    try:
        ostep, ofx, _, odg, ox, onfev = oracle.LINE_SEARCHES[name](
            _np_fg, op, xp[b], drt[b], step_max, float(step0[b]),
            float(fx[b]), grad[b], float(dg[b]))
    except RuntimeError:
        assert int(got.status[b]) != Status.RUNNING, b
        return
    assert int(got.status[b]) == Status.RUNNING, b
    assert int(got.nfev[b]) == onfev, b
    np.testing.assert_allclose(float(got.step[b]), ostep, rtol=1e-12)
    np.testing.assert_allclose(float(got.fx[b]), ofx, rtol=1e-12)
    np.testing.assert_allclose(got.x[b].numpy(), ox, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(float(got.dg[b]), odg, rtol=1e-10,
                               atol=1e-13)


STEP0 = np.resize(np.geomspace(1e-3, 1e2, 16), COUNT)


@pytest.mark.parametrize("mls,wolfe,step_max", [
    (20, 0.9, 1e20),     # the reference budget
    (1, 0.9, 1e20),      # exhaustion after one trial: the _lo point
    (2, 0.1, 1e20),      # a tight curvature test exhausts more instances
    (3, 0.9, 1e20),
    (20, 0.9, 0.5),      # step_max caps the extrapolation (case 2) and
])                        # rejects every step0 above it before the loop
def test_morethuente_matches_jax_and_oracle(mls, wolfe, step_max):
    case = random_cases(COUNT, seed=mls + int(10 * wolfe))
    param = dict(max_linesearch=mls, wolfe=wolfe)
    got, want, step0, calls = run_both("morethuente", case, STEP0,
                                       step_max, **param)
    for b in range(COUNT):
        assert_same(got, want, b)
        assert_matches_oracle("morethuente", got, case, step0, b, step_max,
                              **param)
    exhausted = (got.nfev == mls) & (got.status == Status.RUNNING)
    if mls <= 3:
        assert bool(exhausted.any())
    # one evaluation per trial, plus the _lo re-evaluation on exhaustion
    assert calls == int(got.nfev.max()) + int(bool(exhausted.any()))


def test_morethuente_pre_loop_failures_are_per_instance():
    xp, drt, fx, grad, dg = random_cases(5, seed=3)
    drt[1] = grad[1]
    dg[1] = grad[1] @ grad[1]
    case = (xp, drt, fx, grad, dg)
    step0 = np.array([1.0, 1.0, 0.0, 1e-30, 2.0])   # invalid: 0, < min_step
    got, want, _, _ = run_both("morethuente", case, step0, step_max=1.5)
    expect = [Status.RUNNING, Status.LS_NOT_DESCENT, Status.LS_INVALID_STEP,
              Status.LS_INVALID_STEP, Status.LS_INVALID_STEP]
    assert [int(s) for s in got.status] == [int(s) for s in expect]
    for b in range(1, 5):
        assert int(got.nfev[b]) == 0
        assert torch.equal(got.x[b], torch.as_tensor(xp[b]))
    for b in range(5):
        assert_same(got, want, b)
        assert_matches_oracle("morethuente", got, case, step0, b, 1.5)


@pytest.mark.parametrize("name", ["morethuente", "backtracking",
                                  "bracketing", "speculative"])
def test_inactive_instances_keep_their_start(name):
    xp, drt, fx, grad, dg = (torch.as_tensor(a) for a in random_cases(3))
    fg = make_fun_and_grad(fun_and_grad=to.rosenbrock_fg)
    search = get_line_search(name)
    active = torch.tensor([True, False, True])
    res = search(fg, LBFGSParams(), xp, drt, 1e20, 1.0, fx, grad, dg,
                 active=active)
    full = search(fg, LBFGSParams(), xp, drt, 1e20, 1.0, fx, grad, dg)
    assert int(res.nfev[1]) == 0 and int(res.status[1]) == Status.RUNNING
    assert torch.equal(res.x[1], xp[1]) and torch.equal(res.fx[1], fx[1])
    for b in (0, 2):
        assert torch.equal(res.x[b], full.x[b])
        assert int(res.nfev[b]) == int(full.nfev[b])


@pytest.mark.parametrize("name", ["backtracking", "bracketing"])
@pytest.mark.parametrize("linesearch,mls", [(1, 20), (2, 20), (3, 20),
                                            (3, 2)])
def test_backtracking_family_matches_jax_and_oracle(name, linesearch, mls):
    """Armijo, Wolfe and strong Wolfe at the reference budget, and strong
    Wolfe exhausted at 2 trials (LS_MAX_LINESEARCH)."""
    case = random_cases(COUNT, seed=7 + linesearch)
    param = dict(linesearch=linesearch, max_linesearch=mls)
    got, want, step0, _ = run_both(name, case, STEP0, **param)
    for b in range(COUNT):
        assert_same(got, want, b)
        assert_matches_oracle(name, got, case, step0, b, **param)
    if mls == 2:
        assert bool((got.status == Status.LS_MAX_LINESEARCH).any())


def test_backtracking_family_pre_loop_failures():
    xp, drt, fx, grad, dg = random_cases(3, seed=4)
    drt[1] = grad[1]
    dg[1] = grad[1] @ grad[1]
    step0 = np.array([1.0, 1.0, 0.0])
    for name in ("backtracking", "bracketing"):
        got, want, _, _ = run_both(name, (xp, drt, fx, grad, dg), step0)
        assert int(got.status[1]) == Status.LS_NOT_DESCENT
        assert int(got.status[2]) == Status.LS_INVALID_STEP
        for b in range(3):
            assert_same(got, want, b)


@pytest.mark.parametrize("mls", [20, 8, 3])
def test_speculative_matches_jax(mls):
    """No reference counterpart: held against the JAX search alone, with
    its rounds (K=8 candidates each) capped at ceil(mls / 8)."""
    case = random_cases(COUNT, seed=20 + mls)
    got, want, _, _ = run_both("speculative", case, STEP0,
                               max_linesearch=mls)
    for b in range(COUNT):
        assert_same(got, want, b)


def test_registry_holds_every_search():
    for name in ("backtracking", "bracketing", "morethuente",
                 "nocedalwright", "speculative"):
        assert callable(get_line_search(name))
    from lbfgspp_tpu_torch.linesearch import make_speculative
    with pytest.raises(ValueError, match="k >= 2"):
        make_speculative(k=1)
