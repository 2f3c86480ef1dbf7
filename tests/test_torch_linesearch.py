"""The port's batched Nocedal-Wright search against the JAX search (vmapped)
and the numpy oracle (tests/oracle.py), per instance.

Many random 1-D slices of Rosenbrock (n=8, f64) go through ONE batched
port search, so instances with different trial counts and phases share
every trial.  Counts (nfev, status) must match exactly; step, fx and x at
rtol 1e-12 and dg at rtol 1e-10, the same arithmetic in another summation
order (the bars of tests/test_linesearch.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from lbfgspp_tpu.linesearch import nocedalwright as jax_nw
from lbfgspp_tpu.params import LBFGSParams as JParams
from lbfgspp_tpu.utils import objectives as jo
from lbfgspp_tpu_torch import LBFGSParams, Status, make_fun_and_grad
from lbfgspp_tpu_torch.linesearch import get_line_search, nocedalwright
from lbfgspp_tpu_torch.utils import objectives as to


def random_cases(count, n=8, seed=0):
    rng = np.random.default_rng(seed)
    xp = rng.uniform(-1.5, 1.5, (count, n))
    # (fx, grad) from the JAX objective: both searches start from the
    # same values
    fx, grad = (np.array(a) for a in jax.vmap(jo.rosenbrock_fg)(
        jnp.asarray(xp)))
    noise = rng.standard_normal((count, n))
    gn = np.linalg.norm(grad, axis=1, keepdims=True)
    drt = -grad + 0.3 * gn * noise / np.linalg.norm(noise, axis=1,
                                                     keepdims=True)
    bad = np.einsum("bn,bn->b", grad, drt) >= 0
    drt[bad] = -grad[bad]
    dg = np.einsum("bn,bn->b", grad, drt)
    return xp, drt, fx, grad, dg


def _np_fg(x):
    fx, g = jo.rosenbrock_fg(jnp.asarray(x))
    return float(fx), np.asarray(g)


class CountingFG:
    def __init__(self):
        self.fg = make_fun_and_grad(fun_and_grad=to.rosenbrock_fg)
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        return self.fg(x)


def run_both(mls, step0, case, wolfe=0.9):
    xp, drt, fx, grad, dg = case
    count = xp.shape[0]
    step0 = np.broadcast_to(np.asarray(step0, float), (count,)).copy()
    fg = CountingFG()
    got = nocedalwright(fg, LBFGSParams(max_linesearch=mls, wolfe=wolfe),
                        *(torch.as_tensor(a) for a in (xp, drt)), 1e20,
                        torch.as_tensor(step0),
                        *(torch.as_tensor(a) for a in (fx, grad, dg)))
    jp = JParams(max_linesearch=mls, wolfe=wolfe)
    want = jax.jit(jax.vmap(
        lambda x, d, s, f, g, gd: jax_nw(jo.rosenbrock_fg, jp, x, d, 1e20,
                                         s, f, g, gd)))(
        *(jnp.asarray(a) for a in (xp, drt, step0, fx, grad, dg)))
    return got, want, fg.calls


def assert_same(got, want, b):
    assert int(got.status[b]) == int(want.status[b])
    assert int(got.nfev[b]) == int(want.nfev[b])
    np.testing.assert_allclose(float(got.step[b]), float(want.step[b]),
                               rtol=1e-12)
    np.testing.assert_allclose(float(got.fx[b]), float(want.fx[b]),
                               rtol=1e-12)
    np.testing.assert_allclose(got.x[b].numpy(), np.asarray(want.x[b]),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(float(got.dg[b]), float(want.dg[b]),
                               rtol=1e-10, atol=1e-13)


def assert_matches_oracle(got, case, mls, step0, b, wolfe=0.9):
    xp, drt, fx, grad, dg = case
    op = oracle.default_params(max_linesearch=mls, wolfe=wolfe)
    try:
        ostep, ofx, _, odg, ox, onfev = oracle.ls_nocedalwright(
            _np_fg, op, xp[b], drt[b], op["max_step"], float(step0[b]),
            float(fx[b]), grad[b], float(dg[b]))
    except RuntimeError:
        assert int(got.status[b]) != Status.RUNNING
        return
    assert int(got.status[b]) == Status.RUNNING
    assert int(got.nfev[b]) == onfev
    np.testing.assert_allclose(float(got.step[b]), ostep, rtol=1e-12)
    np.testing.assert_allclose(float(got.fx[b]), ofx, rtol=1e-12)
    np.testing.assert_allclose(got.x[b].numpy(), ox, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(float(got.dg[b]), odg, rtol=1e-10,
                               atol=1e-13)


@pytest.mark.parametrize("mls,wolfe", [(40, 0.9), (2, 0.2)])
def test_batch_matches_jax_and_oracle(mls, wolfe):
    """mls=40 is the reference budget; mls=2 (the main phase's cap) with a
    tighter curvature test exhausts both phases, including the zoom exit
    that returns the re-evaluated best-so-far point."""
    case = random_cases(48, seed=mls)
    step0 = np.resize(np.geomspace(1e-3, 1e1, 12), 48)
    got, want, calls = run_both(mls, step0, case, wolfe)
    for b in range(48):
        assert_same(got, want, b)
        assert_matches_oracle(got, case, mls, step0, b, wolfe)
    if mls == 2:
        # one evaluation per trial, plus the re-evaluation of the _lo
        # point of instances that exhausted the zoom
        assert calls == int(got.nfev.max()) + 1


def test_failures_are_per_instance():
    """A non-descent direction and a non-positive step fail their own
    instance only; the rest of the batch searches as usual."""
    xp, drt, fx, grad, dg = random_cases(4, seed=3)
    drt[1] = grad[1]
    dg[1] = grad[1] @ grad[1]
    step0 = np.array([1.0, 1.0, 0.0, 1.0])
    case = (xp, drt, fx, grad, dg)
    got, want, _ = run_both(20, step0, case)
    assert int(got.status[1]) == Status.LS_NOT_DESCENT
    assert int(got.status[2]) == Status.LS_INVALID_STEP
    for b in (1, 2):
        assert int(got.nfev[b]) == 0
        assert torch.equal(got.x[b], torch.as_tensor(xp[b]))
    for b in range(4):
        assert_same(got, want, b)
        assert_matches_oracle(got, case, 20, step0, b)


def test_inactive_instances_keep_their_start():
    xp, drt, fx, grad, dg = (torch.as_tensor(a) for a in random_cases(3))
    fg = make_fun_and_grad(fun_and_grad=to.rosenbrock_fg)
    active = torch.tensor([True, False, True])
    res = nocedalwright(fg, LBFGSParams(), xp, drt, 1e20, 1.0, fx, grad, dg,
                        active=active)
    full = nocedalwright(fg, LBFGSParams(), xp, drt, 1e20, 1.0, fx, grad, dg)
    assert int(res.nfev[1]) == 0 and int(res.status[1]) == Status.RUNNING
    assert torch.equal(res.x[1], xp[1]) and torch.equal(res.fx[1], fx[1])
    for b in (0, 2):
        assert torch.equal(res.x[b], full.x[b])
        assert int(res.nfev[b]) == int(full.nfev[b])


def test_registry_and_param_checks():
    assert get_line_search("nocedalwright") is nocedalwright
    with pytest.raises(ValueError, match="unknown line search 'bogus'"):
        get_line_search("bogus")
    xp, drt, fx, grad, dg = (torch.as_tensor(a) for a in random_cases(2))
    with pytest.raises(ValueError, match="STRONG_WOLFE"):
        nocedalwright(None, LBFGSParams(linesearch=2), xp, drt, 1e20, 1.0,
                      fx, grad, dg)
