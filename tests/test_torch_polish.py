"""The port's df64 polish (lbfgspp_tpu_torch.batch.polish_solve) against
the JAX package's, vmapped.

Bars: in f64 on diagonal quadratics, whose arithmetic decides no branch on
a last ulp, the iteration and evaluation counts and the statuses equal
JAX's per instance and the iterates agree to 1e-10; on Rosenbrock in f32
the polished iterates agree with JAX's to 1e-6.  The helpers here serve
tests/test_torch_deep_polish.py, tests/test_torch_batch_options.py and
tests/test_torch_df64.py too.
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
from lbfgspp_tpu_torch import interop
from lbfgspp_tpu_torch.utils import doublefloat as dfl
from lbfgspp_tpu_torch.utils import objectives as to

from test_torch_lbfgs import _coefficients, make_fg

B, N = 8, 12
COEFFS = _coefficients(N, seed=5)
JFG = make_fg("quadratic", COEFFS, jnp)
TFG = make_fg("quadratic", COEFFS, torch)


def jfg_offset(x):
    fx, g = JFG(x)
    return fx + 3.0, g


def tfg_offset(x):
    fx, g = TFG(x)
    return fx + 3.0, g


def starts(seed=0, b=B, n=N):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, (b, n))


def to_port(res):
    """A JAX result carried over to the port (numpy in between)."""
    return interop.state_from_numpy(jax.tree.map(np.asarray, res),
                                    device="cpu")


def assert_counts_equal(got, want, x_rtol=1e-10):
    np.testing.assert_array_equal(got.niter.numpy(), np.asarray(want.niter))
    np.testing.assert_array_equal(got.nfev.numpy(), np.asarray(want.nfev))
    np.testing.assert_array_equal(got.status.numpy(),
                                  np.asarray(want.status))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=x_rtol, atol=x_rtol)


def main_phase_jax(x0s, params, **kw):
    return JB.minimize_batched(fun_and_grad=JFG, x0s=jnp.asarray(x0s),
                               params=params, **kw)


P_MAIN = dict(epsilon=1e-8, max_iterations=4, m=5)
P_POL = dict(epsilon=1e-10, max_iterations=50, m=5)


@pytest.mark.parametrize("variant", ["cold", "warm", "warm_rinv", "shift",
                                     "restarts"])
def test_polish_solve_matches_jax(variant):
    """polish_solve from a capped f64 main phase, each option: counts,
    statuses and iterates equal JAX's per instance."""
    jmain = main_phase_jax(starts(1), J.LBFGSParams(**P_MAIN),
                           direction="rinv" if "rinv" in variant
                           else "sweeps")
    main = to_port(jmain)
    iters, kw = 20, {}
    jfg, tfg = JFG, TFG
    if variant.startswith("warm"):
        kw["direction"] = "rinv" if variant == "warm_rinv" else "sweeps"
    elif variant == "shift":
        jfg, tfg, kw["shift"] = jfg_offset, tfg_offset, True
    elif variant == "restarts":
        iters, kw["restarts"], kw["on_ls_fail"] = 3, 3, "restart"
    jp, tp = J.LBFGSParams(**P_POL), T.LBFGSParams(**P_POL)
    if variant.startswith("warm"):
        want = jax.jit(jax.vmap(lambda x, h: JB.polish_solve(
            None, x, jp, iters, fun_and_grad=jfg, warm_history=h, **kw)))(
            jmain.x, jmain.history)
        got = TB.polish_solve(None, main.x, tp, iters, fun_and_grad=tfg,
                              warm_history=main.history, device="cpu", **kw)
    else:
        want = jax.jit(jax.vmap(lambda x: JB.polish_solve(
            None, x, jp, iters, fun_and_grad=jfg, **kw)))(jmain.x)
        got = TB.polish_solve(None, main.x, tp, iters, fun_and_grad=tfg,
                              device="cpu", **kw)
    assert_counts_equal(got, want)
    np.testing.assert_allclose(got.fx.numpy(), np.asarray(want.fx),
                               rtol=1e-12, atol=1e-14)
    assert tuple(got.history.s.shape) == (B, P_POL["m"], N)
    assert int(got.history.ncorr.max()) == 0


def test_polish_solve_rosenbrock_f32_matches_jax():
    """The bench's warm polish (5 More-Thuente iterations in pair space,
    rinv) from a JAX f32 main phase at the bench's budget: the iterates
    agree to 1e-6."""
    x0s = jnp.asarray(starts(2, 16, 20), jnp.float32)
    p = J.LBFGSParams(epsilon=1e-5, max_iterations=162, m=16)
    jmain = JB.minimize_batched(jo.rosenbrock, x0s, p, direction="rinv")
    want = jax.jit(jax.vmap(lambda x, h: JB.polish_solve(
        jo.rosenbrock, x, p, 5, direction="rinv", warm_history=h)))(
        jmain.x, jmain.history)
    main = to_port(jmain)
    dfl.FALLBACKS.clear()
    got = TB.polish_solve(to.rosenbrock, main.x,
                          T.LBFGSParams(epsilon=1e-5, max_iterations=162,
                                        m=16), 5, direction="rinv",
                          warm_history=main.history, device="cpu")
    assert sum(dfl.FALLBACKS.values()) == 0
    assert got.x.dtype == torch.float32
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-6)
    err = (got.x.double() - 1.0).abs().max(dim=1).values
    jerr = np.max(np.abs(np.asarray(want.x, np.float64) - 1.0), axis=1)
    assert (err.numpy() <= np.maximum(jerr, 1e-6) * 1.5).all()
