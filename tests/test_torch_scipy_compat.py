"""The port's scipy-style front end (``lbfgspp_tpu_torch.scipy_compat``)
against ``lbfgspp_tpu.scipy_compat``.

The cases of tests/test_scipy_compat.py: the option map, the automatic
choice of L-BFGS-B when bounds are given, scipy's ``Bounds`` and
``(lo, None)`` pairs, ``jac`` forms, maxiter reported as failure, the
``fmin_l_bfgs_b`` triple, warnflags and callback.  Against the JAX front
end in f64 on the CPU: the same ``nit``, ``nfev``, status and message, x
to 1e-10 (the same arithmetic summed in another order); against scipy's
own ``minimize`` and ``fmin_l_bfgs_b`` on box-constrained quadratics to
1e-6.  ``x`` is a tensor
on the solve's device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgspp_tpu import scipy_compat as JS
from lbfgspp_tpu.utils.objectives import rosenbrock as j_rosenbrock
from lbfgspp_tpu_torch import scipy_compat as TS
from lbfgspp_tpu_torch.utils.objectives import rosenbrock, rosenbrock_fg

F64 = torch.float64
CPU = dict(device="cpu")


def _same(tout, jout, atol=1e-10):
    assert isinstance(tout.x, torch.Tensor) and tout.x.device.type == "cpu"
    for key in ("nit", "nfev", "status", "success", "message"):
        assert tout[key] == jout[key], key
    np.testing.assert_allclose(tout.x.numpy(), np.asarray(jout.x), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("options", [
    {"gtol": 1e-6, "maxiter": 200},
    {"maxcor": 3, "maxls": 30, "ftol": 1e-14},
    {"maxiter": 3, "gtol": 1e-12},
])
def test_unconstrained_matches_jax(options):
    tout = TS.minimize(rosenbrock, torch.full((10,), -1.2, dtype=F64),
                       options=dict(options), **CPU)
    jout = JS.minimize(j_rosenbrock, jnp.full((10,), -1.2),
                       options=dict(options))
    _same(tout, jout)
    if options.get("maxiter") == 3:
        assert not tout.success and "maximum" in tout.message


def test_jac_forms_agree():
    x0 = torch.full((8,), -0.5, dtype=F64)
    a = TS.minimize(rosenbrock, x0, options={"gtol": 1e-8}, **CPU)
    b = TS.minimize(rosenbrock_fg, x0, jac=True, options={"gtol": 1e-8},
                    **CPU)
    c = TS.minimize(rosenbrock, x0, jac=lambda x: rosenbrock_fg(x)[1],
                    options={"gtol": 1e-8}, **CPU)
    assert a.nit == b.nit == c.nit
    assert torch.equal(a.x, b.x) and torch.equal(b.x, c.x)


def test_bounds_select_lbfgsb_and_match_jax():
    d = np.linspace(-3.0, 3.0, 6)
    tout = TS.minimize(lambda x: torch.sum((x - torch.as_tensor(d)) ** 2),
                       torch.zeros(6, dtype=F64),
                       bounds=[(-1.0, 1.0)] * 4 + [(None, 1.0), (0.0, None)],
                       **CPU)
    jout = JS.minimize(lambda x: jnp.sum((x - jnp.asarray(d)) ** 2),
                       jnp.zeros(6),
                       bounds=[(-1.0, 1.0)] * 4 + [(None, 1.0), (0.0, None)])
    _same(tout, jout)
    want = np.clip(d, [-1.0] * 4 + [-np.inf, 0.0], [1.0] * 5 + [np.inf])
    np.testing.assert_allclose(tout.x.numpy(), want, atol=1e-6)


def test_scipy_bounds_object_and_scipy_result():
    scipy = pytest.importorskip("scipy.optimize")
    rng = np.random.default_rng(3)
    q = rng.standard_normal((6, 6))
    a = q.T @ q + 6 * np.eye(6)
    b = rng.standard_normal(6)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    out = TS.minimize(lambda x: 0.5 * x @ (at @ x) - bt @ x,
                      torch.zeros(6, dtype=F64),
                      bounds=scipy.Bounds(-0.1, 0.1),
                      options={"gtol": 1e-10}, **CPU)
    ref = scipy.minimize(lambda x: 0.5 * x @ a @ x - b @ x, np.zeros(6),
                         jac=lambda x: a @ x - b, method="L-BFGS-B",
                         bounds=[(-0.1, 0.1)] * 6,
                         options={"gtol": 1e-12, "ftol": 1e-15})
    np.testing.assert_allclose(out.x.numpy(), ref.x, atol=1e-6)


def test_option_and_method_errors():
    x0 = torch.zeros(4, dtype=F64)
    with pytest.raises(ValueError, match="unknown options"):
        TS.minimize(rosenbrock, x0, options={"bogus": 1}, **CPU)
    with pytest.raises(ValueError, match="unsupported method"):
        TS.minimize(rosenbrock, x0, method="CG", **CPU)
    with pytest.raises(ValueError, match="cannot handle bounds"):
        TS.minimize(rosenbrock, x0, method="L-BFGS",
                    bounds=[(0.0, 1.0)] * 4, **CPU)
    with pytest.raises(ValueError, match="length of x0"):
        TS.minimize(rosenbrock, x0, bounds=[(0.0, 1.0)] * 3, **CPU)
    out = TS.minimize(rosenbrock, torch.full((4,), -0.5, dtype=F64),
                      options={"disp": True, "iprint": 1, "maxfun": 15000,
                               "eps": 1e-8, "gtol": 1e-6}, **CPU)
    assert out.success


def test_fmin_l_bfgs_b_triple_callback_and_scipy():
    x, f, info = TS.fmin_l_bfgs_b(rosenbrock_fg,
                                  torch.full((10,), -1.2, dtype=F64),
                                  pgtol=1e-8, **CPU)
    assert info["warnflag"] == 0 and f < 1e-10
    assert info["task"].startswith("CONVERGENCE")
    np.testing.assert_allclose(x.numpy(), 1.0, atol=1e-6)
    seen = []
    x2, f2, info2 = TS.fmin_l_bfgs_b(rosenbrock_fg,
                                     torch.full((10,), -1.2, dtype=F64),
                                     pgtol=1e-8, callback=seen.append,
                                     **CPU)
    assert len(seen) == info2["nit"] == info["nit"]
    np.testing.assert_array_equal(seen[-1], x.numpy())
    assert torch.equal(x2, x) and f2 == f
    scipy = pytest.importorskip("scipy.optimize")
    rng = np.random.default_rng(7)
    q = rng.standard_normal((8, 8))
    a = q.T @ q + 8 * np.eye(8)
    b = rng.standard_normal(8)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    x, f, _ = TS.fmin_l_bfgs_b(
        lambda x: (0.5 * x @ (at @ x) - bt @ x, at @ x - bt),
        torch.zeros(8, dtype=F64), bounds=[(-0.2, 0.2)] * 8, pgtol=1e-10,
        factr=10.0, **CPU)
    xs, fs, _ = scipy.fmin_l_bfgs_b(
        lambda x: (0.5 * x @ a @ x - b @ x, a @ x - b), np.zeros(8),
        bounds=[(-0.2, 0.2)] * 8, pgtol=1e-12, factr=10.0)
    np.testing.assert_allclose(x.numpy(), xs, atol=1e-6)
    np.testing.assert_allclose(f, fs, rtol=1e-9)


def test_fmin_l_bfgs_b_bounds_and_warnflags():
    d = np.linspace(-3.0, 3.0, 6)
    x, f, info = TS.fmin_l_bfgs_b(
        lambda x: torch.sum((x - torch.as_tensor(d)) ** 2),
        torch.zeros(6, dtype=F64), approx_grad=True,
        bounds=[(-1.0, 1.0)] * 6, **CPU)
    np.testing.assert_allclose(x.numpy(), np.clip(d, -1, 1), atol=1e-6)
    assert info["warnflag"] == 0
    _, _, info = TS.fmin_l_bfgs_b(rosenbrock_fg,
                                  torch.full((10,), -1.2, dtype=F64),
                                  maxiter=2, pgtol=1e-12, **CPU)
    assert info["warnflag"] == 1 and "ITERATIONS" in info["task"]
