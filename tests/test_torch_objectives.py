"""The port's objectives against the JAX package's: values and gradients
in f64, both the autodiff gradient of ``fun`` and the hand-written
``*_fg`` forms.  Tolerance rtol 1e-14: the same formulas, evaluated by two
libraries that may sum in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbfgspp_tpu_torch as lt
from lbfgspp_tpu.utils import objectives as jo
from lbfgspp_tpu_torch.utils import objectives as to

RTOL = 1e-14

FUNS = ["rosenbrock", "rosenbrock_split", "quadratic", "rosenbrock_chained"]
FGS = [("rosenbrock_fg", "rosenbrock"), ("quadratic_fg", "quadratic"),
       ("rosenbrock_chained_fg", "rosenbrock_chained")]


def _starts(n=12, batch=3, seed=0):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, (batch, n))


@pytest.mark.parametrize("name", FUNS)
def test_values_and_autodiff_gradients_match(name):
    x = _starts()
    jf, jg = jax.vmap(jax.value_and_grad(getattr(jo, name)))(jnp.asarray(x))
    fx, g = lt.make_fun_and_grad(getattr(to, name))(torch.as_tensor(x))
    np.testing.assert_allclose(fx.numpy(), np.asarray(jf), rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=1e-13)


@pytest.mark.parametrize("fg_name,fun_name", FGS)
def test_hand_written_gradients_match(fg_name, fun_name):
    x = _starts(seed=1)
    jf, jg = jax.vmap(getattr(jo, fg_name))(jnp.asarray(x))
    fx, g = lt.make_fun_and_grad(
        fun_and_grad=getattr(to, fg_name))(torch.as_tensor(x))
    np.testing.assert_allclose(fx.numpy(), np.asarray(jf), rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=1e-13)
    # and the hand-written gradient is the autodiff one
    _, g_ad = lt.make_fun_and_grad(getattr(to, fun_name))(torch.as_tensor(x))
    np.testing.assert_allclose(g.numpy(), g_ad.numpy(), rtol=1e-12,
                               atol=1e-12)
