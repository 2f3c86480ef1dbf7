"""The port's ``implicit_minimize_sharded`` on two gloo ranks against the
JAX package's on a 2-device CPU mesh, in f64: the hypergradient
``d (sum(x*(theta)^2) + f(x*)) / d theta``, the value counted once on
every rank as in JAX, of tests/test_collective_audit.py's partial
objective ``sum 0.5 (x - theta)^2 + 0.1 (x - theta)^4`` with a ridge
``0.05 x^2``, so that ``f(x*)`` moves with theta, with and
without the preconditioner against JAX's preconditioned one (one
compile), to 1e-8 (the adjoint CG stops at its f64 tolerance 1e-8), and
the forward solve's iteration count equal to JAX's.  With the solve's
value in the loss, an objective with collectives inside (a ridge
logistic regression through ``local_fun_and_grad``) and the partial one
give the port's unsplit ``implicit_minimize``'s gradient to 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch

import lbfgspp_tpu as J
from lbfgspp_tpu.diff import implicit_minimize_sharded
import lbfgspp_tpu_torch as T
from lbfgspp_tpu_torch.tools import spawn_ranks

N, WORLD = 32, 2
RNG = np.random.default_rng(3)
THETA = RNG.uniform(-1.0, 1.0, N)
A = RNG.standard_normal((24, N)) / np.sqrt(N)
B = np.sign(A @ RNG.standard_normal(N))
LAM = 0.3


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks.run("lbfgspp_tpu_torch.tools.sharded_cases:implicits",
                           WORLD, args=(THETA, A, B, LAM), timeout=240)


def jax_hypergradient(precondition):
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("feat",))
    k = N // WORLD

    def local_fun(x_l, th):
        i = jax.lax.axis_index("feat")
        r = x_l - jax.lax.dynamic_slice_in_dim(th, i * k, k)
        return jnp.sum(0.5 * r ** 2 + 0.1 * r ** 4 + 0.05 * x_l ** 2)

    p = J.LBFGSParams(epsilon=1e-8, max_iterations=50)

    def loss(th):
        res = implicit_minimize_sharded(local_fun, jnp.zeros(N), th, p,
                                        mesh=mesh, precondition=precondition)
        return jnp.sum(res.x ** 2) + res.fx, res.niter

    (_, niter), grad = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(THETA))
    return int(niter), np.asarray(grad)


@pytest.fixture(scope="module")
def reference():
    return jax_hypergradient(True)


@pytest.mark.parametrize("precondition", [True, False])
def test_hypergradient_matches_jax(ranks, reference, precondition):
    niter, want = reference
    for rank in ranks:
        got = rank[precondition]
        assert int(got["niter"]) == niter
        np.testing.assert_allclose(got["grad"], want, rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(ranks[0][precondition]["grad"],
                                  ranks[1][precondition]["grad"])


def _unsplit(fun, theta, eps):
    theta = torch.as_tensor(theta, dtype=torch.float64).clone()
    theta.requires_grad_(True)
    res = T.implicit_minimize(fun, torch.zeros(N, dtype=torch.float64),
                              theta, T.LBFGSParams(epsilon=eps,
                                                   max_iterations=200),
                              device="cpu")
    ((res.x ** 2).sum() + res.fx).backward()
    return res, theta.grad


@pytest.mark.parametrize("case", ["ridge", "partial_fx"])
def test_value_in_the_loss_matches_unsplit(ranks, case):
    """The loss ``sum(x*^2) + f(x*)``, each rank's holding its block and
    the replicated ``f`` once: the ridge logistic regression with
    collectives inside the objective (``local_fun_and_grad``, its
    Hessian-vector products reverse mode through them) and the partial
    objective give
    the unsplit ``implicit_minimize``'s gradient to 1e-8."""
    a, b = torch.as_tensor(A), torch.as_tensor(B)
    if case == "ridge":
        def fun(w, lam):
            z = -b * (a @ w)
            return torch.logaddexp(torch.zeros_like(z), z).sum() + \
                0.5 * lam * (w * w).sum()
        res, want = _unsplit(fun, LAM, 1e-10)
    else:
        def fun(x, th):
            r = x - th
            return torch.sum(0.5 * r * r + 0.1 * r ** 4 + 0.05 * x * x)
        res, want = _unsplit(fun, THETA, 1e-8)
    for rank in ranks:
        got = rank[case]
        assert int(got["niter"]) == int(res.niter)
        np.testing.assert_allclose(got["grad"], want.numpy(), rtol=1e-8,
                                   atol=1e-12)
    np.testing.assert_allclose(
        np.concatenate([r[case]["x"] for r in ranks]),
        res.x.detach().numpy(), rtol=1e-10, atol=1e-12)
