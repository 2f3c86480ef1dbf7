"""The port's implicit differentiation (``lbfgspp_tpu_torch.diff``)
against ``lbfgspp_tpu.diff.implicit_minimize``.

The cases of tests/test_implicit.py:20-165 (the unsharded ones): closed
forms, the envelope theorem, the box active set, central finite
differences, the ``fun_and_grad`` oracle, a batch of thetas and the
unpreconditioned adjoint.  Inputs are made from a numpy seed and go
through both packages in f64 on the CPU.  Tolerance: the theta gradients
agree with JAX's to 1e-10 (absolute, or relative where stated); the
ground truths hold at the JAX test's own bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgspp_tpu import LBFGSParams as JP, LBFGSBParams as JPB
from lbfgspp_tpu.diff import implicit_minimize as j_implicit
import lbfgspp_tpu_torch as lt
from lbfgspp_tpu_torch import diff
from lbfgspp_tpu_torch.diff import implicit_minimize

P = dict(epsilon=1e-10, epsilon_rel=0.0, max_iterations=200)
TOL = 1e-10
F64 = torch.float64


def t_grad(loss, theta):
    """d loss / d theta of the port, theta a numpy array."""
    th = torch.as_tensor(theta, dtype=F64).requires_grad_()
    loss(th).backward()
    return th.grad.numpy()


def test_identity_map_quadratic():
    theta = np.linspace(-1.0, 2.0, 6)
    g = t_grad(lambda th: implicit_minimize(
        lambda x, t: 0.5 * torch.sum((x - t) ** 2),
        torch.zeros(6, dtype=F64), th, lt.LBFGSParams(**P),
        device="cpu").x.sum(), theta)
    gj = jax.grad(lambda th: jnp.sum(j_implicit(
        lambda x, t: 0.5 * jnp.sum((x - t) ** 2), jnp.zeros(6), th,
        JP(**P)).x))(jnp.asarray(theta))
    np.testing.assert_allclose(g, np.asarray(gj), rtol=0, atol=TOL)
    np.testing.assert_allclose(g, 1.0, atol=1e-6)


def test_nonseparable_quadratic_matches_closed_form():
    rng = np.random.default_rng(0)
    n = 8
    b = rng.standard_normal((n, n))
    a = b @ b.T + n * np.eye(n)
    c = rng.standard_normal(n)
    theta = rng.standard_normal(n)
    at, ct = torch.as_tensor(a), torch.as_tensor(c)
    g = t_grad(lambda th: ct @ implicit_minimize(
        lambda x, t: 0.5 * x @ (at @ x) - t @ x, torch.zeros(n, dtype=F64),
        th, lt.LBFGSParams(**P), device="cpu").x, theta)
    aj, cj = jnp.asarray(a), jnp.asarray(c)
    gj = jax.grad(lambda th: cj @ j_implicit(
        lambda x, t: 0.5 * x @ (aj @ x) - t @ x, jnp.zeros(n), th,
        JP(**P)).x)(jnp.asarray(theta))
    np.testing.assert_allclose(g, np.asarray(gj), rtol=0, atol=TOL)
    np.testing.assert_allclose(g, np.linalg.solve(a, c), rtol=1e-5,
                               atol=1e-7)


def test_fx_envelope_theorem():
    theta = np.array([0.3, -1.2, 0.7])
    g = t_grad(lambda th: implicit_minimize(
        lambda x, t: 0.5 * torch.sum((x - t) ** 2) + 0.25 * torch.sum(t ** 2),
        torch.zeros(3, dtype=F64), th, lt.LBFGSParams(**P),
        device="cpu").fx, theta)
    gj = jax.grad(lambda th: j_implicit(
        lambda x, t: 0.5 * jnp.sum((x - t) ** 2) + 0.25 * jnp.sum(t ** 2),
        jnp.zeros(3), th, JP(**P)).fx)(jnp.asarray(theta))
    np.testing.assert_allclose(g, np.asarray(gj), rtol=0, atol=TOL)
    np.testing.assert_allclose(g, 0.5 * theta, atol=1e-6)


def test_box_active_set_zeroing():
    theta = np.array([-2.0, -0.5, 0.0, 0.5, 3.0])
    lb, ub = np.full(5, -1.0), np.full(5, 1.0)

    def loss(th):
        res = implicit_minimize(
            lambda x, t: 0.5 * torch.sum((x - t) ** 2),
            torch.zeros(5, dtype=F64), th, lt.LBFGSBParams(**P),
            lb=torch.as_tensor(lb), ub=torch.as_tensor(ub), device="cpu")
        np.testing.assert_allclose(res.x.detach().numpy(),
                                   np.clip(theta, -1.0, 1.0), atol=1e-8)
        return res.x.sum()

    g = t_grad(loss, theta)
    gj = jax.grad(lambda th: jnp.sum(j_implicit(
        lambda x, t: 0.5 * jnp.sum((x - t) ** 2), jnp.zeros(5), th,
        JPB(**P), lb=jnp.asarray(lb), ub=jnp.asarray(ub)).x))(
        jnp.asarray(theta))
    np.testing.assert_allclose(g, np.asarray(gj), rtol=0, atol=TOL)
    np.testing.assert_allclose(g, [0.0, 1.0, 1.0, 1.0, 0.0], atol=1e-6)


def test_ridge_logreg_hyperparam_vs_finite_differences():
    rng = np.random.default_rng(1)
    n, d = 40, 6
    a, av = rng.standard_normal((n, d)), rng.standard_normal((n, d))
    y = np.sign(rng.standard_normal(n))
    yv = np.sign(rng.standard_normal(n))
    at, avt, yt, yvt = (torch.as_tensor(v) for v in (a, av, y, yv))

    def f(w, loglam):
        z = yt * (at @ w)
        return torch.mean(torch.log1p(torch.exp(-z))) \
            + 0.5 * torch.exp(loglam) * torch.sum(w ** 2)

    def val_loss(loglam):
        w = implicit_minimize(f, torch.zeros(d, dtype=F64), loglam,
                              lt.LBFGSParams(**P), device="cpu").x
        return torch.mean(torch.log1p(torch.exp(-yvt * (avt @ w))))

    aj, avj, yj, yvj = (jnp.asarray(v) for v in (a, av, y, yv))

    def jf(w, loglam):
        z = yj * (aj @ w)
        return jnp.mean(jnp.log1p(jnp.exp(-z))) \
            + 0.5 * jnp.exp(loglam) * jnp.sum(w ** 2)

    def j_val_loss(loglam):
        w = j_implicit(jf, jnp.zeros(d), loglam, JP(**P)).x
        return jnp.mean(jnp.log1p(jnp.exp(-yvj * (avj @ w))))

    g = float(t_grad(val_loss, np.float64(-1.0)))
    gj = float(jax.grad(j_val_loss)(jnp.asarray(-1.0)))
    assert abs(g - gj) <= TOL * max(1.0, abs(gj)), (g, gj)
    eps = 1e-5
    with torch.no_grad():
        fd = (float(val_loss(torch.tensor(-1.0 + eps, dtype=F64)))
              - float(val_loss(torch.tensor(-1.0 - eps, dtype=F64)))) \
            / (2 * eps)
    assert abs(g - fd) <= 1e-5 * max(1.0, abs(fd)), (g, fd)


def test_fun_and_grad_path():
    theta = np.array([1.0, -2.0, 0.5])
    g = t_grad(lambda th: implicit_minimize(
        fun_and_grad=lambda x, t: (0.5 * torch.sum((x - t) ** 2), x - t),
        x0=torch.zeros(3, dtype=F64), theta=th, params=lt.LBFGSParams(**P),
        device="cpu").x.sum(), theta)
    gj = jax.grad(lambda th: jnp.sum(j_implicit(
        fun_and_grad=lambda x, t: (0.5 * jnp.sum((x - t) ** 2), x - t),
        x0=jnp.zeros(3), theta=th, params=JP(**P)).x))(jnp.asarray(theta))
    np.testing.assert_allclose(g, np.asarray(gj), rtol=0, atol=TOL)
    np.testing.assert_allclose(g, 1.0, atol=1e-6)


def test_batched_theta_matches_vmapped_jax():
    """A batch of thetas is one batched solve and one lockstep adjoint;
    each instance's gradient equals the vmapped JAX one."""
    thetas = np.random.default_rng(2).standard_normal((4, 5))
    g = t_grad(lambda th: (implicit_minimize(
        lambda x, t: 0.5 * torch.sum((x - t) ** 2),
        torch.zeros(4, 5, dtype=F64), th, lt.LBFGSParams(**P),
        device="cpu").x ** 2).sum(), thetas)
    gj = jax.vmap(jax.grad(lambda th: jnp.sum(j_implicit(
        lambda x, t: 0.5 * jnp.sum((x - t) ** 2), jnp.zeros(5), th,
        JP(**P)).x ** 2)))(jnp.asarray(thetas))
    np.testing.assert_allclose(g, np.asarray(gj), rtol=0, atol=TOL)
    np.testing.assert_allclose(g, 2.0 * thetas, atol=1e-6)


@pytest.mark.parametrize("precondition", [True, False])
def test_precondition_or_not_matches_jax(precondition):
    theta = np.array([0.4, -0.8, 1.3])

    def f(x, t):
        return 0.5 * torch.sum((x - t) ** 2) + 0.1 * torch.sum(x ** 4)

    def jf(x, t):
        return 0.5 * jnp.sum((x - t) ** 2) + 0.1 * jnp.sum(x ** 4)

    diff.COUNTS.clear()
    g = t_grad(lambda th: implicit_minimize(
        f, torch.zeros(3, dtype=F64), th, lt.LBFGSParams(**P),
        precondition=precondition, device="cpu").x.sum(), theta)
    assert diff.COUNTS["cg_iterations"] > 0
    gj = jax.grad(lambda th: jnp.sum(j_implicit(
        jf, jnp.zeros(3), th, JP(**P), precondition=precondition).x))(
        jnp.asarray(theta))
    np.testing.assert_allclose(g, np.asarray(gj), rtol=0, atol=TOL)


def test_cg_freezes_instances_and_zero_rhs():
    """The lockstep CG: an instance with b = 0 (every coordinate active)
    gives 0, not NaN; every instance solves its own system."""
    rng = np.random.default_rng(3)
    mats = rng.standard_normal((3, 6, 6))
    mats = torch.as_tensor(mats @ mats.transpose(0, 2, 1) + 6 * np.eye(6))
    b = torch.as_tensor(rng.standard_normal((3, 6)))
    b[1] = 0.0
    x = diff.cg(lambda u: torch.einsum("bij,bj->bi", mats, u), b, 1e-12,
                100)
    want = torch.linalg.solve(mats, b)
    assert torch.isfinite(x).all()
    np.testing.assert_array_equal(x[1].numpy(), 0.0)
    np.testing.assert_allclose(x.numpy(), want.numpy(), atol=1e-10)


def test_validation_errors():
    def f(x, t):
        return torch.sum(x ** 2)

    with pytest.raises(ValueError, match="exactly one"):
        implicit_minimize(x0=torch.zeros(2), theta=torch.zeros(2),
                          device="cpu")
    with pytest.raises(ValueError, match="both lb and ub"):
        implicit_minimize(f, torch.zeros(2), torch.zeros(2),
                          lb=torch.zeros(2), device="cpu")


@pytest.mark.parametrize("precondition", [True, False])
def test_cg_counts_per_instance_match_jax_cg(precondition):
    """The adjoint CG's iterations, instance by instance, in f32: the
    port's ``diff.cg`` against ``jax.scipy.sparse.linalg.cg`` (the JAX
    package's unsharded backward, lbfgspp_tpu/diff.py:196-221) on the same
    ridge logistic regressions (chip_smoke.py phase 17's problem at a
    tiny size), from the same solution and history, with the two-loop
    preconditioner or without.  The counts are equal, so a lockstep count
    that grows with the preconditioner (the slowest instance's) is the
    reference's own behaviour.  JAX's count is its Hessian-vector
    products less the one of ``r0 = b - A x0``."""
    from lbfgspp_tpu.ops import history as JH
    from lbfgspp_tpu_torch.ops import history as TH

    batch, rows, d = 6, 48, 12
    rng = np.random.default_rng(5)

    def data():
        return (torch.as_tensor(rng.standard_normal((batch, rows, d)),
                                dtype=torch.float32),
                torch.as_tensor(np.sign(rng.standard_normal((batch, rows))),
                                dtype=torch.float32))
    (a, y), (av, yv) = data(), data()
    loglam = torch.linspace(-4.0, 0.0, batch)

    def ridge(w, th):
        z = th["y"] * (th["A"] @ w)
        return torch.logaddexp(torch.zeros_like(z), -z).mean() + \
            0.5 * torch.exp(th["loglam"]) * (w * w).sum()

    theta = {"loglam": loglam, "A": a, "y": y}
    res = implicit_minimize(
        ridge, torch.zeros(batch, d), theta,
        lt.LBFGSParams(epsilon=1e-5, epsilon_rel=0.0, max_iterations=200),
        device="cpu")
    x = res.x.detach()
    xv = x.clone().requires_grad_()
    z = yv * (av @ xv[:, :, None])[:, :, 0]
    torch.logaddexp(torch.zeros_like(z), -z).mean(1).sum().backward()
    rhs, hist = xv.grad.detach(), res.history
    tol, maxiter = 3e-6, 200          # both packages' f32 defaults

    calls = [0]

    def count(_):
        calls[0] += 1

    def j_ridge(w, ai, yi, li):
        zz = yi * (ai @ w)
        return jnp.logaddexp(0.0, -zz).mean() + 0.5 * jnp.exp(li) * \
            jnp.sum(w * w)

    @jax.jit
    def j_cg(xi, ai, yi, li, h, b):
        def amat(u):
            jax.debug.callback(count, u[0])
            return jax.jvp(lambda xx: jax.grad(j_ridge)(xx, ai, yi, li),
                           (xi,), (u,))[1]
        minv = (lambda r: JH.apply_hv(h, r, 1.0)) if precondition else None
        return jax.scipy.sparse.linalg.cg(amat, b, tol=tol, maxiter=maxiter,
                                          M=minv)[0]

    j_counts, t_counts = [], []
    for i in range(batch):
        calls[0] = 0
        jax.block_until_ready(j_cg(
            *(jnp.asarray(t[i].numpy()) for t in (x, a, y, loglam)),
            JH.LBFGSHistory(*(None if t is None else jnp.asarray(t[i].numpy())
                              for t in hist)),
            jnp.asarray(rhs[i].numpy())))
        j_counts.append(calls[0] - 1)
        th_i = {k: v[i:i + 1] for k, v in theta.items()}
        h_i = TH.LBFGSHistory(*(None if t is None else t[i:i + 1]
                                for t in hist))

        def amat(u):
            return torch.func.vmap(
                lambda xx, th, uu: torch.func.jvp(
                    lambda w: torch.func.grad(ridge)(w, th), (xx,),
                    (uu,))[1])(x[i:i + 1], th_i, u)
        minv = (lambda r: TH.apply_hv(h_i, r, 1.0)) if precondition else None
        diff.COUNTS.clear()
        diff.cg(amat, rhs[i:i + 1], tol, maxiter, minv)
        t_counts.append(diff.COUNTS["cg_iterations"])
    assert min(j_counts) > 0
    assert t_counts == j_counts
