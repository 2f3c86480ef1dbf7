"""The port's optimizer front end (``lbfgspp_tpu_torch.optax_compat``)
against ``lbfgspp_tpu.optax_compat``.

The cases of tests/test_optax_compat.py in PyTorch's idiom: K calls of
``step(closure)`` are K solver iterations (the iterates equal the solver's
bit for bit, and JAX's optax loop's to 1e-12 in f64 on the CPU: the same
arithmetic summed in another order), the loop converges with the solver's
iteration count and status and then leaves the parameters unchanged, a
closure is evaluated only at the line search's trials, several parameter
tensors ravel like a tree, and ``history_dtype`` stores bf16 rows as the
JAX optimizer does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lbfgspp_tpu as J
from lbfgspp_tpu import optax_compat as JO
import lbfgspp_tpu_torch as T
from lbfgspp_tpu_torch import optax_compat as TO

F64 = torch.float64


def j_rosen(x):
    xe, xo = x[0::2], x[1::2]
    return jnp.sum((1 - xe) ** 2 + (10 * (xo - xe * xe)) ** 2)


def t_rosen(x):
    xe, xo = x[0::2], x[1::2]
    return torch.sum((1 - xe) ** 2 + (10 * (xo - xe * xe)) ** 2)


QUARTIC_T = np.linspace(-1.0, 1.0, 10)
QUARTIC_C = np.linspace(0.2, 2.0, 10)


def j_quartic(x):
    e = x - jnp.asarray(QUARTIC_T)
    return jnp.sum(jnp.asarray(QUARTIC_C) * e ** 4 + 0.5 * e ** 2)


def t_quartic(x):
    e = x - torch.as_tensor(QUARTIC_T)
    return torch.sum(torch.as_tensor(QUARTIC_C) * e ** 4 + 0.5 * e ** 2)


def _jax_loop(params, x0, steps, history_dtype=None, loss=j_rosen):
    opt = JO.lbfgs(params, history_dtype=history_dtype)

    @jax.jit
    def step(x, state):
        value, grad = jax.value_and_grad(loss)(x)
        updates, state = opt.update(grad, state, x, value=value, grad=grad,
                                    value_fn=loss)
        return optax.apply_updates(x, updates), state

    state, x, traj = opt.init(x0), x0, []
    for _ in range(steps):
        x, state = step(x, state)
        traj.append(np.asarray(x))
    return traj, state


def _torch_loop(params, n, steps, history_dtype=None, counter=None,
                loss_fn=t_rosen):
    x = torch.zeros(n, dtype=F64, requires_grad=True)
    opt = TO.LBFGS([x], params, history_dtype=history_dtype)

    def closure():
        opt.zero_grad()
        loss = loss_fn(x)
        loss.backward()
        if counter is not None:
            counter[0] += 1
        return loss

    traj = []
    for _ in range(steps):
        opt.step(closure)
        traj.append(x.detach().numpy().copy())
    return traj, opt, closure, x


@pytest.fixture(scope="module")
def jax_loops():
    p = J.LBFGSParams(epsilon=1e-6, max_iterations=100)
    return {None: _jax_loop(p, jnp.zeros(10), 30),
            "bf16": _jax_loop(J.LBFGSParams(epsilon=1e-7, epsilon_rel=0.0),
                              jnp.zeros(10), 30, jnp.bfloat16, j_quartic)}


def test_matches_solver_trajectory_and_jax(jax_loops):
    """K steps == K Solver.step calls (bit for bit), and JAX's loop."""
    p = T.LBFGSParams(epsilon=1e-10, epsilon_rel=0.0)
    traj, _, _, _ = _torch_loop(p, 10, 8)
    s = T.solver(t_rosen, p, device="cpu")
    st = s.init(torch.zeros(10, dtype=F64))
    for k in range(8):
        st = s.step(st)
        np.testing.assert_array_equal(traj[k], st.x[0].numpy())
    jtraj = jax_loops[None][0]
    for k in range(8):
        np.testing.assert_allclose(traj[k], jtraj[k], rtol=0, atol=1e-12)


def test_converges_and_goes_quiescent(jax_loops):
    p = T.LBFGSParams(epsilon=1e-6, max_iterations=100)
    evals = [0]
    traj, opt, closure, x = _torch_loop(p, 10, 30, counter=evals)
    jtraj, jstate = jax_loops[None]
    ref = T.minimize(t_rosen, torch.zeros(10, dtype=F64), p, device="cpu")
    assert int(TO.status(opt)) == int(JO.status(jstate)) == \
        int(T.Status.CONVERGED_GRAD)
    assert int(TO.niter(opt)) == int(JO.niter(jstate)) == \
        int(ref.niter) == 22
    np.testing.assert_array_equal(traj[-1], ref.x.numpy())
    np.testing.assert_allclose(traj[-1], jtraj[-1], rtol=0, atol=1e-12)
    # one evaluation at the start, then the searches' trials: the
    # solver's own count
    assert evals[0] == int(ref.nfev)
    # after termination a step changes nothing and evaluates nothing
    before = x.detach().clone()
    opt.step(closure)
    assert torch.equal(x.detach(), before) and evals[0] == int(ref.nfev)


def test_history_dtype_stores_bf16_rows_like_jax(jax_loops):
    """On a separable quartic (Rosenbrock's trajectories part wherever a
    difference in the last bit moves a bf16 rounding) every iterate
    agrees with JAX's to 1e-10, and so do the count and status."""
    p = T.LBFGSParams(epsilon=1e-7, epsilon_rel=0.0)
    traj, opt, _, _ = _torch_loop(p, 10, 30, history_dtype=torch.bfloat16,
                                  loss_fn=t_quartic)
    jtraj, jstate = jax_loops["bf16"]
    assert opt.inner.hist.s.dtype == torch.bfloat16
    assert jstate.inner.hist.s.dtype == jnp.bfloat16
    assert int(TO.niter(opt)) == int(JO.niter(jstate)) < 30
    assert int(TO.status(opt)) == int(JO.status(jstate)) == \
        int(T.Status.CONVERGED_GRAD)
    for k in range(30):
        np.testing.assert_allclose(traj[k], jtraj[k], rtol=0, atol=1e-10)


def test_several_parameter_tensors():
    a = torch.zeros(3, dtype=F64, requires_grad=True)
    w = torch.ones(2, 2, dtype=F64, requires_grad=True)
    opt = TO.LBFGS([a, w], T.LBFGSParams(epsilon=1e-10, epsilon_rel=0.0))

    def closure():
        opt.zero_grad()
        loss = torch.sum((a - 1.5) ** 2) + torch.sum(0.5 * (w + 2.0) ** 2)
        loss.backward()
        return loss

    for _ in range(20):
        opt.step(closure)
    np.testing.assert_allclose(a.detach().numpy(), 1.5, atol=1e-9)
    np.testing.assert_allclose(w.detach().numpy(), -2.0, atol=1e-9)
    assert int(TO.status(opt)) == int(T.Status.CONVERGED_GRAD)


def test_requires_a_closure_and_one_dtype():
    x = torch.zeros(4, dtype=F64, requires_grad=True)
    with pytest.raises(ValueError, match="closure"):
        TO.LBFGS([x]).step(None)
    with pytest.raises(ValueError, match="one dtype"):
        TO.LBFGS([x, torch.zeros(2, requires_grad=True)])
