"""The port's per-iteration tracing (``lbfgspp_tpu_torch.utils.trace``)
against ``lbfgspp_tpu.utils.trace``.

The cases of tests/test_trace.py: a traced run equals the plain solve
bit for bit, its valid entries count the iterations and end at the
result, a batch records every instance (the JAX test vmaps), and the box
solver records the projected-gradient norm.  Against JAX's traced run in
f64 on the CPU: the same valid mask, k, nfev and status, fx to 1e-12
(relative, or absolute near the optimum).  ``debug_print_state`` prints one line per instance.
"""

import jax.numpy as jnp
import numpy as np
import torch

import lbfgspp_tpu as J
from lbfgspp_tpu.utils.objectives import rosenbrock as j_rosenbrock
from lbfgspp_tpu.utils.trace import run_traced as j_run_traced
import lbfgspp_tpu_torch as T
from lbfgspp_tpu_torch.utils.objectives import (rosenbrock,
                                                rosenbrock_chained_fg)
from lbfgspp_tpu_torch.utils.trace import debug_print_state, run_traced

F64 = torch.float64


def test_traced_matches_plain_and_jax():
    p = dict(epsilon=1e-6, max_iterations=100)
    ref = T.minimize(rosenbrock, torch.zeros(10, dtype=F64),
                     T.LBFGSParams(**p), device="cpu")
    res, trace = run_traced(T.solver(rosenbrock, T.LBFGSParams(**p),
                                     device="cpu"),
                            torch.zeros(10, dtype=F64), 30)
    assert int(res.niter) == int(ref.niter) == 22
    assert torch.equal(res.x, ref.x)
    valid = trace.valid.numpy()
    assert trace.fx.shape == (30,) and valid.sum() == int(ref.niter)
    fx = trace.fx.numpy()[valid]
    assert np.all(np.diff(fx) <= 1e-12)
    assert fx[-1] == float(ref.fx)
    assert trace.gnorm.numpy()[valid][-1] == float(ref.gnorm)
    _, jtrace = j_run_traced(J.solver(j_rosenbrock, J.LBFGSParams(**p)),
                             jnp.zeros(10), 30)
    for name in ("valid", "k", "nfev", "status"):
        np.testing.assert_array_equal(getattr(trace, name).numpy(),
                                      np.asarray(getattr(jtrace, name)))
    np.testing.assert_allclose(trace.fx.numpy(), np.asarray(jtrace.fx),
                               rtol=1e-12, atol=1e-12)


def test_traced_batch_records_every_instance():
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (4, 8)))
    s = T.solver(rosenbrock, T.LBFGSParams(epsilon=1e-6, max_iterations=50),
                 device="cpu")
    res, trace = run_traced(s, x0, 50)
    assert trace.fx.shape == (50, 4)
    for i in range(4):
        vi = trace.valid[:, i].numpy()
        assert vi.sum() == int(res.niter[i])
        assert trace.fx[:, i].numpy()[vi][-1] == float(res.fx[i])


def test_traced_box_solver_records_the_projected_norm():
    n = 10
    lb = torch.full((n,), 2.0, dtype=F64)
    ub = torch.full((n,), 4.0, dtype=F64)
    p = T.LBFGSBParams(epsilon=1e-6, max_iterations=100)
    ref = T.minimize_b(fun_and_grad=rosenbrock_chained_fg,
                       x0=torch.full((n,), 3.0, dtype=F64), lb=lb, ub=ub,
                       params=p, device="cpu")
    res, trace = run_traced(
        T.solver_b(fun_and_grad=rosenbrock_chained_fg, lb=lb, ub=ub,
                   params=p, device="cpu"),
        torch.full((n,), 3.0, dtype=F64), 100)
    assert int(res.niter) == int(ref.niter)
    valid = trace.valid.numpy()
    assert valid.sum() == int(ref.niter)
    assert trace.gnorm.numpy()[valid][-1] == float(ref.gnorm)


def test_zero_iterations_and_debug_print(capsys):
    s = T.solver(rosenbrock, T.LBFGSParams(), device="cpu")
    res, trace = run_traced(s, torch.zeros(2, 6, dtype=F64), 0)
    assert trace.fx.shape == (0, 2) and res.x.shape == (2, 6)
    debug_print_state(s.step(s.init(torch.zeros(2, 6, dtype=F64))),
                      prefix="> ")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("> iter 2: fx = ")
    assert "status = 0" in lines[0]
