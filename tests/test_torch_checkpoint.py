"""The port's state serialization (``lbfgspp_tpu_torch.utils.checkpoint``)
against ``lbfgspp_tpu.utils.checkpoint``.

The case of tests/test_batch_checkpoint.py: a state saved mid-solve and
restored into a template resumes bit for bit (here for L-BFGS, L-BFGS-B
and OWL-QN states, and for an f32 solve whose history stores bf16 rows).
Across the packages: a state saved by the JAX module (no batch axis; its
f64 leaves, and bf16 rows stored by numpy as raw 2-byte values) loads
into the port's state, resumes, and ends as JAX's own resumed run does in
f64 on the CPU (the same iteration count, x to 1e-10); the keys the two
modules write are the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbfgspp_tpu as J
from lbfgspp_tpu.utils import checkpoint as JC
from lbfgspp_tpu.utils.objectives import rosenbrock as j_rosenbrock
import lbfgspp_tpu_torch as T
from lbfgspp_tpu_torch.utils import checkpoint as TC
from lbfgspp_tpu_torch.utils.objectives import rosenbrock, rosenbrock_fg

F64 = torch.float64


def _assert_equal_states(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _assert_equal_states(x, y)
        elif x is None:
            assert y is None
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("kind", ["lbfgs", "lbfgsb", "owlqn", "bf16 rows"])
def test_roundtrip_resumes_bit_for_bit(kind, tmp_path):
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (3, 6)))
    if kind == "lbfgsb":
        s = T.solver_b(rosenbrock, -torch.ones(6, dtype=F64),
                       torch.full((6,), 0.8, dtype=F64),
                       T.LBFGSBParams(epsilon=1e-8), device="cpu")
    elif kind == "owlqn":
        from lbfgspp_tpu_torch import owlqn
        res = owlqn.minimize_owlqn(rosenbrock, x0, 0.01,
                                   T.LBFGSParams(max_iterations=5),
                                   device="cpu")
        path = str(tmp_path / "result.npz")
        TC.save_state(path, res)
        _assert_equal_states(TC.load_state(path, res), res)
        return
    else:
        s = T.solver(rosenbrock, T.LBFGSParams(epsilon=1e-8),
                     direction="rinv", device="cpu",
                     history_dtype=torch.bfloat16 if kind == "bf16 rows"
                     else None)
        if kind == "bf16 rows":
            x0 = x0.float()
    state = s.init(x0)
    for _ in range(6):
        state = s.step(state)
    path = str(tmp_path / "state.npz")
    TC.save_state(path, state)
    restored = TC.load_state(path, s.init(x0))
    _assert_equal_states(restored, state)
    ref = s.finalize(s.run(state))
    got = s.finalize(s.run(restored))
    assert torch.equal(got.niter, ref.niter) and torch.equal(got.x, ref.x)


@pytest.mark.parametrize("history_dtype", [None, "bfloat16"])
def test_a_state_saved_by_jax_resumes_in_the_port(history_dtype, tmp_path):
    jdt = None if history_dtype is None else jnp.bfloat16
    tdt = None if history_dtype is None else torch.bfloat16
    p = dict(epsilon=1e-8, max_iterations=200)
    js = J.solver(j_rosenbrock, J.LBFGSParams(**p), history_dtype=jdt)
    jstate = js.init(jnp.zeros(10))
    for _ in range(6):
        jstate = js.step(jstate)
    path = str(tmp_path / "jax_state.npz")
    JC.save_state(path, jstate)
    jref = js.finalize(js.run(jstate))

    ts = T.solver(fun_and_grad=rosenbrock_fg, params=T.LBFGSParams(**p),
                  history_dtype=tdt, device="cpu")
    template = ts.init(torch.zeros(10, dtype=F64))
    state = TC.load_state(path, template)
    assert state.x.shape == (1, 10)
    assert state.hist.s.dtype == (tdt or F64)
    np.testing.assert_array_equal(state.hist.s[0].double().numpy(),
                                  np.asarray(jstate.hist.s.astype(
                                      jnp.float64)))
    assert set(TC.state_to_arrays(state)) == set(JC.state_to_arrays(jstate))
    res = ts.finalize(ts.run(state))
    assert int(res.niter[0]) == int(jref.niter)
    np.testing.assert_allclose(res.x[0].numpy(), np.asarray(jref.x), rtol=0,
                               atol=1e-10)


def test_a_mismatched_template_raises(tmp_path):
    s = T.solver(rosenbrock, T.LBFGSParams(), device="cpu")
    path = str(tmp_path / "state.npz")
    TC.save_state(path, s.init(torch.zeros(2, 6, dtype=F64)))
    with pytest.raises(ValueError, match="template"):
        TC.load_state(path, s.init(torch.zeros(3, 6, dtype=F64)))
