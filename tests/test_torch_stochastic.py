"""The port's multi-batch L-BFGS (``lbfgspp_tpu_torch.stochastic``)
against ``lbfgspp_tpu.stochastic.minimize_stochastic``.

In f64 on the CPU with the given sample order (``key=None``; the two
libraries' random generators differ): the searched and the fixed-step
trajectories equal JAX's (x to 1e-10, fx to 1e-12 relative, the same
evaluation count); the full batch with full overlap is deterministic
L-BFGS with the backtracking search (the bar of tests/test_stochastic.py:
39, x to 1e-6); the window slides and wraps; the validation errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgspp_tpu import LBFGSParams as JP
from lbfgspp_tpu import LINESEARCH_BACKTRACKING_ARMIJO as ARMIJO
from lbfgspp_tpu.stochastic import minimize_stochastic as j_stochastic
import lbfgspp_tpu_torch as lt
from lbfgspp_tpu_torch.stochastic import minimize_stochastic

F64 = torch.float64


def logreg_data(n_rows=256, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_rows, dim))
    w = rng.standard_normal(dim)
    y = (rng.uniform(size=n_rows) < 1 / (1 + np.exp(-x @ w))).astype(float)
    return {"X": x, "y": y}


def t_loss(w, batch):
    logits = batch["X"] @ w
    return torch.mean(torch.logaddexp(torch.zeros_like(logits), logits)
                      - batch["y"] * logits) + 1e-3 * torch.sum(w ** 2)


def j_loss(w, batch):
    logits = batch["X"] @ w
    return jnp.mean(jnp.logaddexp(0.0, logits) - batch["y"] * logits) \
        + 1e-3 * jnp.sum(w ** 2)


def as_t(data):
    return {k: torch.as_tensor(v) for k, v in data.items()}


def as_j(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


@pytest.mark.parametrize("step_size", [None, 0.5])
def test_trajectory_matches_jax(step_size):
    data = logreg_data()
    kw = dict(m=4, max_iterations=25, linesearch=ARMIJO)
    jr = j_stochastic(j_loss, jnp.zeros(8), as_j(data), JP(**kw),
                      batch_size=64, overlap_frac=0.25, step_size=step_size)
    tr = minimize_stochastic(t_loss, torch.zeros(8, dtype=F64), as_t(data),
                             lt.LBFGSParams(**kw), batch_size=64,
                             overlap_frac=0.25, step_size=step_size,
                             device="cpu")
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(float(tr.fx), float(jr.fx), rtol=1e-12)
    np.testing.assert_allclose(float(tr.gnorm), float(jr.gnorm), rtol=1e-9)
    assert int(tr.nfev) == int(jr.nfev)
    assert int(tr.niter) == 25 and int(tr.status) == lt.Status.MAX_ITERATIONS
    assert int(tr.history.ncorr) == int(jr.history.ncorr) > 0
    assert int(tr.nskip) == 0


def test_full_batch_full_overlap_is_deterministic_lbfgs():
    data = as_t(logreg_data(n_rows=128, dim=6, seed=1))
    p = lt.LBFGSParams(m=6, max_iterations=30, linesearch=ARMIJO)
    res_s = minimize_stochastic(t_loss, torch.zeros(6, dtype=F64), data, p,
                                batch_size=128, overlap_frac=1.0,
                                device="cpu")
    res_d = lt.minimize(
        lambda w: t_loss(w, data), torch.zeros(6, dtype=F64),
        lt.LBFGSParams(m=6, max_iterations=30, epsilon=0.0, epsilon_rel=0.0,
                       linesearch=ARMIJO),
        line_search="backtracking", device="cpu")
    np.testing.assert_allclose(res_s.x.numpy(), res_d.x.numpy(), atol=1e-6)
    np.testing.assert_allclose(float(res_s.fx), float(res_d.fx), rtol=1e-12)


def test_window_slides_and_wraps():
    """N=8, b=4, o=2: the k-th batch is rows [2k % 8, 2k % 8 + 4) of the
    cycled order, its overlap the last two of them."""
    n, b, o = 8, 4, 2
    seen = []

    def loss(w, batch):
        seen.append(batch["row"].tolist())
        return torch.sum(w ** 2) * (1.0 + 0.0 * batch["row"].sum())

    minimize_stochastic(loss, torch.ones(2, dtype=F64),
                        {"row": torch.arange(n, dtype=F64)},
                        lt.LBFGSParams(m=2, max_iterations=5),
                        batch_size=b, overlap_frac=o / b, step_size=0.1,
                        device="cpu")
    # per step: the batch at x, the batch at x1, the overlap at x1 and x
    batches = seen[0::4]
    assert batches == [[0, 1, 2, 3], [2, 3, 4, 5], [4, 5, 6, 7],
                       [6, 7, 0, 1], [0, 1, 2, 3]]
    assert seen[2::4] == [r[2:] for r in batches]


def test_generator_shuffles_once_and_repeats():
    data = as_t(logreg_data(n_rows=64, dim=4, seed=2))
    p = lt.LBFGSParams(m=3, max_iterations=6)

    def run(seed):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return minimize_stochastic(t_loss, torch.zeros(4, dtype=F64), data,
                                   p, batch_size=16, step_size=0.5,
                                   generator=g, device="cpu").x

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(None))


def test_pytree_parameters():
    data = as_t(logreg_data(n_rows=128, dim=6, seed=5))

    def loss_tree(t, batch):
        return t_loss(t["w"] * t["scale"], batch)

    t0 = {"w": torch.zeros(6, dtype=F64), "scale": torch.ones((), dtype=F64)}
    res = minimize_stochastic(loss_tree, t0, data,
                              lt.LBFGSParams(m=4, max_iterations=40),
                              batch_size=32, step_size=0.5, device="cpu")
    assert set(res.x) == {"w", "scale"} and res.x["scale"].shape == ()
    assert float(loss_tree(res.x, data)) < 0.8 * float(loss_tree(t0, data))


def test_validation():
    data = {"X": torch.zeros(10, 2)}

    def fun(w, b):
        return torch.sum(w ** 2)

    with pytest.raises(ValueError):
        minimize_stochastic(fun, torch.zeros(2), data,
                            lt.LBFGSParams(max_iterations=0), batch_size=4,
                            device="cpu")
    with pytest.raises(ValueError):
        minimize_stochastic(fun, torch.zeros(2), data,
                            lt.LBFGSParams(max_iterations=5), batch_size=11,
                            device="cpu")
    with pytest.raises(ValueError):
        minimize_stochastic(fun, torch.zeros(2), data,
                            lt.LBFGSParams(max_iterations=5), batch_size=4,
                            overlap_frac=0.0, device="cpu")
    with pytest.raises(ValueError):
        minimize_stochastic(fun, torch.zeros(2),
                            {"X": torch.zeros(10, 2), "y": torch.zeros(9)},
                            lt.LBFGSParams(max_iterations=5), batch_size=4,
                            device="cpu")
