"""``history_dtype``: the port's entry points with the (s, y) rows stored
in bfloat16, against the JAX package's.

The JAX package stores the rows at ``store_dtype`` and keeps every
product, Gram and coefficient in the solve dtype, widening the rows per
element (lbfgspp_tpu/ops/history.py:81-104, :197-198, :336-418).  The
port does the same, widening in chunks along n where its plain version
reads the rows.  In f64 on the CPU both libraries round each row to bf16
identically (one rounding of the f64 value, bit for bit), so the solves
agree as the f64 solves do: the same iteration and evaluation counts and
statuses, x to 1e-10 (the same arithmetic summed in another order, at an
epsilon above the point where the two orders part).  The f32 and bf16
bars are the repo's own: tests/test_mixed_history.py and
tests/test_dtypes.py:25-31.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbfgspp_tpu as J
from lbfgspp_tpu.ops import history as JH
from lbfgspp_tpu.owlqn import minimize_owlqn as j_owlqn
from lbfgspp_tpu.stochastic import minimize_stochastic as j_stochastic
from lbfgspp_tpu.utils.objectives import rosenbrock as j_rosenbrock
from lbfgspp_tpu.utils.objectives import rosenbrock_fg as j_rosenbrock_fg
import lbfgspp_tpu_torch as T
from lbfgspp_tpu_torch.ops import fused
from lbfgspp_tpu_torch.ops import history as TH
from lbfgspp_tpu_torch.utils.objectives import rosenbrock as t_rosenbrock
from lbfgspp_tpu_torch.utils.objectives import rosenbrock_fg
from test_torch_lbfgs import _coefficients, make_fg

BF16 = torch.bfloat16
F64 = torch.float64
XTOL = 1e-10


def _pairs(batch, n, count, seed):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        s = rng.standard_normal((batch, n))
        y = s * rng.uniform(0.5, 2.0, (batch, 1)) \
            + 0.3 * rng.standard_normal((batch, n))
        y[np.einsum("bn,bn->b", s, y) < 0] *= -1.0
        yield s, y


def _histories(batch, n, m, count, seed, with_rinv=False):
    """The same accepted pairs written into a port history and a vmapped
    JAX history, both storing bf16 rows of an f64 solve."""
    th = TH.init_history(batch, n, m, F64, store_dtype=BF16, device="cpu",
                         with_rinv=with_rinv)
    jh = jax.vmap(lambda _: JH.init_history(
        n, m, jnp.float64, store_dtype=jnp.bfloat16,
        with_rinv=with_rinv))(jnp.arange(batch))
    allow = np.ones(batch, bool)
    for s, y in _pairs(batch, n, count, seed):
        th, _ = TH.update_history(th, torch.as_tensor(s), torch.as_tensor(y),
                                  torch.as_tensor(allow))
        jh, _ = jax.vmap(JH.update_history)(jh, jnp.asarray(s),
                                            jnp.asarray(y),
                                            jnp.asarray(allow))
    return th, jh


def test_rows_are_stored_in_bf16_and_round_as_jax_does():
    th, jh = _histories(3, 24, 4, 6, seed=0)
    assert th.s.dtype == BF16 and th.y.dtype == BF16
    assert th.ys.dtype == th.sy.dtype == th.theta.dtype == F64
    for name in ("s", "y"):
        want = np.asarray(getattr(jh, name).astype(jnp.float64))
        np.testing.assert_array_equal(getattr(th, name).double().numpy(),
                                      want)
    for name in ("ys", "sy", "yy", "theta"):
        np.testing.assert_allclose(getattr(th, name).numpy(),
                                   np.asarray(getattr(jh, name)),
                                   rtol=1e-12)


@pytest.mark.parametrize("chunk", [fused.PLAIN_CHUNK_BYTES, 7])
def test_products_and_direction_match_jax(chunk, monkeypatch):
    """The Grams come from the exact incoming pair and the widened rows;
    the direction widens the rows per element.  A small chunk makes the
    plain version and the products widen the rows in pieces along n."""
    monkeypatch.setattr(fused, "PLAIN_CHUNK_BYTES", chunk)
    th, jh = _histories(4, 30, 5, 8, seed=1, with_rinv=True)
    v = np.random.default_rng(2).standard_normal((4, 30))
    for tri in ("sweeps", "rinv", "doubling"):
        want = jax.vmap(lambda h, vv: JH.apply_hv(h, vv, -1.0, tri=tri))(
            jh, jnp.asarray(v))
        got = TH.apply_hv(th, torch.as_tensor(v), -1.0, tri=tri)
        assert got.dtype == F64
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("kind", ["quadratic", "quartic"])
def test_f64_solves_count_like_jax(kind):
    coeffs = _coefficients(12, seed=3)
    x0 = np.random.default_rng(4).uniform(-2.0, 2.0, 12)
    kw = dict(epsilon=1e-7, epsilon_rel=0.0, max_iterations=200, m=5)
    jr = J.minimize(fun_and_grad=make_fg(kind, coeffs, jnp),
                    x0=jnp.asarray(x0), params=J.LBFGSParams(**kw),
                    history_dtype=jnp.bfloat16)
    tr = T.minimize(fun_and_grad=make_fg(kind, coeffs, torch),
                    x0=torch.as_tensor(x0), params=T.LBFGSParams(**kw),
                    history_dtype=BF16, device="cpu")
    assert tr.history.s.dtype == BF16 and tr.x.dtype == F64
    assert int(tr.niter) == int(jr.niter)
    assert int(tr.nfev) == int(jr.nfev)
    assert int(tr.status) == int(jr.status)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=XTOL)


def test_bf16_history_converges_f32_solve():
    """tests/test_mixed_history.py's first bar, through the port."""
    res = T.minimize(fun_and_grad=rosenbrock_fg,
                     x0=torch.zeros(10, dtype=torch.float32),
                     params=T.LBFGSParams(epsilon=1e-4, max_iterations=300),
                     history_dtype=BF16, device="cpu")
    assert res.history.s.dtype == BF16 and res.x.dtype == torch.float32
    np.testing.assert_allclose(res.x.double().numpy(), 1.0, atol=1e-2)
    assert float(res.fx) < 1e-4


def test_bf16_history_f64_solve_close_to_exact():
    """tests/test_mixed_history.py's second bar."""
    p = T.LBFGSParams(epsilon=1e-6, max_iterations=300)
    exact = T.minimize(fun_and_grad=rosenbrock_fg, x0=torch.zeros(10,
                                                                 dtype=F64),
                       params=p, device="cpu")
    mixed = T.minimize(fun_and_grad=rosenbrock_fg, x0=torch.zeros(10,
                                                                 dtype=F64),
                       params=p, history_dtype=BF16, device="cpu")
    assert float(mixed.fx) < 1e-10
    np.testing.assert_allclose(mixed.x.numpy(), exact.x.numpy(), atol=1e-5)


def test_bf16_solve_reaches_the_basin():
    """tests/test_dtypes.py:25-31's bar: x0, the rows and every operand in
    bf16 (the Pallas kernel's bf16 mode; on the CPU the plain version
    rounds per op)."""
    res = T.minimize(t_rosenbrock, torch.zeros(4, dtype=BF16),
                     params=T.LBFGSParams(epsilon=0.125, max_iterations=100),
                     device="cpu")
    assert res.x.dtype == BF16 and res.history.s.dtype == BF16
    assert np.all(np.abs(res.x.double().numpy() - 1.0) < 0.2)


def test_bf16_solve_at_n100_ends_like_jax():
    """The all-bf16 solve at the main phase's width (n=100, m=16, two
    trials, ``on_ls_fail="restart"``, ``sweeps``, epsilon 0.125) against
    JAX's vmapped bf16 ``minimize`` from the same starts.  Per-op bf16
    roundings part the two trajectories early, so what is compared is
    where they end: the same status and iteration count per instance, the
    same share within the 0.2 bar, and max|x - 1| within 0.1 (six bf16
    ulps at 2) per instance."""
    x0 = np.random.default_rng(0).uniform(-2.0, 2.0, (8, 100))
    kw = dict(epsilon=0.125, max_iterations=162, m=16, max_linesearch=2)
    jr = jax.jit(jax.vmap(lambda x: J.minimize(
        j_rosenbrock, x, J.LBFGSParams(**kw),
        direction="sweeps", on_ls_fail="restart")))(
            jnp.asarray(x0, jnp.bfloat16))
    tr = T.minimize(t_rosenbrock, torch.as_tensor(x0).to(BF16),
                    T.LBFGSParams(**kw), direction="sweeps",
                    on_ls_fail="restart", device="cpu")
    assert tr.x.dtype == BF16
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.niter.numpy(), np.asarray(jr.niter))
    j_err = np.abs(np.asarray(jr.x, np.float64) - 1.0).max(axis=1)
    t_err = np.abs(tr.x.double().numpy() - 1.0).max(axis=1)
    assert (t_err < 0.2).mean() == (j_err < 0.2).mean()
    np.testing.assert_allclose(t_err, j_err, atol=0.1)


def test_f32_rosenbrock_batch_with_bf16_rows_matches_f32_rows_quality():
    """A batch of f32 starts through ``direction="rinv"`` (the main
    phase's schedule): bf16 rows reach the same basin as f32 rows."""
    x0 = torch.as_tensor(np.random.default_rng(5).uniform(-2, 2, (6, 10)),
                         dtype=torch.float32)
    p = T.LBFGSParams(epsilon=1e-4, max_iterations=300)
    res = T.minimize(t_rosenbrock, x0, p, direction="rinv",
                     history_dtype=BF16, device="cpu")
    assert res.history.s.dtype == BF16 and res.history.rinv.dtype == \
        torch.float32
    assert bool(torch.isfinite(res.x).all())
    assert float(res.fx.max()) < 1e-4


def test_owlqn_with_bf16_rows_matches_jax():
    rng = np.random.default_rng(6)
    batch, rows, n = 3, 30, 10
    a = rng.standard_normal((batch, rows, n)) / np.sqrt(rows)
    w = np.zeros((batch, n))
    w[:, :3] = 3.0 * rng.standard_normal((batch, 3))
    b = np.einsum("brn,bn->br", a, w) + 0.05 * rng.standard_normal(
        (batch, rows))
    kw = dict(epsilon=1e-7, epsilon_rel=0.0, max_iterations=200)

    def one(ai, bi):
        return j_owlqn(lambda x: 0.5 * jnp.sum((ai @ x - bi) ** 2),
                       jnp.zeros(n), 0.05, J.LBFGSParams(**kw),
                       history_dtype=jnp.bfloat16)
    jr = jax.jit(jax.vmap(one))(jnp.asarray(a), jnp.asarray(b))
    tr = T.minimize_owlqn(
        lambda x, d: 0.5 * torch.sum((d["A"] @ x - d["b"]) ** 2),
        torch.zeros(batch, n, dtype=F64), 0.05, T.LBFGSParams(**kw),
        data={"A": torch.as_tensor(a), "b": torch.as_tensor(b)},
        history_dtype=BF16, device="cpu")
    assert tr.history.s.dtype == BF16
    np.testing.assert_array_equal(tr.niter.numpy(), np.asarray(jr.niter))
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=XTOL)
    np.testing.assert_array_equal(tr.x.numpy() == 0, np.asarray(jr.x) == 0)


def test_pytree_with_bf16_rows_matches_jax():
    def j_loss(t):
        return jnp.sum(2.0 * (t["a"] - 1.5) ** 2) + \
            jnp.sum(0.5 * (t["w"] + 2.0) ** 4 + (t["w"] + 2.0) ** 2)

    def t_loss(t):
        return torch.sum(2.0 * (t["a"] - 1.5) ** 2) + \
            torch.sum(0.5 * (t["w"] + 2.0) ** 4 + (t["w"] + 2.0) ** 2)

    kw = dict(epsilon=1e-8, epsilon_rel=0.0)
    jr = J.minimize_pytree(j_loss, {"w": jnp.ones((2, 2)),
                                    "a": jnp.zeros(3)},
                           J.LBFGSParams(**kw), history_dtype=jnp.bfloat16)
    tr = T.minimize_pytree(t_loss, {"w": torch.ones(2, 2, dtype=F64),
                                    "a": torch.zeros(3, dtype=F64)},
                           T.LBFGSParams(**kw), history_dtype=BF16,
                           device="cpu")
    assert tr.history.s.dtype == BF16
    assert int(tr.niter) == int(jr.niter)
    for key in ("a", "w"):
        np.testing.assert_allclose(tr.x[key].numpy(), np.asarray(jr.x[key]),
                                   rtol=0, atol=XTOL)


def test_stochastic_with_bf16_rows_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((256, 8))
    y = (rng.uniform(size=256) < 1 / (1 + np.exp(-x @ rng.standard_normal(
        8)))).astype(float)

    def j_loss(w, batch):
        z = batch["X"] @ w
        return jnp.mean(jnp.logaddexp(0.0, z) - batch["y"] * z) + \
            1e-3 * jnp.sum(w ** 2)

    def t_loss(w, batch):
        z = batch["X"] @ w
        return torch.mean(torch.logaddexp(torch.zeros_like(z), z)
                          - batch["y"] * z) + 1e-3 * torch.sum(w ** 2)

    kw = dict(m=4, max_iterations=20)
    jr = j_stochastic(j_loss, jnp.zeros(8), {"X": jnp.asarray(x),
                                             "y": jnp.asarray(y)},
                      J.LBFGSParams(**kw), batch_size=64, overlap_frac=0.25,
                      step_size=0.5, history_dtype=jnp.bfloat16)
    tr = T.minimize_stochastic(t_loss, torch.zeros(8, dtype=F64),
                               {"X": torch.as_tensor(x),
                                "y": torch.as_tensor(y)},
                               T.LBFGSParams(**kw), batch_size=64,
                               overlap_frac=0.25, step_size=0.5,
                               history_dtype=BF16, device="cpu")
    assert tr.history.s.dtype == BF16
    assert int(tr.nfev) == int(jr.nfev)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=XTOL)


def test_no_entry_point_refuses_history_dtype():
    """The option reaches every entry point that has it in the JAX
    package (lbfgs, OWL-QN, pytree, stochastic; optax_compat has its own
    tests); minimize_batched has none in either package."""
    import inspect
    for fn in (T.minimize, T.solver, T.minimize_owlqn, T.minimize_pytree,
               T.minimize_stochastic):
        assert "history_dtype" in inspect.signature(fn).parameters
    assert "history_dtype" not in inspect.signature(
        T.minimize_batched).parameters
    p = dataclasses.replace(T.LBFGSParams(), max_iterations=3)
    res = T.minimize_pytree(lambda t: (t["x"] ** 2).sum(),
                            {"x": torch.ones(3, dtype=F64)}, p,
                            history_dtype=BF16, device="cpu")
    assert res.history.s.dtype == BF16
