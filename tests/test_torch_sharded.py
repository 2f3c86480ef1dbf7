"""The port's feature-split solves on two gloo ranks against the JAX
package's ``shard_map`` on a 2-device CPU mesh and against the port's own
single-process solves, in f64 (mirroring tests/test_sharded.py).

The ranks are spawned once for the module
(:mod:`lbfgspp_tpu_torch.tools.spawn_ranks`, with a timeout, so a rank
left waiting in a collective fails the fixture and not the suite) and run
every case of :func:`lbfgspp_tpu_torch.tools.sharded_cases.sharded_solves`.
Both packages sum the same two partials, so the separable quadratic and
quartic take JAX's iteration counts and agree to 1e-12; Rosenbrock (both
directions) and the logistic regression equal the port's unsharded solve
in counts and to 1e-10 / 1e-8; the box walks equal the port's unsharded
walk solve, and ``gcp="auto"`` JAX's ``minimize_b_sharded`` (one compile
of ~40 s), and OWL-QN JAX's and the unsharded solve's, in counts and to
1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import lbfgspp_tpu as J
from lbfgspp_tpu.parallel import sharded as jsharded
from lbfgspp_tpu.utils import objectives as jo
import lbfgspp_tpu_torch as T
from lbfgspp_tpu_torch.tools import spawn_ranks
from lbfgspp_tpu_torch.utils import objectives as to

N, WORLD = 64, 2


def _data():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((48, N)) / np.sqrt(N)
    w_true = rng.standard_normal(N)
    lb = rng.uniform(-1.5, -0.2, N)
    ub = rng.uniform(0.3, 0.9, N)
    return {"n": N, "d": rng.standard_normal(N) * 3.0,
            "x0": rng.standard_normal(N), "zeros": np.zeros(N),
            "c": rng.uniform(0.5, 2.0, N), "a": a,
            "b": np.sign(a @ w_true + 0.1 * rng.standard_normal(48)),
            "lb": lb, "ub": ub, "box_x0": np.clip(np.full(N, 0.25), lb, ub),
            "l1": 2.0}


DATA = _data()


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks.run(
        "lbfgspp_tpu_torch.tools.sharded_cases:sharded_solves", WORLD,
        args=(DATA,), timeout=240)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("feat",))


def joined(ranks, name):
    """The global x from the ranks' blocks, and rank 0's fields (the
    replicated ones are every rank's: checked here)."""
    out = dict(ranks[0][name])
    for key in ("fx", "niter", "status"):
        np.testing.assert_array_equal(ranks[1][name][key], out[key])
    out["x"] = np.concatenate([r[name]["x"] for r in ranks])
    return out


def _part(arr):
    parts = jnp.asarray(arr).reshape(WORLD, -1)

    def local():
        return jax.lax.dynamic_index_in_dim(
            parts, jax.lax.axis_index("feat"), 0, keepdims=False)
    return local


def test_quadratic_and_quartic_match_jax_shard_map(ranks, mesh):
    d, c = _part(DATA["d"]), _part(DATA["c"])
    p = J.LBFGSParams(epsilon=1e-8, max_iterations=50)
    cases = {
        "quadratic": (lambda x: jnp.sum((x - d()) ** 2), DATA["x0"]),
        "quartic": (lambda x: jnp.sum(c() * (x - 1.0) ** 2 +
                                      0.1 * (x - 1.0) ** 4), DATA["zeros"]),
    }
    for name, (local_fun, x0) in cases.items():
        want = jsharded.minimize_sharded(local_fun, jnp.asarray(x0), p,
                                         mesh=mesh)
        got = joined(ranks, name)
        assert int(got["niter"]) == int(want.niter), name
        assert int(got["status"]) == int(want.status), name
        np.testing.assert_allclose(got["x"], np.asarray(want.x), rtol=1e-12,
                                   atol=1e-12)


VARIANTS = {"morethuente": dict(line_search="morethuente"),
            "backtracking": dict(line_search="backtracking"),
            "bracketing": dict(line_search="bracketing"),
            "speculative": dict(line_search="speculative"),
            "doubling": dict(direction="doubling"),
            "bf16_rows": dict(history_dtype=torch.bfloat16),
            "restart": dict(on_ls_fail="restart")}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_options_match_unsharded(ranks, name):
    """Every search, the doubling schedule, bf16 rows and the restart
    mode (a search capped at one trial, so restarts fire) under the
    group: the unsharded solve's counts and status, x to 1e-12."""
    c = torch.as_tensor(DATA["c"])
    p = T.LBFGSParams(epsilon=1e-8, max_iterations=50,
                      max_linesearch=1 if name == "restart" else 20)
    want = T.minimize(lambda x: torch.sum(c * (x - 1.0) ** 2 +
                                          0.1 * (x - 1.0) ** 4),
                      torch.as_tensor(DATA["x0"]), p, device="cpu",
                      **VARIANTS[name])
    got = joined(ranks, f"quartic_{name}")
    assert int(got["niter"]) == int(want.niter)
    assert int(got["nfev"]) == int(want.nfev)
    assert int(got["status"]) == int(want.status)
    np.testing.assert_allclose(got["x"], want.x.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("name,direction", [("rosenbrock", "sweeps"),
                                            ("rosenbrock_rinv", "rinv")])
def test_rosenbrock_matches_unsharded(ranks, name, direction):
    """Pairwise Rosenbrock is separable across even block boundaries."""
    p = T.LBFGSParams(epsilon=1e-6, max_iterations=200)
    want = T.minimize(to.rosenbrock, torch.zeros(N, dtype=torch.float64), p,
                      direction=direction, device="cpu")
    got = joined(ranks, name)
    assert ranks[0][name]["has_rinv"] == (direction == "rinv")
    assert int(got["niter"]) == int(want.niter)
    np.testing.assert_allclose(got["x"], want.x.numpy(), rtol=1e-10,
                               atol=1e-12)


def test_logreg_matches_replicated(ranks):
    a, b = torch.as_tensor(DATA["a"]), torch.as_tensor(DATA["b"])

    def global_fg(w):
        z = -b * (a @ w)
        return torch.logaddexp(torch.zeros_like(z), z).sum(), \
            a.T @ (-b * torch.sigmoid(z))

    want = T.minimize(fun_and_grad=global_fg,
                      x0=torch.zeros(N, dtype=torch.float64),
                      params=T.LBFGSParams(epsilon=1e-6,
                                           max_iterations=500),
                      device="cpu")
    got = joined(ranks, "logreg")
    assert int(got["niter"]) == int(want.niter)
    np.testing.assert_allclose(got["fx"], float(want.fx), rtol=1e-10)
    np.testing.assert_allclose(got["x"], want.x.numpy(), rtol=1e-8,
                               atol=1e-10)
    # one all-reduce of the logits per evaluation, the solver's own sites
    # beside it
    counts = ranks[0]["logreg"]["counts"]
    assert counts["logreg.logits"] == int(got["nfev"])


def test_box_walks_match_unsharded(ranks):
    single = T.minimize_b(to.rosenbrock, torch.as_tensor(DATA["box_x0"]),
                          torch.as_tensor(DATA["lb"]),
                          torch.as_tensor(DATA["ub"]),
                          T.LBFGSBParams(epsilon=1e-8, max_iterations=100),
                          gcp="walk", device="cpu")
    for gcp in ("walk", "walk_chunked", "auto"):
        got = joined(ranks, f"box_{gcp}")
        assert int(got["niter"]) == int(single.niter), gcp
        np.testing.assert_allclose(got["x"], single.x.numpy(), rtol=1e-8,
                                   atol=1e-10)
        assert np.all(got["x"] >= DATA["lb"]) and \
            np.all(got["x"] <= DATA["ub"])


def test_box_auto_matches_jax_shard_map(ranks, mesh):
    """The split box solve, its routed walk Cauchy points, BOXCQP's global
    tests and the fused Grams of the subspace solve, against JAX's on the
    same two blocks."""
    want = jsharded.minimize_b_sharded(
        jo.rosenbrock, jnp.asarray(DATA["box_x0"]), jnp.asarray(DATA["lb"]),
        jnp.asarray(DATA["ub"]),
        J.LBFGSBParams(epsilon=1e-8, max_iterations=100), mesh=mesh,
        gcp="auto")
    got = joined(ranks, "box_auto")
    assert int(got["niter"]) == int(want.niter)
    assert int(got["status"]) == int(want.status)
    np.testing.assert_allclose(got["x"], np.asarray(want.x), rtol=1e-8,
                               atol=1e-10)


def test_owlqn_matches_jax_and_unsharded(ranks, mesh):
    c = _part(DATA["c"])
    want = jsharded.minimize_owlqn_sharded(
        lambda x: jnp.sum(c() * (x - 1.0) ** 2 + 0.1 * (x - 1.0) ** 4),
        jnp.asarray(DATA["x0"]), DATA["l1"],
        J.LBFGSParams(epsilon=1e-8, max_iterations=100), mesh=mesh)
    ct = torch.as_tensor(DATA["c"])
    single = T.minimize_owlqn(
        lambda x: torch.sum(ct * (x - 1.0) ** 2 + 0.1 * (x - 1.0) ** 4),
        torch.as_tensor(DATA["x0"]), DATA["l1"],
        T.LBFGSParams(epsilon=1e-8, max_iterations=100), device="cpu")
    got = joined(ranks, "owlqn")
    assert int(got["niter"]) == int(want.niter) == int(single.niter)
    for other in (np.asarray(want.x), single.x.numpy()):
        np.testing.assert_allclose(got["x"], other, rtol=1e-8, atol=1e-10)
    assert (got["x"] == 0.0).any()      # the L1 term zeroes coordinates
