"""``minimize_batched(mesh=)`` and ``minimize_b_batched(mesh=)`` on two
gloo ranks, in f64: the batch split over the ranks data-parallel.

With the straggler compaction, the df64 polish and the deep stage on
(``refine_frac``, ``polish_iters``, ``deep_frac``), an odd batch (B = 7:
4 + 3 instances) is equal instance for instance, bit for bit, to the
single-process solve, on every rank (each returns the whole batch); the
box solve with per-instance bounds likewise.  At B = 8 the same runs take
the JAX package's ``mesh=`` run's counts and statuses on a 2-device
"batch" mesh, with x to 1e-10 (tests/test_torch_polish.py's bars).  No
all-reduce runs inside a solve: the only ones are the selections' score
gathers and the result's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import lbfgspp_tpu as J
from lbfgspp_tpu import batch as JB
import lbfgspp_tpu_torch as T
from lbfgspp_tpu_torch.tools import spawn_ranks
from lbfgspp_tpu_torch.tools.sharded_cases import quartic

from test_torch_polish import assert_counts_equal

N = 12
RNG = np.random.default_rng(9)
C = RNG.uniform(0.5, 2.0, N)
OPTIONS = dict(params=dict(epsilon=1e-8, max_iterations=4, m=5),
               refine_frac=0.25, refine_iters=3, polish_iters=2,
               deep_frac=0.25, deep_iters=15)
BOX = dict(params=dict(epsilon=1e-8, max_iterations=30, m=5))


def case(batch, box):
    rng = np.random.default_rng(batch + 10 * box)
    x0s = rng.uniform(-2.0, 2.0, (batch, N))
    if not box:
        return x0s, C, None, None, OPTIONS
    lb = rng.uniform(-1.0, 0.5, (batch, N))
    ub = lb + rng.uniform(0.2, 2.0, (batch, N))
    return np.clip(x0s, lb, ub), C, lb, ub, BOX


CASES = {f"{kind}_{b}": case(b, kind == "box")
         for kind in ("lbfgs", "box") for b in (7, 8)}


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks.run(
        "lbfgspp_tpu_torch.tools.sharded_cases:batch_mesh", 2,
        args=(CASES,), timeout=240)


def single(name):
    x0s, c, lb, ub, options = CASES[name]
    options, ct = dict(options), torch.as_tensor(c)

    def fun(x):
        return quartic(x, ct)

    if lb is None:
        return T.minimize_batched(fun, torch.as_tensor(x0s),
                                  T.LBFGSParams(**options.pop("params")),
                                  device="cpu", **options)
    return T.minimize_b_batched(fun, torch.as_tensor(x0s),
                                torch.as_tensor(lb), torch.as_tensor(ub),
                                T.LBFGSBParams(**options.pop("params")),
                                device="cpu", **options)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_equals_single_process(ranks, name):
    want = single(name)
    for rank in ranks:
        got = rank[name]
        for field in ("x", "fx", "niter", "nfev", "status", "gnorm"):
            np.testing.assert_array_equal(got[field],
                                          getattr(want, field).numpy(),
                                          err_msg=f"{name}: {field}")
        assert all(site.startswith("batch.") for site in got["counts"]), \
            got["counts"]


@pytest.mark.parametrize("kind", ["lbfgs", "box"])
def test_mesh_matches_jax_mesh_run(ranks, kind):
    x0s, c, lb, ub, options = CASES[f"{kind}_8"]
    options, cj = dict(options), jnp.asarray(c)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("batch",))

    def fun(x):
        r = x - 1.0
        return jnp.sum(cj * r * r + 0.1 * r ** 4)

    if lb is None:
        want = JB.minimize_batched(fun, jnp.asarray(x0s),
                                   J.LBFGSParams(**options.pop("params")),
                                   mesh=mesh, **options)
    else:
        want = JB.minimize_b_batched(fun, jnp.asarray(x0s), jnp.asarray(lb),
                                     jnp.asarray(ub),
                                     J.LBFGSBParams(**options.pop("params")),
                                     mesh=mesh, **options)
    got = T.SolveResult(*(torch.as_tensor(ranks[0][f"{kind}_8"][f])
                          for f in ("x", "fx", "gnorm", "gnorm", "niter",
                                    "nfev", "status")), history=None)
    assert_counts_equal(got, want)
