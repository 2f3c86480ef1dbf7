"""The 2-D batch x feature composition on four gloo ranks.

tests/test_sharded.py:152-212 runs a 2-D mesh in JAX: batch-parallel
instances on one axis, each instance's features split over the other (a
production fleet's data x model layout).  Here four ranks form 2 batch
blocks x 2 feature shards (``tools/sharded_cases.mesh_2d``): each rank
solves its ``[B/2, n/2]`` block with the port's batched L-BFGS under
``group=`` its feature group, the objective's partial sums joined by
``collectives.psum_scalar``.  Every rank's block of x equals the
single-process batched solve to 1e-12 and its counts equal, the JAX test's
bar, and so does the JAX package's vmapped solve of the same batch (the
JAX test's own reference; one compile).
"""

import numpy as np
import pytest
import torch

import lbfgspp_tpu_torch as T
from lbfgspp_tpu_torch import lbfgs
from lbfgspp_tpu_torch.tools import spawn_ranks
from lbfgspp_tpu_torch.tools.sharded_cases import weighted

B, N = 8, 32
D = np.random.default_rng(0).uniform(-2.0, 2.0, (B, N))
X0 = np.zeros((B, N))
PARAMS = dict(epsilon=1e-10, max_iterations=60)


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks.run("lbfgspp_tpu_torch.tools.sharded_cases:mesh_2d",
                           4, args=(D, X0, PARAMS), timeout=240)


@pytest.fixture(scope="module")
def single():
    """The single-process batched solve of the whole batch."""
    d = torch.as_tensor(D)
    s = lbfgs._build_solver(lambda x: weighted(x, d),
                            T.LBFGSParams(**PARAMS), device="cpu")
    return s.finalize(s.run(s.init(torch.as_tensor(X0))))


@pytest.mark.parametrize("rank", range(4))
def test_each_block_equals_the_single_process_solve(ranks, single, rank):
    got = ranks[rank]
    (lo, hi), (c0, c1) = got["rows"], got["cols"]
    assert (hi - lo, c1 - c0) == (B // 2, N // 2)
    np.testing.assert_allclose(got["x"], single.x[lo:hi, c0:c1].numpy(),
                               rtol=1e-12, atol=1e-12)
    for f in ("niter", "status"):
        np.testing.assert_array_equal(got[f], getattr(single, f)[lo:hi])
    np.testing.assert_allclose(got["fx"], single.fx[lo:hi].numpy(),
                               rtol=1e-12, atol=1e-12)


def test_blocks_equal_jax_vmapped_solve(ranks):
    """The JAX test's reference, ``jax.vmap`` of ``lbfgs.minimize`` on the
    same D and X0, against every rank's block: niter equal, x to 1e-12."""
    import jax
    import jax.numpy as jnp
    from lbfgspp_tpu import LBFGSParams as JParams
    from lbfgspp_tpu import lbfgs as jlbfgs

    params = JParams(**PARAMS)

    def fg(x, di):
        r = x - di
        w = 1.0 + 0.1 * di * di
        return jnp.sum(r * r * w), 2.0 * r * w

    ref = jax.jit(jax.vmap(lambda x, di: jlbfgs.minimize(
        fun_and_grad=lambda xx: fg(xx, di), x0=x, params=params)))(
        jnp.asarray(X0), jnp.asarray(D))
    for got in ranks:
        (lo, hi), (c0, c1) = got["rows"], got["cols"]
        np.testing.assert_allclose(got["x"], np.asarray(ref.x)[lo:hi, c0:c1],
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(got["niter"],
                                      np.asarray(ref.niter)[lo:hi])


def test_the_ranks_cover_the_batch_and_the_features(ranks):
    blocks = sorted((tuple(r["rows"]), tuple(r["cols"])) for r in ranks)
    assert blocks == [((0, 4), (0, 16)), ((0, 4), (16, 32)),
                      ((4, 8), (0, 16)), ((4, 8), (16, 32))]
