"""The port's batched Bunch-Kaufman LDL' (lbfgspp_tpu_torch.ops.bkldlt)
against the JAX package's, in f64.

A batch of random symmetric indefinite 12x12 matrices (the middle
matrix's size at m=6), one with a zero leading block that forces 2x2
pivots and a singular one: the factors, pivot types, interchanges and the
NUMERICAL_ISSUE status equal the JAX factorization's per instance, and the
solves agree at rtol 1e-12 (relative to the solution's scale).

Where a 2x2 pivot follows an interchange, the JAX factorization does not
solve ``A x = b`` (residuals of order 1 on these matrices; it also
interchanges at the step a 2x2 pivot skips): the port reproduces that
exactly, and the residual is checked only on the matrices that take 1x1
pivots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgspp_tpu.ops import bkldlt as jbk
from lbfgspp_tpu_torch.ops import bkldlt as tbk

N = 12


@pytest.fixture(scope="module")
def mats():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((6, N, N))
    a = a + a.transpose(0, 2, 1)
    a[1, :2, :2] = 0.0                    # zero diagonal: 2x2 pivots
    a[2] = np.diag(rng.uniform(-2, 2, N))  # diagonal, indefinite
    v = rng.standard_normal(N)
    a[3] = np.outer(v, v)                 # rank one: singular
    a[4, 5, :] = a[4, :, 5] = 0.0         # a zero row and column
    a[5] = a[5] + 30.0 * np.eye(N)        # diagonally dominant: 1x1 pivots
    return a


def test_factors_match_jax(mats):
    fac = tbk.compute(torch.as_tensor(mats))
    for b in range(mats.shape[0]):
        want = jbk.compute(jnp.asarray(mats[b]))
        np.testing.assert_array_equal(fac.perm[b].numpy(),
                                      np.asarray(want.perm))
        np.testing.assert_array_equal(fac.ptype[b].numpy(),
                                      np.asarray(want.ptype))
        assert int(fac.info[b]) == int(want.info)
        scale = np.abs(np.asarray(want.lmat)).max()
        np.testing.assert_allclose(fac.lmat[b].numpy(), np.asarray(want.lmat),
                                   rtol=1e-12, atol=1e-12 * scale)
    assert int(fac.info[4]) == tbk.NUMERICAL_ISSUE
    assert (fac.ptype == 2).any()


def test_solves_match_jax(mats):
    rng = np.random.default_rng(5)
    rhs = rng.standard_normal((mats.shape[0], N))
    fac = tbk.compute(torch.as_tensor(mats))
    got = tbk.solve(fac, torch.as_tensor(rhs))
    cols = tbk.solve(fac, torch.eye(N, dtype=torch.float64).expand(
        mats.shape[0], N, N))
    for b in range(mats.shape[0]):
        want = jbk.solve(jbk.compute(jnp.asarray(mats[b])),
                         jnp.asarray(rhs[b]))
        scale = np.abs(np.asarray(want)).max()
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12 * scale)
        np.testing.assert_allclose(cols[b].numpy() @ rhs[b], got[b].numpy(),
                                   rtol=1e-9, atol=1e-9 * scale)
    for b in (2, 5):                      # 1x1 pivots: a true solve
        np.testing.assert_allclose(mats[b] @ got[b].numpy(), rhs[b],
                                   atol=1e-9)
