"""The port's collectives (lbfgspp_tpu_torch.parallel.collectives) on two
gloo ranks against numpy, in f64: every reduction of the ranks' local
operands, batched ``[B, ...]``, equal on both ranks; one all-reduce per
call, counted by site; the caller's tensor left as it was; and the
single-process semantics (``group=None``) with no ``torch.distributed``
call at all."""

import numpy as np
import pytest
import torch

from lbfgspp_tpu_torch.parallel import collectives as coll
from lbfgspp_tpu_torch.tools import spawn_ranks
from lbfgspp_tpu_torch.tools.sharded_cases import collective_inputs

SEED = 4


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks.run(
        "lbfgspp_tpu_torch.tools.sharded_cases:collectives", 2,
        args=(SEED,), timeout=120)


def expected():
    r0, r1 = collective_inputs(SEED, 0), collective_inputs(SEED, 1)
    a0, a1, b0, b1 = r0["a"], r1["a"], r0["b"], r1["b"]
    m0, m1 = r0["mat"], r1["mat"]
    dot = (a0 * b0).sum(1) + (a1 * b1).sum(1)
    sq = (a0 * a0).sum(1) + (a1 * a1).sum(1)
    return {
        "psum": a0 + a1, "pdot": dot, "psqnorm": sq, "pnorm": np.sqrt(sq),
        "pmax": np.maximum(a0, a1), "pmin": np.minimum(a0, a1),
        "pall": r0["flags"] & r1["flags"],
        "pmax_abs": np.maximum(np.abs(a0).max(1), np.abs(a1).max(1)),
        "pdot2": np.stack([dot, (b0 * b0).sum(1) + (b1 * b1).sum(1)], 1),
        "pmatvec": np.einsum("bkn,bn->bk", m0, a0) +
        np.einsum("bkn,bn->bk", m1, a1),
        "pgram": np.einsum("bkn,bjn->bkj", m0, m0) +
        np.einsum("bkn,bjn->bkj", m1, m1),
        "pfused": np.concatenate([a0 + a1, (m0 + m1).reshape(3, -1)], 1),
        "gather_rows": np.repeat(np.arange(5.0)[:, None], 2, 1),
        "gather_bool": np.arange(5) > 2,
    }


@pytest.mark.parametrize("name", sorted(expected()))
def test_collective_matches_numpy(ranks, name):
    want = expected()[name]
    for rank in ranks:
        np.testing.assert_allclose(rank[name], want, rtol=1e-14,
                                   atol=1e-14)
        assert rank[name].dtype == np.asarray(want).dtype


def test_one_call_per_collective_and_inputs_untouched(ranks):
    for r, rank in enumerate(ranks):
        assert all(v == 1 for k, v in rank["counts"].items()
                   if k != "gather"), rank["counts"]
        assert rank["counts"]["gather"] == 2
        np.testing.assert_array_equal(rank["unchanged"],
                                      collective_inputs(SEED, r)["a"])


def test_no_group_is_local(monkeypatch):
    """``group=None`` returns the local values and never reaches
    ``torch.distributed``."""
    def boom(*args, **kwargs):
        raise AssertionError("torch.distributed was called")

    monkeypatch.setattr(torch.distributed, "all_reduce", boom)
    a = torch.as_tensor(collective_inputs(SEED, 0)["a"])
    coll.COUNTS.clear()
    assert coll.psum(a) is a
    assert torch.equal(coll.pdot(a, a), torch.linalg.vecdot(a, a))
    assert torch.equal(coll.gather_rows(a, 3), a)
    assert coll.block(7) == (0, 7)
    assert not coll.COUNTS
