"""The port's parameters and types against the JAX package's
(tests/test_params.py rules, Status values, batched tree_select)."""

import dataclasses

import pytest
import torch

import lbfgspp_tpu as ljax
import lbfgspp_tpu_torch as lt
from lbfgspp_tpu_torch import types as tt


def test_defaults_match_jax_package():
    assert dataclasses.asdict(lt.LBFGSParams()) == \
        dataclasses.asdict(ljax.LBFGSParams())
    assert dataclasses.asdict(lt.LBFGSBParams()) == \
        dataclasses.asdict(ljax.LBFGSBParams())
    assert not hasattr(lt.LBFGSBParams(), "linesearch")
    for name in ("LINESEARCH_BACKTRACKING_ARMIJO", "LINESEARCH_BACKTRACKING",
                 "LINESEARCH_BACKTRACKING_WOLFE",
                 "LINESEARCH_BACKTRACKING_STRONG_WOLFE"):
        assert getattr(lt, name) == getattr(ljax, name)


@pytest.mark.parametrize("kw", [
    dict(m=0), dict(m=-1),
    dict(epsilon=-1e-3), dict(epsilon_rel=-1.0),
    dict(past=-1), dict(delta=-0.5),
    dict(max_iterations=-2),
    dict(linesearch=0), dict(linesearch=4),
    dict(max_linesearch=0),
    dict(min_step=-1e-3),
    dict(max_step=1e-30),
    dict(ftol=0.0), dict(ftol=0.5),
    dict(wolfe=1e-4), dict(wolfe=1.0),
])
def test_invalid_lbfgs_params(kw):
    with pytest.raises(ValueError):
        lt.LBFGSParams(**kw)


@pytest.mark.parametrize("kw", [
    dict(m=0), dict(max_submin=-1), dict(ftol=0.7), dict(wolfe=1.5),
])
def test_invalid_lbfgsb_params(kw):
    with pytest.raises(ValueError):
        lt.LBFGSBParams(**kw)


def test_params_hashable():
    assert hash(lt.LBFGSParams()) == hash(lt.LBFGSParams())
    assert lt.LBFGSParams(m=8) != lt.LBFGSParams()


def test_status_values_match_jax_package():
    assert {s.name: int(s) for s in lt.Status} == \
        {s.name: int(s) for s in ljax.Status}
    assert [int(s) for s in lt.SUCCESS_STATUSES] == \
        [int(s) for s in ljax.SUCCESS_STATUSES]
    assert lt.SolveResult._fields == ljax.SolveResult._fields
    assert lt.LineSearchResult._fields == ljax.LineSearchResult._fields


def test_tree_select_and_freeze_when_are_per_instance():
    a = lt.LineSearchResult(*(torch.full((3, 2), float(i)) for i in range(7)))
    b = lt.LineSearchResult(*(torch.full((3, 2), -float(i))
                              for i in range(7)))
    pred = torch.tensor([True, False, True])
    out = tt.tree_select(pred, a, b)
    for got, x, y in zip(out, a, b):
        assert torch.equal(got[0], x[0]) and torch.equal(got[1], y[1])
        assert torch.equal(got[2], x[2])
    frozen = tt.freeze_when(pred, a, lambda s: b)
    assert torch.equal(frozen.step[:, 0], torch.tensor([0.0, -0.0, 0.0]))
    assert tt.tree_select(pred, None, None) is None


def test_make_fun_and_grad_maps_one_instance_over_the_batch():
    def fun(x):
        return torch.sum(x ** 3)

    fg = lt.make_fun_and_grad(fun)
    x = torch.tensor([[1.0, 2.0], [3.0, -1.0]], dtype=torch.float64)
    fx, g = fg(x)
    assert torch.equal(fx, torch.tensor([9.0, 26.0], dtype=torch.float64))
    assert torch.equal(g, 3 * x ** 2)
    with pytest.raises(ValueError):
        lt.make_fun_and_grad()
