"""Parameter trees whose dicts come in another key order.

JAX flattens a dict by its sorted keys, so every tree of the same
structure ravels in one order, whatever order its dicts were built in.
The port's front end does the same: a gradient dict returned in another
key order than ``x0``'s, and a bound dict given in another order, are
raveled against ``x0``'s coordinates by key.  Against
``lbfgspp_tpu.minimize_pytree`` / ``minimize_b_pytree`` in f64 on the CPU:
the same iteration count and status, x to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbfgspp_tpu as J
import lbfgspp_tpu_torch as T
from lbfgspp_tpu_torch.pytree import ravel_pytree

F64 = torch.float64
TARGET = {"a": [1.0, 2.0], "b": [3.0, 4.0, 5.0]}
SCALE = {"a": [1.0, 3.0], "b": [0.5, 2.0, 4.0]}


def _fg(xp):
    """A separable quadratic whose gradient dict is built "b" first."""
    arr = torch.tensor if xp is torch else jnp.asarray
    t = {k: arr(v, dtype=F64) if xp is torch else arr(v)
         for k, v in TARGET.items()}
    c = {k: arr(v, dtype=F64) if xp is torch else arr(v)
         for k, v in SCALE.items()}

    def fg(x):
        fx = sum((0.5 * c[k] * (x[k] - t[k]) ** 2).sum() for k in ("a", "b"))
        return fx, {"b": c["b"] * (x["b"] - t["b"]),
                    "a": c["a"] * (x["a"] - t["a"])}
    return fg


def _x0(xp, order=("a", "b")):
    vals = {"a": [0.0, 0.0], "b": [0.0, 0.0, 0.0]}
    if xp is torch:
        return {k: torch.tensor(vals[k], dtype=F64) for k in order}
    return {k: jnp.asarray(vals[k]) for k in order}


def _assert_same(tr, jr):
    assert int(tr.niter) == int(jr.niter)
    assert int(tr.status) == int(jr.status)
    assert list(tr.x) == sorted(tr.x) == list(jr.x)
    for k in jr.x:
        np.testing.assert_allclose(tr.x[k].numpy(), np.asarray(jr.x[k]),
                                   rtol=0, atol=1e-12)


def test_ravel_sorts_dict_keys_as_jax_does():
    flat, unravel = ravel_pytree({"b": torch.tensor([3.0, 4.0]),
                                  "a": {"z": torch.tensor(1.0),
                                        "y": torch.tensor([2.0])}})
    np.testing.assert_array_equal(flat.numpy(), [2.0, 1.0, 3.0, 4.0])
    back = unravel(flat)
    assert list(back) == ["a", "b"] and list(back["a"]) == ["y", "z"]


@pytest.mark.parametrize("order", [("a", "b"), ("b", "a")])
def test_gradient_dict_in_another_key_order_matches_jax(order):
    p = dict(epsilon=1e-10, epsilon_rel=0.0)
    jr = J.minimize_pytree(None, _x0(jnp), J.LBFGSParams(**p),
                           fun_and_grad=_fg(jnp))
    tr = T.minimize_pytree(None, _x0(torch, order), T.LBFGSParams(**p),
                           fun_and_grad=_fg(torch), device="cpu")
    _assert_same(tr, jr)
    assert int(tr.status) == int(T.Status.CONVERGED_GRAD)
    for k in TARGET:
        np.testing.assert_allclose(tr.x[k].numpy(), TARGET[k], atol=1e-9)


def test_bound_dict_in_another_key_order_matches_jax():
    lb = {"b": [3.5, -np.inf, 0.0], "a": [-np.inf, 2.5]}
    ub = {"b": [np.inf, 3.0, 4.5], "a": [0.5, np.inf]}
    p = dict(epsilon=1e-10, epsilon_rel=0.0)
    jr = J.minimize_b_pytree(
        None, _x0(jnp), {k: jnp.asarray(v) for k, v in lb.items()},
        {k: jnp.asarray(v) for k, v in ub.items()}, J.LBFGSBParams(**p),
        fun_and_grad=_fg(jnp))
    tr = T.minimize_b_pytree(
        None, _x0(torch), {k: torch.tensor(v, dtype=F64)
                           for k, v in lb.items()},
        {k: torch.tensor(v, dtype=F64) for k, v in ub.items()},
        T.LBFGSBParams(**p), fun_and_grad=_fg(torch), device="cpu")
    _assert_same(tr, jr)
    np.testing.assert_allclose(tr.x["a"].numpy(), [0.5, 2.5], atol=1e-12)
    np.testing.assert_allclose(tr.x["b"].numpy(), [3.5, 3.0, 4.5],
                               atol=1e-12)
