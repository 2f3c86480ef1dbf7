"""The port's pytree front end (``lbfgspp_tpu_torch.pytree``) against
``lbfgspp_tpu.pytree`` and the flat solve.

The cases of tests/test_pytree.py: the pytree solve is the flat solve of
``fun`` composed with ``unravel`` bit for bit, structure and dtypes come
back, an explicit gradient tree equals autodiff, scalar and per-leaf boxes
(with a pinned leaf) match the flat box solve, and a bad bound structure
raises.  Leaves are taken in JAX's order (a dict's by sorted key;
tests/test_torch_pytree_keys.py holds trees built in another key order).
Against
``lbfgspp_tpu.minimize_pytree`` in f64 on the CPU: the same iteration
count, x to 1e-12 (the same arithmetic summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as j_ravel

from lbfgspp_tpu import LBFGSParams as JP
from lbfgspp_tpu import minimize_pytree as j_minimize_pytree
import lbfgspp_tpu_torch as lt
from lbfgspp_tpu_torch.pytree import (minimize_b_pytree, minimize_pytree,
                                      ravel_pytree)

F64 = torch.float64


def tree_quadratic(t, xp=torch):
    return (xp.sum(2.0 * (t["a"] - 1.5) ** 2)
            + xp.sum(0.5 * (t["b"]["w"] + 2.0) ** 2)
            + xp.sum(3.0 * (t["b"]["v"] - 0.25) ** 2))


def x0_tree(xp=torch):
    arr = (lambda v: torch.tensor(v, dtype=F64)) if xp is torch else \
        jnp.asarray
    return {"a": arr([0.3, -0.7, 2.2]),
            "b": {"w": arr([[1.0, -1.0], [0.5, 4.0]]), "v": arr([9.0])}}


def flat(tree):
    return ravel_pytree(tree)[0].numpy()


def assert_leaves_close(tree, jtree, atol):
    """Leaf by leaf, by key."""
    for path in (("a",), ("b", "w"), ("b", "v")):
        got, want = tree, jtree
        for key in path:
            got, want = got[key], want[key]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)


def test_ravel_matches_jax_order_and_dtypes():
    tree = {"a": torch.tensor([1.0, 2.0], dtype=torch.float32),
            "b": (torch.tensor([[3.0]], dtype=F64), torch.tensor(4.0))}
    vec, unravel = ravel_pytree(tree)
    jvec, _ = j_ravel({"a": jnp.asarray([1.0, 2.0], jnp.float32),
                       "b": (jnp.asarray([[3.0]], jnp.float64),
                             jnp.asarray(4.0, jnp.float32))})
    assert vec.dtype == F64
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jvec))
    back = unravel(vec * 2)
    assert back["a"].dtype == torch.float32 and back["b"][0].shape == (1, 1)
    np.testing.assert_array_equal(back["b"][1].numpy(), 8.0)


def test_matches_flat_solve_exactly_and_jax():
    x0 = x0_tree()
    flat0, unravel = ravel_pytree(x0)
    p = lt.LBFGSParams(epsilon=1e-10, epsilon_rel=0.0)
    res_t = minimize_pytree(tree_quadratic, x0, p, device="cpu")
    res_f = lt.minimize(lambda z: tree_quadratic(unravel(z)), flat0, p,
                        device="cpu")
    assert int(res_t.niter) == int(res_f.niter)
    assert float(res_t.fx) == float(res_f.fx)
    np.testing.assert_array_equal(flat(res_t.x), res_f.x.numpy())
    np.testing.assert_array_equal(flat(res_t.grad), res_f.grad.numpy())
    res_j = j_minimize_pytree(lambda t: tree_quadratic(t, jnp), x0_tree(jnp),
                              JP(epsilon=1e-10, epsilon_rel=0.0))
    assert int(res_t.niter) == int(res_j.niter)
    assert_leaves_close(res_t.x, res_j.x, 1e-12)


def test_structure_dtype_and_solution():
    res = minimize_pytree(tree_quadratic, x0_tree(),
                          lt.LBFGSParams(epsilon=1e-10, epsilon_rel=0.0),
                          device="cpu")
    assert set(res.x) == {"a", "b"} and set(res.x["b"]) == {"w", "v"}
    assert res.x["b"]["w"].shape == (2, 2)
    assert int(res.status) == lt.Status.CONVERGED_GRAD
    np.testing.assert_allclose(res.x["a"].numpy(), 1.5, atol=1e-8)
    np.testing.assert_allclose(res.x["b"]["w"].numpy(), -2.0, atol=1e-8)
    np.testing.assert_allclose(res.x["b"]["v"].numpy(), 0.25, atol=1e-8)
    np.testing.assert_allclose(res.grad["a"].numpy(), 0.0, atol=1e-8)


def test_fun_and_grad_tree_contract():
    x0 = x0_tree()

    def fg(t):
        return tree_quadratic(t), {
            "a": 4.0 * (t["a"] - 1.5),
            "b": {"w": t["b"]["w"] + 2.0, "v": 6.0 * (t["b"]["v"] - 0.25)}}

    res_o = minimize_pytree(None, x0, fun_and_grad=fg, device="cpu")
    res_a = minimize_pytree(tree_quadratic, x0, device="cpu")
    assert int(res_o.niter) == int(res_a.niter)
    np.testing.assert_array_equal(flat(res_o.x), flat(res_a.x))


def test_box_scalar_bounds_match_flat():
    x0 = x0_tree()
    flat0, unravel = ravel_pytree(x0)
    p = lt.LBFGSBParams(epsilon=1e-9, epsilon_rel=0.0)
    res_t = minimize_b_pytree(tree_quadratic, x0, 0.0, 2.0, p, device="cpu")
    res_f = lt.minimize_b(lambda z: tree_quadratic(unravel(z)), flat0,
                          torch.zeros_like(flat0),
                          torch.full_like(flat0, 2.0), p, device="cpu")
    assert int(res_t.niter) == int(res_f.niter)
    np.testing.assert_array_equal(flat(res_t.x), res_f.x.numpy())
    np.testing.assert_allclose(res_t.x["b"]["w"].numpy(), 0.0, atol=1e-7)
    np.testing.assert_allclose(res_t.x["a"].numpy(), 1.5, atol=1e-7)


def test_box_per_leaf_bounds_and_pinning():
    lb = {"a": 1.7, "b": {"w": -torch.inf, "v": torch.tensor([5.0])}}
    ub = {"a": 10.0, "b": {"w": torch.inf, "v": torch.tensor([5.0])}}
    res = minimize_b_pytree(tree_quadratic, x0_tree(), lb, ub,
                            lt.LBFGSBParams(epsilon=1e-9, epsilon_rel=0.0),
                            device="cpu")
    np.testing.assert_allclose(res.x["a"].numpy(), 1.7, atol=1e-8)
    np.testing.assert_allclose(res.x["b"]["w"].numpy(), -2.0, atol=1e-7)
    np.testing.assert_array_equal(res.x["b"]["v"].numpy(), [5.0])


def test_box_bad_bound_structure_raises():
    with pytest.raises(ValueError):
        minimize_b_pytree(tree_quadratic, x0_tree(), torch.zeros(3), 1.0,
                          device="cpu")
