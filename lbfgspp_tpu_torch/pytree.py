"""Pytree-parameter front end: optimize structured parameters.

The port's counterpart of ``lbfgspp_tpu.pytree``: the solvers take a flat
vector, users hold parameters as nested containers (dicts of layers,
tuples, lists).  The tree is raveled once with :func:`ravel_pytree` (on
``torch.utils._pytree``) and the flat solver runs unchanged; the result
carries ``x`` and ``grad`` unraveled back to the input structure.

Mixed-dtype trees follow ``jax.flatten_util.ravel_pytree``: the flat
vector has the leaves' promoted dtype and ``unravel`` casts every leaf
back to its own.  Leaves come in JAX's order: a dict's by sorted key
(an ``OrderedDict`` keeps its own order), so a gradient or bound tree
built in another key order ravels against the same coordinates as
``x0``, and ``unravel`` returns dicts with sorted keys, as JAX does.
"""

from __future__ import annotations

import collections
import functools
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from . import lbfgs, lbfgsb
from .params import LBFGSBParams, LBFGSParams
from .types import SolveResult

Tensor = torch.Tensor


def _sorted_keys(tree: Any) -> Any:
    """``tree`` with every plain dict (and defaultdict) rebuilt in sorted
    key order, through lists, tuples, named tuples and ordered dicts: the
    order in which JAX flattens a tree."""
    if isinstance(tree, dict):
        keys = list(tree) if isinstance(tree, collections.OrderedDict) \
            else sorted(tree)
        out = {k: _sorted_keys(tree[k]) for k in keys}
        if isinstance(tree, collections.defaultdict):
            return collections.defaultdict(tree.default_factory, out)
        return type(tree)(out) if type(tree) is not dict else out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_sorted_keys(t) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted_keys(t) for t in tree)
    return tree


def ravel_pytree(tree: Any) -> Tuple[Tensor, Callable[[Tensor], Any]]:
    """``(flat, unravel)``: the leaves of ``tree`` in JAX's order (a
    dict's by sorted key) concatenated into one 1-D tensor of their
    promoted dtype, and the function that maps such a vector back to the
    tree (each leaf reshaped and cast to its own dtype)."""
    leaves, spec = pytree.tree_flatten(_sorted_keys(tree))
    leaves = [torch.as_tensor(leaf) for leaf in leaves]
    if leaves:
        dtype = functools.reduce(torch.promote_types,
                                 [leaf.dtype for leaf in leaves])
        flat = torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])
    else:
        flat = torch.zeros(0)
    shapes = [leaf.shape for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]

    def unravel(vec: Tensor) -> Any:
        parts = torch.split(vec, sizes) if sizes else []
        return pytree.tree_unflatten(
            [p.reshape(shape).to(dt)
             for p, shape, dt in zip(parts, shapes, dtypes)], spec)

    return flat, unravel


def _flat_objective(fun, fun_and_grad, unravel):
    """The objective on the flat vector; an explicit ``fun_and_grad``
    returns a gradient tree of ``x0``'s structure, raveled in the same
    leaf order (a dict's by key, whatever order it was built in)."""
    if fun_and_grad is not None:
        def fg_flat(z):
            fx, g_tree = fun_and_grad(unravel(z))
            return fx, ravel_pytree(g_tree)[0]
        return None, fg_flat
    if fun is None:
        raise ValueError("either 'fun' or 'fun_and_grad' must be provided")
    return (lambda z: fun(unravel(z))), None


def _unravel_result(res: SolveResult, unravel) -> SolveResult:
    return res._replace(x=unravel(res.x), grad=unravel(res.grad))


def minimize_pytree(fun: Optional[Callable] = None,
                    x0: Any = None,
                    params: LBFGSParams = LBFGSParams(),
                    *,
                    fun_and_grad=None,
                    line_search="nocedalwright",
                    history_dtype=None,
                    device=None) -> SolveResult:
    """Minimize a scalar function of a parameter tree with L-BFGS
    (lbfgspp_tpu/pytree.py:62-83): :func:`.lbfgs.minimize` of ``fun``
    composed with ``unravel``.  ``x``/``grad`` of the result have ``x0``'s
    structure; ``fx``, ``gnorm``, ``niter``, ``status`` and the (flat)
    ``history`` are the flat solve's.  ``history_dtype`` stores the
    flat history's rows at reduced precision (:func:`.lbfgs.solver`)."""
    flat0, unravel = ravel_pytree(x0)
    f_flat, fg_flat = _flat_objective(fun, fun_and_grad, unravel)
    res = lbfgs.minimize(f_flat, flat0, params, fun_and_grad=fg_flat,
                         line_search=line_search,
                         history_dtype=history_dtype, device=device)
    return _unravel_result(res, unravel)


def _ravel_bound(bound, x0, flat0: Tensor, side: str) -> Tensor:
    """A bound given as a tree matching ``x0`` (leaves broadcast to their
    parameter leaf; a dict's matched by key), a scalar, or None
    (unbounded), raveled."""
    if bound is None:
        fill = -torch.inf if side == "lb" else torch.inf
        return torch.full(flat0.shape, fill, dtype=flat0.dtype)
    x0, bound = _sorted_keys(x0), _sorted_keys(bound)
    treedef = pytree.tree_structure(x0)
    if pytree.tree_structure(bound) == treedef:
        leaves = pytree.tree_leaves(x0)
        parts = [torch.as_tensor(b, dtype=flat0.dtype)
                 .expand(torch.as_tensor(leaf).shape).reshape(-1)
                 for b, leaf in zip(pytree.tree_leaves(bound), leaves)]
        return torch.cat(parts) if parts else flat0
    b = torch.as_tensor(bound, dtype=flat0.dtype)
    if b.dim() != 0:
        raise ValueError(
            f"'{side}' must be a scalar or a tree matching x0's structure; "
            f"got structure {pytree.tree_structure(bound)} vs {treedef}")
    return torch.full(flat0.shape, float(b), dtype=flat0.dtype)


def minimize_b_pytree(fun: Optional[Callable] = None,
                      x0: Any = None,
                      lb: Any = None,
                      ub: Any = None,
                      params: LBFGSBParams = LBFGSBParams(),
                      *,
                      fun_and_grad=None,
                      line_search="morethuente",
                      gcp: str = "scan",
                      device=None) -> SolveResult:
    """Box-constrained minimization over a parameter tree (L-BFGS-B;
    lbfgspp_tpu/pytree.py:109-133).  ``lb``/``ub`` are each a scalar (one
    bound for every parameter), a tree matching ``x0`` whose leaves
    broadcast to their parameter leaf, or None (that side unbounded);
    ``lb == ub`` on a leaf pins it."""
    flat0, unravel = ravel_pytree(x0)
    f_flat, fg_flat = _flat_objective(fun, fun_and_grad, unravel)
    lbf = _ravel_bound(lb, x0, flat0, "lb")
    ubf = _ravel_bound(ub, x0, flat0, "ub")
    res = lbfgsb.minimize(f_flat, flat0, lbf, ubf, params,
                          fun_and_grad=fg_flat, line_search=line_search,
                          gcp=gcp, device=device)
    return _unravel_result(res, unravel)
