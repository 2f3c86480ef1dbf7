"""Solver-state serialization.

The port's counterpart of ``lbfgspp_tpu.utils.checkpoint``: a solver
state (``LBFGSState``, ``LBFGSBState``, ``OWLQNState`` or a
``SolveResult``) is a tree of named tuples of tensors, flattened here to
``{leaf_path: np.ndarray}`` under the JAX module's key names (``"x"``,
``"hist/s"``, ...) and restored into a template state of the same
structure.  So a state saved by the JAX module loads into the port's:
a single solve's leaves (no batch axis) gain the batch axis of 1, and
bfloat16 rows, which numpy stores as raw 2-byte values, are read by their
bits (:func:`..interop.as_tensor`).  Restore is bit-exact.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..interop import as_tensor


def _key(path) -> str:
    return "/".join(str(getattr(p, "name", getattr(p, "idx",
                                                   getattr(p, "key", p))))
                    for p in path)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy has no bfloat16: its raw 2-byte values, as numpy itself
        # stores the JAX package's bfloat16 arrays
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def state_to_arrays(state) -> dict:
    """Flatten a solver state into ``{leaf_path: np.ndarray}``."""
    leaves = pytree.tree_flatten_with_path(state)[0]
    return {_key(path): _array(leaf) for path, leaf in leaves
            if leaf is not None}


def save_state(path: str, state) -> None:
    """``np.savez`` the state (``path`` should end in .npz)."""
    np.savez(path, **state_to_arrays(state))


def load_state(path: str, like):
    """Restore a state saved by :func:`save_state` or by the JAX
    package's ``save_state``.  ``like`` is a template state of the same
    structure (from ``solver.init`` on inputs of the right shapes and
    dtypes); each leaf takes its dtype and device, and a leaf saved
    without the batch axis gains it."""
    data = np.load(path)
    leaves, spec = pytree.tree_flatten_with_path(like)
    out = []
    for path_, leaf in leaves:
        if leaf is None:
            out.append(None)
            continue
        t = as_tensor(data[_key(path_)], dtype=leaf.dtype)
        if t.dim() == leaf.dim() - 1:
            t = t[None]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"load_state: {_key(path_)} has shape "
                             f"{tuple(t.shape)}, the template "
                             f"{tuple(leaf.shape)}")
        out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return pytree.tree_unflatten(out, spec)
