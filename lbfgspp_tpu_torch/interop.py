"""Carry solver state over from the JAX package.

The functions here take a JAX ``LBFGSHistory``, ``LBFGSState`` or
``SolveResult`` whose leaves are numpy arrays (for example
``jax.tree.map(np.asarray, state)``) and return the port's batched
tensors.  A single solve's state gets a batch axis of 1; a batch (a state
of ``vmap``, leading axis B) keeps its axis.  Only field names are read, so
nothing of the JAX package is imported.  A history whose rows are stored
in bfloat16 (``history_dtype``) arrives as numpy arrays of the ``ml_dtypes``
bfloat16 type (or of any 2-byte type holding its bits) and becomes
``torch.bfloat16`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .lbfgs import LBFGSState
from .ops.history import LBFGSHistory
from .types import SolveResult, resolve_device

_INT_FIELDS = ("ncorr", "ptr", "k", "niter", "nfev", "status")


def as_tensor(a, device=None, dtype=None) -> torch.Tensor:
    """A numpy array as a tensor; a bfloat16 array (``ml_dtypes``' type,
    which torch does not read) goes by its bits, as does any other 2-byte
    array that ``dtype=torch.bfloat16`` asks for."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16" or (dtype == torch.bfloat16
                                       and a.dtype.itemsize == 2):
        bits = torch.from_numpy(a.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device, dtype=dtype)


def _tensor(name: str, value, batched: bool, device) -> torch.Tensor:
    a = np.array(value)         # a writable copy
    if not batched:
        a = a[None]
    if name in _INT_FIELDS:
        a = a.astype(np.int32)
    return as_tensor(a, device)


def history_from_numpy(hist, device=None) -> LBFGSHistory:
    """A JAX ``LBFGSHistory`` of numpy arrays as the port's history."""
    device = resolve_device(device)
    batched = np.ndim(hist.s) == 3
    fields = {name: _tensor(name, getattr(hist, name), batched, device)
              for name in LBFGSHistory._fields if name != "rinv"}
    rinv = getattr(hist, "rinv", None)
    fields["rinv"] = (None if rinv is None
                      else _tensor("rinv", rinv, batched, device))
    return LBFGSHistory(**fields)


def state_from_numpy(state, device=None):
    """A JAX ``LBFGSState`` (or ``SolveResult``) of numpy arrays as the
    port's ``LBFGSState`` (or ``SolveResult``)."""
    device = resolve_device(device)
    batched = np.ndim(state.x) == 2
    cls = SolveResult if hasattr(state, "niter") else LBFGSState
    hist_field = "history" if cls is SolveResult else "hist"
    fields = {}
    for name in cls._fields:
        value = getattr(state, name)
        if name == hist_field:
            fields[name] = history_from_numpy(value, device)
        else:
            fields[name] = _tensor(name, value, batched, device)
    return cls(**fields)
