"""The split logistic regression on a hashed, sparse design: one rank's
oracle for the port's feature-split solver.

``f(w) = mean_r softplus(-b_r a_r.w) + (l2 / 2) ||w||^2`` with the
features split in contiguous blocks over the ranks.  A rank holds its
columns of every row twice, as CSR of ``[rows, n_local]`` (the logits)
and of its transpose (the gradient), so both passes are sparse
matrix-vector products over rows in order.  Each evaluation takes one
all-reduce of the ``[rows]`` partial logits through the port's
collectives (site ``logreg.logits``); the loss is then replicated, and
rank 0 adds it to its partial value, so that the value is a sum of
partials (:class:`lbfgspp_tpu_torch.parallel.collectives.ShardedObjective`)
and the port's line search folds its ``g.d`` into the value's all-reduce.

Every evaluation is the harness span ``portbench.eval`` and is counted;
in a traced run the span waits for the card at both ends, so that the
device work inside it is the evaluation's own.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F
from torch.profiler import record_function

SPAN = "portbench.eval"


def make(design: dict, l2: float, group, rank: int, trace: bool,
         counts: dict):
    """The batched oracle ``w [1, n_local] -> (fx [1], g [1, n_local])``
    over ``design`` (:func:`portbench.hashed_rows.local_design`);
    ``counts["evals"]`` counts its calls."""
    from lbfgspp_tpu_torch.parallel import collectives as coll
    rows, n_local = design["rows"], design["n_local"]
    warnings.filterwarnings("ignore", "Sparse CSR tensor support")
    a = torch.sparse_csr_tensor(design["crow"], design["col"],
                                design["val"], (rows, n_local),
                                check_invariants=False)
    at = torch.sparse_csr_tensor(design["tcrow"], design["trow"],
                                 design["tval"], (n_local, rows),
                                 check_invariants=False)
    b = design["labels"]
    dev = b.device

    def sync():
        if trace and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def partial(w):
        counts["evals"] += 1
        with record_function(SPAN):
            sync()
            w0 = w[0]
            z = coll.psum(a @ w0, group, "logreg.logits")
            t = -b * z
            loss = F.softplus(t).sum() / rows
            grad = at @ (-b * torch.sigmoid(t) / rows) + l2 * w0
            fx = 0.5 * l2 * torch.dot(w0, w0)
            if rank == 0:
                fx = fx + loss
            sync()
        return fx.reshape(1), grad[None]

    return coll.ShardedObjective(partial, group)
