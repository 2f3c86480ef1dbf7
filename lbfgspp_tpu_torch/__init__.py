"""lbfgspp_tpu_torch: the PyTorch/CUDA port of lbfgspp_tpu.

A second package beside the JAX one, for an NVIDIA H100: L-BFGS, the
box-constrained L-BFGS-B and the L1-regularized OWL-QN, batched, with
their df64 polish phases; multi-batch stochastic L-BFGS; implicit
differentiation of solves; a front end for parameter trees; and the
interop front ends ``optax_compat`` (a ``torch.optim.Optimizer``),
``scipy_compat``, ``utils.checkpoint`` and ``utils.trace``.  Solver
states are batch-explicit (a leading batch axis; a single solve is a batch
of one), and the two-loop direction of a batched solve runs in a
hand-written CUDA kernel
(``csrc/two_loop.cu``: f32, f64, bf16, or bf16 history rows beside f32,
``history_dtype=torch.bfloat16``), built with nvcc on first use.

Feature-split solves run on ``torch.distributed``: ``minimize_sharded``,
``minimize_b_sharded`` (with the sortless walk Cauchy points),
``minimize_owlqn_sharded`` and ``implicit_minimize_sharded`` split ``x``
over the ranks of a process group, every reduction one all-reduce
(:mod:`.parallel`); ``minimize_batched(mesh=)`` and
``minimize_b_batched(mesh=)`` split a batch of instances over the ranks
instead, with no collective inside the solve.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.
"""

from .params import (LBFGSParams, LBFGSBParams,
                     LINESEARCH_BACKTRACKING_ARMIJO,
                     LINESEARCH_BACKTRACKING,
                     LINESEARCH_BACKTRACKING_WOLFE,
                     LINESEARCH_BACKTRACKING_STRONG_WOLFE)
from .types import (Status, SolveResult, LineSearchResult, SUCCESS_STATUSES,
                    make_fun_and_grad)
from .lbfgs import (minimize, solver, Solver, LBFGSState,
                    final_approx_hessian, final_approx_inverse_hessian)
from .lbfgsb import LBFGSBState
from .lbfgsb import minimize as minimize_b
from .lbfgsb import solver as solver_b
from .batch import (minimize_batched, minimize_b_batched, best_result,
                    polish_solve_owlqn)
from .df64 import minimize_df64
from .diff import implicit_minimize, implicit_minimize_sharded
from .owlqn import OWLQNState, minimize_owlqn, pseudo_gradient
from .pytree import minimize_b_pytree, minimize_pytree, ravel_pytree
from .stochastic import minimize_stochastic
from .parallel.sharded import (minimize_sharded, minimize_b_sharded,
                               minimize_owlqn_sharded, make_sharded_fg,
                               shard)

__all__ = [
    "LBFGSParams", "LBFGSBParams",
    "LINESEARCH_BACKTRACKING_ARMIJO", "LINESEARCH_BACKTRACKING",
    "LINESEARCH_BACKTRACKING_WOLFE", "LINESEARCH_BACKTRACKING_STRONG_WOLFE",
    "Status", "SolveResult", "LineSearchResult", "SUCCESS_STATUSES",
    "make_fun_and_grad",
    "minimize", "solver", "Solver", "LBFGSState",
    "final_approx_hessian", "final_approx_inverse_hessian",
    "minimize_b", "solver_b", "LBFGSBState",
    "minimize_batched", "minimize_b_batched", "best_result",
    "minimize_df64",
    "minimize_owlqn", "OWLQNState", "pseudo_gradient", "polish_solve_owlqn",
    "minimize_pytree", "minimize_b_pytree", "ravel_pytree",
    "minimize_stochastic", "implicit_minimize",
    "minimize_sharded", "minimize_b_sharded", "minimize_owlqn_sharded",
    "make_sharded_fg", "shard", "implicit_minimize_sharded",
]
