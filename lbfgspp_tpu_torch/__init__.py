"""lbfgspp_tpu_torch: the PyTorch/CUDA port of lbfgspp_tpu.

A second package beside the JAX one, for an NVIDIA H100.  Solver states are
batch-explicit (a leading batch axis; a single solve is a batch of one), and
the two-loop direction of a batched solve runs in a hand-written CUDA kernel
(``csrc/two_loop.cu``), built with nvcc on first use.  Entry points run on
the CUDA card unless the caller passes ``device="cpu"``.
"""

from .params import (LBFGSParams, LBFGSBParams,
                     LINESEARCH_BACKTRACKING_ARMIJO,
                     LINESEARCH_BACKTRACKING,
                     LINESEARCH_BACKTRACKING_WOLFE,
                     LINESEARCH_BACKTRACKING_STRONG_WOLFE)
from .types import (Status, SolveResult, LineSearchResult, SUCCESS_STATUSES,
                    make_fun_and_grad)
from .lbfgs import minimize, solver, Solver, LBFGSState
from .batch import minimize_batched
from .df64 import minimize_df64

__all__ = [
    "LBFGSParams", "LBFGSBParams",
    "LINESEARCH_BACKTRACKING_ARMIJO", "LINESEARCH_BACKTRACKING",
    "LINESEARCH_BACKTRACKING_WOLFE", "LINESEARCH_BACKTRACKING_STRONG_WOLFE",
    "Status", "SolveResult", "LineSearchResult", "SUCCESS_STATUSES",
    "make_fun_and_grad",
    "minimize", "solver", "Solver", "LBFGSState",
    "minimize_batched", "minimize_df64",
]
