#!/usr/bin/env python3
"""Why an instance ends beyond 1e-4 after the full three-phase path.

    python3 -m lbfgspp_tpu_torch.tools.full_path_misses SEED:INDEX ...

For each start seed (4096 pairwise-Rosenbrock starts, n=100, as in
``chip_smoke.py`` phase 9), the bench recipe runs phase by phase with the
same calls ``minimize_batched`` makes: the f32 main phase, 5 warm df64
polish iterations, the deep stage's selection and its 60 cold df64
iterations on the worst 768 (More-Thuente, ``direction="rinv"``).  For the
instance ``INDEX`` it prints, after each phase, the status, iterations,
gradient norm and distance from the optimum, the pair-space gradient test
the polish exits at, and whether (and at which rank) the deep stage
selected it.  Needs a CUDA card.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import lbfgspp_tpu_torch as lt
from lbfgspp_tpu_torch import batch as TB
from lbfgspp_tpu_torch.ops import fused
from lbfgspp_tpu_torch.utils import objectives

BATCH, N, K_DEEP = 4096, 100, 768


def report(seed: int, who: int, dev) -> str:
    f = objectives.rosenbrock
    main_p = lt.LBFGSParams(epsilon=1e-5, max_iterations=162, m=16,
                            max_linesearch=2)
    full = lt.LBFGSParams(epsilon=1e-5, max_iterations=162, m=16)
    x0s = torch.as_tensor(np.random.default_rng(seed).uniform(
        -2.0, 2.0, (BATCH, N)), dtype=torch.float32, device=dev)
    main = lt.minimize_batched(f, x0s, main_p, direction="rinv",
                               on_ls_fail="restart", device=dev)
    pol = TB.polish_solve(f, main.x, full, 5, line_search="morethuente",
                          direction="rinv", warm_history=main.history,
                          device=dev)
    merged = TB._merge_polished(main, pol)
    sel = TB._select_stragglers(merged, K_DEEP, "rinv", "gnorm")
    deep = TB.deep_polish(f, merged, full, K_DEEP, 60,
                          line_search="morethuente", direction="rinv")

    def err(r):
        return (r.x[who].double() - 1).abs().max().item()

    def phase(r):
        return (f"status {int(r.status[who])} niter {int(r.niter[who])} "
                f"gnorm {r.gnorm[who].item():.3e} err {err(r):.3e}")

    rank = (sel == who).nonzero().flatten().tolist()
    x2 = torch.cat([pol.x[who], torch.zeros_like(pol.x[who])])
    exit_at = max(full.epsilon,
                  full.epsilon_rel * torch.linalg.vector_norm(x2).item())
    final = (deep.x.double() - 1).abs().max(1).values
    return (f"seed {seed} instance {who}: main {phase(main)}; polish "
            f"{phase(pol)} (pair-space exit gnorm <= {exit_at:.3e}); deep "
            f"selected {bool(rank)} rank {rank} of {K_DEEP} (gnorm rank cut "
            f"{merged.gnorm[sel[-1]].item():.3e}); final {phase(deep)}; "
            f"misses now {torch.nonzero(final > 1e-4).flatten().tolist()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("full_path_misses: no CUDA device is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    fused.build()
    for arg in sys.argv[1:]:
        seed, who = (int(v) for v in arg.split(":"))
        print(report(seed, who, dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
