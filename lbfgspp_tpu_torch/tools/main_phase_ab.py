#!/usr/bin/env python3
"""The full-width main phase of ``chip_smoke.py`` (phase 4) from one tree.

    python3 lbfgspp_tpu_torch/tools/main_phase_ab.py TREE

``TREE`` is the root of a checkout (this one, or another commit unpacked
with ``git archive`` into a gitignored directory); its
``lbfgspp_tpu_torch`` is imported.  4096 pairwise-Rosenbrock starts
(n=100, f32, m=16, 162 iterations, Nocedal-Wright capped at 2 trials,
``on_ls_fail="restart"``, ``direction="rinv"``) run once to warm up, then
three times; the line printed holds the three times, their median as
solves/s and frac_within_1e-4.  Compare two commits only inside one call
to the card, in turns, one process per turn:

    for t in parent . . parent; do python3 .../main_phase_ab.py $t; done
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch
    import lbfgspp_tpu_torch as lt
    from lbfgspp_tpu_torch.ops import fused
    from lbfgspp_tpu_torch.utils import objectives
    if not lt.__file__.startswith(root):
        raise RuntimeError(f"imported {lt.__file__}, not the tree {root}")
    if not torch.cuda.is_available():
        print("main_phase_ab: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    fused.build()
    x0s = torch.as_tensor(np.random.default_rng(0).uniform(
        -2.0, 2.0, (4096, 100)), dtype=torch.float32, device=dev)
    p = lt.LBFGSParams(epsilon=1e-5, max_iterations=162, m=16,
                       max_linesearch=2)

    def solve():
        return lt.minimize_batched(objectives.rosenbrock, x0s, p,
                                   direction="rinv", on_ls_fail="restart",
                                   device=dev)

    solve()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    err = (res.x.double() - 1).abs().max(1).values
    print(f"AB {root}: runs {' '.join(f'{t:.3f}' for t in times)} s, "
          f"median {np.median(times):.3f} s = "
          f"{4096 / np.median(times):.1f} solves/s, frac_within_1e-4 "
          f"{(err <= 1e-4).double().mean().item():.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
