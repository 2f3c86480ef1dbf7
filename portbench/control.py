"""The controls of ``correct``: a cell's run with its control in the
program's place, judged by the same reference and limits.

    python3 -m portbench.control --workload <cell> --seed <n> [--seed ...]
        [--seconds <s>]

The traffic file's ``control`` says what stands in the program's place:
its ``reference_dtype`` names the lower type (float32 for a float64 cell)
in which the plain reference answers the sampled starts instead.

Each seed prints its checks and whether the run came out correct; a
control has to come out not correct.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

from portbench import run


def setup(traffic):
    """``(traffic, answers)`` of the traffic's control."""
    return (copy.deepcopy(traffic),
            reference_answers(traffic["control"]["reference_dtype"]))


def reference_answers(dtype: str):
    """The multistart reference's solves in ``dtype`` in the program's
    place: its x, and its value where the program reports one."""
    def answers(sample, ctx):
        import numpy as np
        import torch
        ref = run.load_module("reference", ctx.cfg["name"])
        p = ref.params(ctx.traffic["check"]["reference"])
        if dtype == "bfloat16":
            rows = [torch.tensor(r, dtype=torch.bfloat16)
                    for r in sample["x0"]]
            tiny = torch.finfo(torch.bfloat16).eps
        else:
            rows = [np.asarray(r, getattr(np, dtype)) for r in sample["x0"]]
            tiny = np.finfo(getattr(np, dtype)).eps
        out = [ref.solve(r, p, tiny) for r in rows]
        x = np.stack([np.asarray(torch.as_tensor(o[0]).double()) for o in out])
        fx = np.array([float(o[1]) for o in out])
        return dict(sample, x=x, fx=None if sample.get("fx") is None else fx)
    return answers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    run.cache_dirs()
    spec, cell, cfg, traffic = run.resolve(args.workload)
    traffic, answers = setup(traffic)
    for seed in args.seed:
        out = run.run_cell(spec, cell, cfg, traffic, seed, args.seconds,
                           False, "cuda:0", answers=answers)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              control=traffic["control"],
                              correct=out["correct"], checks=out["checks"],
                              numbers=out["numbers"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
