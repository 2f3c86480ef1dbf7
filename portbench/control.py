"""The controls of ``correct``: a cell's run with its control in the
program's place, judged by the same reference and limits.

    python3 -m portbench.control --workload <cell> --seed <n> [--seed ...]
        [--seconds <s>]

The traffic file's ``control`` says what stands in the program's place.
A multistart traffic's ``reference_dtype`` names the lower type (float32
for a float64 cell) in which the plain reference answers the sampled
starts instead.  A traffic's ``kinds`` name controls of this module's
:data:`KINDS`, every one run on the cell's own cards:

* ``pairs_m_minus_1``: the direction from the newest m - 1 correction
  pairs (the reference's float64 two-loop over them) in the program's;
* ``unreduced_logits``: rank 0 takes part in the logits' all-reduce but
  keeps its own partial logits;
* ``design_bf16``: the design's values rounded to bfloat16 before the
  program holds them: slightly wrong data, not narrower arithmetic (the
  one-hots and the bias are 1.0 in bfloat16; the program still computes
  in float32);
* ``history_bf16``: the program's own narrower path, its correction pairs
  stored in bfloat16 (``history_dtype``; the configuration states
  float32).

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
    """``(traffic, answers)`` of a multistart traffic's control."""
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


def _fewer_pairs(sample, ctx):
    ref = run.load_module("reference", ctx.cfg["name"])
    keep = sample["order"][1:]
    s = [sample["s"][j] for j in keep]
    y = [sample["y"][j] for j in keep]
    d = ref.two_loop(s, y, sample["g"], ctx.group)
    return dict(sample, d=d.to(sample["d"].dtype))


def _unreduced_logits(ctx):
    if ctx.rank != 0:
        return
    from lbfgspp_tpu_torch.parallel import collectives as coll
    real = coll.psum

    def psum(x, group=None, site="psum"):
        out = real(x, group, site)
        return x.clone() if site == "logreg.logits" else out
    coll.psum = psum


def _design_bf16(ctx):
    import torch
    ctx.design_values = lambda v: v.to(torch.bfloat16).to(v.dtype)


def _history_bf16(ctx):
    ctx.traffic = dict(ctx.traffic, history_dtype="bfloat16")


# kind -> (prepare, answers)
KINDS = {
    "pairs_m_minus_1": (None, _fewer_pairs),
    "unreduced_logits": (_unreduced_logits, None),
    "design_bf16": (_design_bf16, None),
    "history_bf16": (_history_bf16, None),
}


def hooks(kind: str):
    """The rank's ``(prepare, answers)`` of the control ``kind``
    (:func:`portbench.run.launch`'s ``hooks``)."""
    return KINDS[kind]


def run_control(spec, cell, cfg, traffic, seed, seconds, kind=None):
    """One run of ``cell`` under a control: ``kind`` of :data:`KINDS` on
    the cell's cards, or (None) the multistart traffic's reference type.
    Returns the run's result, or None if a rank failed."""
    if kind is None:
        traffic, answers = setup(traffic)
        return run.run_cell(spec, cell, cfg, traffic, seed, seconds, False,
                            "cuda:0", answers=answers)
    rc, out = run.launch(spec, cell, cfg, traffic, seed, seconds, False,
                         int(cell["chips"]), hooks="portbench.control:hooks",
                         hook_args=[kind])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    run.cache_dirs()
    spec, cell, cfg, traffic = run.resolve(args.workload)
    for kind in traffic["control"].get("kinds", [None]):
        for seed in args.seed:
            out = run_control(spec, cell, cfg, traffic, seed, args.seconds,
                              kind)
            line = dict(workload=args.workload, seed=seed,
                        control=kind or traffic["control"])
            if out is None:
                line.update(correct=False, failed_to_run=True)
            else:
                line.update(correct=out["correct"], checks=out["checks"],
                            numbers=out["numbers"])
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
