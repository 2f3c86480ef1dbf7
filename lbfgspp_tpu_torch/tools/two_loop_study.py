#!/usr/bin/env python3
"""Two measurements of the two-loop kernel on one NVIDIA GPU.

    python3 -m lbfgspp_tpu_torch.tools.two_loop_study [--part plans|quality|all]

``plans``: where rows should stop being staged.  At B=4096, m=16 and a
range of n in f32 and f64, every launch layout that fits a block (1-8
warps, 1-2 stages, rows staged in shared memory or left in device memory)
is first checked against the plain version, then timed in both modes
(CUDA events, median of 25 launches, the L2 flushed before each, the card
held back while the host queues them, as in ``chip_smoke.py`` phase 5).
For each shape it prints the best staged and the best unstaged layout,
each with its warps per SM, and the layout ``fused.launch_plan`` picks.

``quality``: whether the main phase's quality fractions move with the
kernel's summation order alone.  The main phase of ``chip_smoke.py``
phase 4 (4096 pairwise-Rosenbrock starts, n=100, f32, m=16, rinv) runs
from several start seeds through ``fused.two_loop``, then with
``fused.two_loop_simple`` (the first design of the kernel) and with
``fused.two_loop_plain`` in its place: three summation orders of one
function, everything else the same code.  It prints the instances further
than 1e-4 / 1e-3 from the optimum under each, and the error of every call
against the same function evaluated in f64 on the same inputs.

Both write their results to ``chiprun_out/two_loop_study.json`` and print
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

import lbfgspp_tpu_torch as lt
from lbfgspp_tpu_torch.ops import fused, history
from lbfgspp_tpu_torch.utils import objectives

BATCH, M = 4096, 16
# Rows of n * itemsize a multiple of 16 go by bulk copy, the others by
# cp.async: each side of the plan's cut, in both copy paths.
SHAPES = {torch.float32: (100, 101, 200, 300, 301, 416, 417, 600, 1000,
                          1001, 1700),
          torch.float64: (100, 101, 150, 151, 198, 199, 300, 301, 600,
                          1000)}
TOLERANCE = {torch.float32: 1e-4, torch.float64: 1e-11}
L2_FLUSH_BYTES = 128 << 20
TIMED_LAUNCHES = 25
HEAD_START_CYCLES = 200_000_000
QUALITY_SEEDS = tuple(range(10))
MAIN_N, MAIN_ITERS = 100, 162


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def random_history(batch, n, m, seed, device):
    """A history with a mix of fill levels and wrapped rings, built in f64
    on ``device`` from accepted random pairs."""
    rng = np.random.default_rng(seed)
    ncorrs = rng.integers(0, 3 * m, batch)
    h = history.init_history(batch, n, m, torch.float64, device=device,
                             with_rinv=True)
    for t in range(int(ncorrs.max())):
        s = torch.randn(batch, n, dtype=torch.float64, device=device)
        y = s * torch.empty(batch, 1, dtype=torch.float64,
                            device=device).uniform_(0.5, 2.0) \
            + 0.3 * torch.randn_like(s)
        y = torch.where((s * y).sum(1, keepdim=True) < 0, -y, y)
        h, _ = history.update_history(
            h, s, y, torch.as_tensor(t < ncorrs, device=device))
    return h


def median_ms(fn, flush) -> float:
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HEAD_START_CYCLES)
    events = []
    for _ in range(TIMED_LAUNCHES):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def layouts(n, dtype, sms):
    """Every layout that fits a block, as ``fused._layout_plan`` builds
    it."""
    for staged in (True, False):
        for stages in (1, 2):
            for warps in range(1, fused.MAX_WARPS + 1):
                try:
                    yield fused._layout_plan(BATCH, M, n, dtype, sms, warps,
                                             stages, staged)
                except ValueError:
                    pass


def study_plans(dev):
    sms = fused.num_sms(dev)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    torch.manual_seed(0)
    rows = []
    for dtype, ns in SHAPES.items():
        name = str(dtype)[6:]
        for n in ns:
            h64 = random_history(BATCH, n, M, seed=n, device=dev)
            h = type(h64)(*(t.to(dtype) if t.is_floating_point() else t
                            for t in h64))
            v = torch.randn(BATCH, n, dtype=dtype, device=dev)
            args = (h.s, h.y, h.ys, h.theta, h.ptr, h.ncorr, h.sy, h.yy,
                    h.rinv, v)
            chosen = fused.plan_for(*args, "rinv")
            for mode in ("rinv", "sweeps"):
                want = fused.two_loop_plain(*args, -1.0, mode)
                scale = want.abs().max().item()
                timed = []
                for plan in layouts(n, dtype, sms):
                    got = fused._launch(plan, *args, -1.0, mode)
                    err = (got - want).abs().max().item()
                    if not err <= TOLERANCE[dtype] * scale:
                        raise AssertionError(
                            f"{name} n={n} {mode} {plan.warps}x{plan.stages}"
                            f" staged={plan.staged}: error {err:.3e} against"
                            f" a scale of {scale:.3e}")
                    ms = median_ms(lambda: fused._launch(plan, *args, -1.0,
                                                         mode), flush)
                    timed.append(dict(
                        warps=plan.warps, stages=plan.stages,
                        staged=plan.staged,
                        warps_per_sm=plan.warps * plan.blocks_per_sm,
                        ms=ms))
                best = {}
                for staged in (True, False):
                    mine = [t for t in timed if t["staged"] == staged]
                    best[staged] = min(mine, key=lambda t: t["ms"]) \
                        if mine else None
                picked = next(t for t in timed
                              if (t["warps"], t["stages"], t["staged"]) ==
                              (chosen.warps, chosen.stages, chosen.staged))
                row = dict(dtype=name, n=n, mode=mode,
                           best_staged=best[True], best_unstaged=best[False],
                           plan=picked, layouts=timed)
                rows.append(row)
                s, u = best[True], best[False]
                staged_best = "none fits" if s is None else (
                    f"{s['ms']:.4f} ms ({s['warps']}x{s['stages']}, "
                    f"{s['warps_per_sm']} warps/SM)")
                print(f"   {name} n={n:4d} {mode:6s}: staged best "
                      f"{staged_best}; unstaged best "
                      f"{u['ms']:.4f} ms ({u['warps']}x{u['stages']}, "
                      f"{u['warps_per_sm']} warps/SM); plan "
                      f"{picked['warps']}x{picked['stages']} "
                      f"{'staged' if picked['staged'] else 'unstaged'} "
                      f"{picked['ms']:.4f} ms", flush=True)
                # fewest staged warps per SM at which staging still wins
                for t in sorted((t for t in timed if t["staged"]),
                                key=lambda t: t["warps_per_sm"]):
                    print(f"      staged {t['warps']}x{t['stages']} "
                          f"({t['warps_per_sm']:2d} warps/SM) "
                          f"{t['ms']:.4f} ms", flush=True)
            del h64, h, v, args
    return rows


def tracked(kernel, errors):
    """``kernel`` with the error of each call recorded in ``errors``: per
    instance, ``max|out - ref| / max|ref|`` against the same function
    evaluated in f64 on the same inputs."""
    def call(*args):
        out = kernel(*args)
        *tensors, a, mode = args
        ref = fused.two_loop_plain(
            *(t.double() if t is not None and t.is_floating_point() else t
              for t in tensors), a, mode)
        scale = ref.abs().max(dim=1).values.clamp_min(1e-300)
        errors.append(((out.double() - ref).abs().max(dim=1).values
                       / scale).cpu())
        return out
    # fused.two_loop counts its launches on whatever fused.two_loop is
    call.launches = 0
    return call


def study_quality(dev):
    params = lt.LBFGSParams(epsilon=1e-5, max_iterations=MAIN_ITERS, m=M,
                            max_linesearch=2)
    kernels = {"two_loop": fused.two_loop,
               "two_loop_simple": fused.two_loop_simple,
               "two_loop_plain": fused.two_loop_plain}
    rows = []
    try:
        for seed in QUALITY_SEEDS:
            x0s = torch.as_tensor(np.random.default_rng(seed).uniform(
                -2.0, 2.0, (BATCH, MAIN_N)), dtype=torch.float32,
                device=dev)
            misses = {}
            for label, kernel in kernels.items():
                errors = []
                fused.two_loop = tracked(kernel, errors)
                if not rows and not misses:    # warm-up
                    lt.minimize_batched(objectives.rosenbrock, x0s, params,
                                        direction="rinv",
                                        on_ls_fail="restart", device=dev)
                    errors.clear()
                res = lt.minimize_batched(objectives.rosenbrock, x0s,
                                          params, direction="rinv",
                                          on_ls_fail="restart", device=dev)
                err = (res.x.double() - 1.0).abs().max(dim=1).values.cpu()
                miss4 = set(np.flatnonzero(err.numpy() > 1e-4).tolist())
                miss3 = int((err > 1e-3).sum())
                rel = torch.stack(errors)            # [calls, B]
                misses[label] = miss4
                rows.append(dict(seed=seed, kernel=label, misses_1e4=
                                 sorted(miss4), misses_1e3=miss3,
                                 rel_err_median=rel.median().item(),
                                 rel_err_p99=rel.quantile(0.99).item(),
                                 rel_err_max=rel.max().item()))
                print(f"   seed {seed} {label:15s}: {len(miss4):2d} instances "
                      f"beyond 1e-4 (frac_within_1e-4="
                      f"{1 - len(miss4) / BATCH:.4f}), {miss3} beyond 1e-3; "
                      f"error against f64 per "
                      f"call and instance: median {rows[-1]['rel_err_median']:.3e}"
                      f", p99 {rows[-1]['rel_err_p99']:.3e}, max "
                      f"{rows[-1]['rel_err_max']:.3e}", flush=True)
            a = misses["two_loop"]
            for label in list(kernels)[1:]:
                b = misses[label]
                print(f"   seed {seed}: two_loop and {label} share "
                      f"{len(a & b)} misses", flush=True)
        for label in kernels:
            mine = [r for r in rows if r["kernel"] == label]
            total = sum(len(r["misses_1e4"]) for r in mine)
            print(f"   all seeds, {label}: {total} misses of "
                  f"{BATCH * len(QUALITY_SEEDS)} at 1e-4; error against f64 "
                  f"median of medians "
                  f"{np.median([r['rel_err_median'] for r in mine]):.3e}, "
                  f"worst p99 {max(r['rel_err_p99'] for r in mine):.3e}",
                  flush=True)
    finally:
        fused.two_loop = kernels["two_loop"]
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("plans", "quality", "all"),
                    default="all")
    part = ap.parse_args().part
    if not torch.cuda.is_available():
        print("two_loop_study: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    fused.build()
    out = {"card": card_line()}
    print(out["card"], flush=True)
    if part in ("plans", "all"):
        print("== staged against unstaged rows, B=4096 m=16", flush=True)
        out["plans"] = study_plans(dev)
    if part in ("quality", "all"):
        print("== main-phase quality by kernel and start seed", flush=True)
        out["quality"] = study_quality(dev)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "two_loop_study.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
