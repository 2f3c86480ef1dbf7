#!/usr/bin/env python3
"""Measurements of the two-loop kernel on one NVIDIA GPU.

    python3 -m lbfgspp_tpu_torch.tools.two_loop_study [--part plans|quality|all]
        [--kernels two_loop,two_loop_simple,two_loop_plain] [--seeds 0-9]
    python3 -m lbfgspp_tpu_torch.tools.two_loop_study --part ab \
        --other OTHER_TREE [--rounds R]
    python3 -m lbfgspp_tpu_torch.tools.two_loop_study --part route|chunk

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
against the same function evaluated in f64 on the same inputs.  Then the
whole three-phase path of ``chip_smoke.py`` phase 9 (the main phase, 5
warm df64 polish iterations, the deep stage) runs from the same starts
with the same kernel in every phase, and the instances it leaves beyond
1e-4 are printed with their distance.  ``--kernels`` and ``--seeds`` pick
which of the three run and from which start seeds;
``--polish-epsilon-rel`` sets the df64 phases' relative exit test (the
recipe keeps ``LBFGSParams``' default).

``ab``: this checkout's kernel against another build of it.
``OTHER_TREE`` is the root of another checkout (a commit unpacked with
``git archive`` into a gitignored directory); its ``two_loop.cu`` is built
with this checkout's nvcc flags, and both libraries, which share one C
interface, launch with the same plan on the same tensors.  Both are first
held against the plain version at the main shape (B=4096, m=16, n=100)
and the box polish's (m=6, n=20), f32 and f64.  Then every 8th call of the
main phase of ``chip_smoke.py`` phase 4 (also lifted to pair space,
n=200) and random histories at the box shape give each kernel's error
against f64, beside ``two_loop_simple``'s and the plain version's (median
and 99th percentile over calls and instances).  Last, the two are timed
in turns (other, this, this, other; ``--rounds`` times at the main shape
in ``rinv`` f32, once at the other shapes), each a median of 25 launches
with the L2 flushed before each.

``route``: where ``fused.route`` should send rows longer than
``fused.LARGE_N``.  For every instantiation (f32, f64, bf16 rows beside
f32, all bf16), ``rinv``, m=6, full rings of random rows, at B = 1 to
2112 and n = 2^14 to 2^17, the kernel (launched with its own plan) and
the plain version are checked against each other and timed two ways:
device time (CUDA events, median of 25 launches, the L2 flushed) and the
time a solver's loop pays per call (host clock over 25 calls in a row),
beside the route ``fused.two_loop`` takes.

``chunk``: the largest-n solve of ``chip_smoke.py`` phase 20 (n = 2^27,
f32, m=6, epsilon=0, 6 and 16 iterations differenced) with bf16 rows
under several sizes of the plain version's widened chunk
(``fused.PLAIN_CHUNK_BYTES``), and with f32 rows, in turns; then one
profiled iteration of each.

Every part writes its results to ``chiprun_out/two_loop_study.json`` and
prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import lbfgspp_tpu_torch as lt
from lbfgspp_tpu_torch.ops import fused, history
from lbfgspp_tpu_torch.tools.capture import capture_calls, rel_errors
from lbfgspp_tpu_torch.utils import cuda_build, objectives

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
POLISH_ITERS, DEEP_ITERS, DEEP_FRAC = 5, 60, 3 / 16
BOX_N, BOX_M = 20, 6
KEEP_EVERY = 8


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
                    yield fused._layout_plan(BATCH, M, n,
                                             fused.KINDS[dtype, dtype], sms,
                                             warps, stages, staged)
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


def cast(args, dtype):
    return tuple(t.to(dtype) if t is not None and t.is_floating_point()
                 else t for t in args)


def args_of(h, v):
    return (h.s, h.y, h.ys, h.theta, h.ptr, h.ncorr, h.sy, h.yy, h.rinv, v)


def tracked(kernel, errors):
    """``kernel`` with the error of each call recorded in ``errors``: per
    instance, ``max|out - ref| / max|ref|`` against the same function
    evaluated in f64 on the same inputs."""
    def call(*args):
        out = kernel(*args)
        *tensors, a, mode = args
        ref = fused.two_loop_plain(*cast(tensors, torch.float64), a, mode)
        errors.append(rel_errors(out, ref))
        return out
    return fused.with_counts(call)


def beyond(x, tol):
    """The instances further than ``tol`` from the optimum, and the
    distance of each."""
    err = (x.double() - 1.0).abs().max(dim=1).values.cpu()
    idx = np.flatnonzero(err.numpy() > tol)
    return {int(i): float(err[i]) for i in idx}


def study_quality(dev, names=("two_loop", "two_loop_simple",
                                  "two_loop_plain"), seeds=QUALITY_SEEDS,
                  polish_epsilon_rel=None):
    params = lt.LBFGSParams(epsilon=1e-5, max_iterations=MAIN_ITERS, m=M,
                            max_linesearch=2)
    main = dict(direction="rinv", on_ls_fail="restart", device=dev)
    # the bench recipe's df64 phases (chip_smoke.py phase 9)
    recipe = dict(polish_iters=POLISH_ITERS, polish_warm=True,
                  polish_params=lt.LBFGSParams(
                      epsilon=1e-5, max_iterations=MAIN_ITERS, m=M,
                      **({} if polish_epsilon_rel is None else
                         {"epsilon_rel": polish_epsilon_rel})),
                  polish_line_search="morethuente", deep_frac=DEEP_FRAC,
                  deep_iters=DEEP_ITERS, **main)
    every = {"two_loop": fused.two_loop,
             "two_loop_simple": fused.two_loop_simple,
             "two_loop_plain": fused.two_loop_plain}
    kernels = {name: every[name] for name in names}
    rows = []
    try:
        for seed in seeds:
            x0s = torch.as_tensor(np.random.default_rng(seed).uniform(
                -2.0, 2.0, (BATCH, MAIN_N)), dtype=torch.float32,
                device=dev)
            misses = {}
            for label, kernel in kernels.items():
                errors = []
                fused.two_loop = tracked(kernel, errors)
                if not rows and not misses:    # warm-up
                    lt.minimize_batched(objectives.rosenbrock, x0s, params,
                                        **main)
                    errors.clear()
                res = lt.minimize_batched(objectives.rosenbrock, x0s,
                                          params, **main)
                miss4 = set(beyond(res.x, 1e-4))
                miss3 = len(beyond(res.x, 1e-3))
                rel = torch.stack(errors)            # [calls, B]
                # the whole path, its every call through the same kernel
                fused.two_loop = kernel
                full = beyond(lt.minimize_batched(
                    objectives.rosenbrock, x0s, params, **recipe).x, 1e-4)
                misses[label] = miss4
                rows.append(dict(seed=seed, kernel=label, misses_1e4=
                                 sorted(miss4), misses_1e3=miss3,
                                 full_path_misses_1e4=full,
                                 rel_err_median=rel.median().item(),
                                 rel_err_p99=rel.quantile(0.99).item(),
                                 rel_err_max=rel.max().item()))
                print(f"   seed {seed} {label:15s}: {len(miss4):2d} instances "
                      f"beyond 1e-4 (frac_within_1e-4="
                      f"{1 - len(miss4) / BATCH:.4f}), {miss3} beyond 1e-3; "
                      f"error against f64 per "
                      f"call and instance: median {rows[-1]['rel_err_median']:.3e}"
                      f", p99 {rows[-1]['rel_err_p99']:.3e}, max "
                      f"{rows[-1]['rel_err_max']:.3e}; after the df64 polish "
                      f"and deep stage {len(full)} beyond 1e-4 "
                      f"{full or ''}", flush=True)
            a = misses.get("two_loop", set())
            for label in list(kernels)[1:]:
                b = misses[label]
                print(f"   seed {seed}: two_loop and {label} share "
                      f"{len(a & b)} misses", flush=True)
        for label in kernels:
            mine = [r for r in rows if r["kernel"] == label]
            total = sum(len(r["misses_1e4"]) for r in mine)
            left = sum(len(r["full_path_misses_1e4"]) for r in mine)
            print(f"   all seeds, {label}: {total} misses of "
                  f"{BATCH * len(seeds)} at 1e-4 after the main "
                  f"phase, {left} after the full path; error against f64 "
                  f"median of medians "
                  f"{np.median([r['rel_err_median'] for r in mine]):.3e}, "
                  f"worst p99 {max(r['rel_err_p99'] for r in mine):.3e}",
                  flush=True)
    finally:
        fused.two_loop = every["two_loop"]
    return rows


def build_other(tree: str) -> ctypes.CDLL:
    """Another checkout's kernel, built into that checkout's own build
    directory."""
    src = os.path.join(tree, "lbfgspp_tpu_torch", "csrc", "two_loop.cu")
    out_dir = os.path.join(tree, "lbfgspp_tpu_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libtwo_loop_other.so")
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                           lib, src], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return fused.typed(ctypes.CDLL(lib))


def launcher(lib):
    def run(*args):
        *tensors, a, mode = args
        return fused._launch(fused.plan_for(*tensors, mode), *tensors, a,
                             mode, lib=lib)
    return run


def pair_lifted(args):
    """A call lifted to pair space: s, y and v doubled along n with zero
    low words, as the df64 phases' histories are."""
    s, y, ys, th, ptr, nc, sy, yy, rinv, v = args
    z = torch.zeros_like(s)
    return (torch.cat([s, z], 2), torch.cat([y, z], 2), ys, th, ptr, nc, sy,
            yy, rinv, torch.cat([v, v], 1).contiguous())


def study_ab(dev, other: str, rounds: int):
    impls = {"this": launcher(fused._library()),
             "other": launcher(build_other(os.path.abspath(other))),
             "two_loop_simple": fused.two_loop_simple,
             "two_loop_plain": fused.two_loop_plain}
    out = {"check": [], "accuracy": {}, "timing": []}
    for label, (n, m) in (("main", (MAIN_N, M)), ("box", (BOX_N, BOX_M))):
        h = random_history(BATCH, n, m, seed=m, device=dev)
        v = torch.randn(BATCH, n, dtype=torch.float64, device=dev)
        for dtype in (torch.float32, torch.float64):
            args = cast(args_of(h, v), dtype)
            for mode in ("rinv", "sweeps"):
                want = fused.two_loop_plain(*args, -1.0, mode)
                scale = want.abs().max().item()
                for name in ("this", "other"):
                    err = (impls[name](*args, -1.0, mode) -
                           want).abs().max().item()
                    ok = err <= TOLERANCE[dtype] * scale
                    out["check"].append(dict(shape=label, dtype=str(dtype),
                                             mode=mode, kernel=name,
                                             err=err, ok=ok))
                    print(f"   {label} {str(dtype)[6:]} {mode:6s} {name:5s}: "
                          f"max_abs_err {err:.3e} (scale {scale:.3e}) "
                          f"{'ok' if ok else 'TOO LARGE'}", flush=True)

    x0s = torch.as_tensor(np.random.default_rng(0).uniform(
        -2.0, 2.0, (BATCH, MAIN_N)), dtype=torch.float32, device=dev)
    params = lt.LBFGSParams(epsilon=1e-5, max_iterations=MAIN_ITERS, m=M,
                            max_linesearch=2)
    result = []
    main_calls = capture_calls(lambda: result.append(lt.minimize_batched(
        objectives.rosenbrock, x0s, params, direction="rinv",
        on_ls_fail="restart", device=dev)), every=KEEP_EVERY)
    box_calls = [cast(args_of(random_history(BATCH, BOX_N, BOX_M, 100 + k,
                                             dev),
                              torch.randn(BATCH, BOX_N, dtype=torch.float64,
                                          device=dev)), torch.float32)
                 for k in range(4)]
    sets = {"main rinv": (main_calls, "rinv"),
            "pair rinv": ([pair_lifted(c) for c in main_calls[::2]], "rinv"),
            "box sweeps": (box_calls, "sweeps")}
    for label, (calls, mode) in sets.items():
        errs = {name: [] for name in impls}
        for args in calls:
            ref = fused.two_loop_plain(*cast(args, torch.float64), -1.0,
                                       mode)
            for name, fn in impls.items():
                errs[name].append(rel_errors(fn(*args, -1.0, mode), ref))
        row = {}
        for name, e in errs.items():
            e = torch.cat(e)
            row[name] = dict(median=e.median().item(),
                             p99=e.quantile(0.99).item(), max=e.max().item())
        out["accuracy"][label] = row
        print(f"   error against f64, {label} ({len(calls)} calls x "
              f"{BATCH} instances): " + "; ".join(
                  f"{name} median {r['median']:.3e} p99 {r['p99']:.3e}"
                  for name, r in row.items()), flush=True)

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    res = result[0]
    main32 = args_of(res.history, res.grad.contiguous())
    cases = [("main rinv f32", main32, "rinv", rounds),
             ("main sweeps f32", main32, "sweeps", 1),
             ("main rinv f64", cast(main32, torch.float64), "rinv", 1),
             ("pair rinv f32", pair_lifted(main32), "rinv", 1),
             ("box sweeps f32", box_calls[0], "sweeps", 1),
             ("box sweeps f64", cast(box_calls[0], torch.float64), "sweeps",
              1)]
    for label, args, mode, n_rounds in cases:
        turns = []
        for _ in range(n_rounds):
            for name in ("other", "this", "this", "other"):
                turns.append((name, median_ms(
                    lambda: impls[name](*args, -1.0, mode), flush)))
        this = float(np.median([ms for k, ms in turns if k == "this"]))
        that = float(np.median([ms for k, ms in turns if k == "other"]))
        out["timing"].append(dict(case=label, turns=turns, this_median=this,
                                  other_median=that))
        print(f"   {label}: this {this:.4f} ms, other {that:.4f} ms, ratio "
              f"{this / that:.3f}; turns "
              + " ".join(f"{k[0]}{ms:.4f}" for k, ms in turns), flush=True)
    return out


# The dispatch rule's sweep: every instantiation, rinv, m=6.
ROUTE_KINDS = {"f32": (torch.float32, torch.float32),
               "f64": (torch.float64, torch.float64),
               "bf16rows": (torch.bfloat16, torch.float32),
               "bf16": (torch.bfloat16, torch.bfloat16)}
ROUTE_BATCHES = (1, 8, 132, 264, 528, 1056, 2112)
ROUTE_LOG_N = (14, 15, 16, 17)
ROUTE_M = 6
# The largest-n solve (chip_smoke.py phase 20) under each chunk size of
# the plain version's widened bf16 rows, in bytes; 6 * 4 * 2^22 is the
# first design's 2^22 columns at m=6.
CHUNK_BYTES = (1 << 22, 1 << 24, 1 << 25, 1 << 27, 1 << 28, 1 << 29,
               6 * 4 * (1 << 22))
LARGEST_N, LARGEST_M, LARGEST_ITERS = 1 << 27, 6, (6, 16)


def per_call_ms(fn, calls=TIMED_LAUNCHES) -> float:
    """The time a solver's loop pays per call: host clock over ``calls``
    calls in a row, then a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def synthetic(batch, n, m, row_dtype, dtype, seed, device):
    """Random rows and well-scaled [m, m] operands made on the card, full
    rings (a history of this size is not built pair by pair)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=device)
    s = rand(batch, m, n).to(row_dtype)
    y = rand(batch, m, n).to(row_dtype)
    ys = (torch.rand(batch, m, generator=g, device=device) + 1.0).to(dtype)
    mats = [rand(batch, m, m, scale=0.01).to(dtype) for _ in range(3)]
    full = torch.full((batch,), m, dtype=torch.int32, device=device)
    return (s, y, ys, torch.ones(batch, dtype=dtype, device=device), full,
            full.clone(), *mats, rand(batch, n).to(dtype))


def study_route(dev):
    """Kernel (launched with its own plan) against the plain version at
    every (B, n) of the sweep, for every instantiation: device time (CUDA
    events, median of 25, the L2 flushed, the host held back) and the time
    per call in a loop, beside the route ``fused.two_loop`` takes."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = []
    for kind, (row_dtype, dtype) in ROUTE_KINDS.items():
        for batch in ROUTE_BATCHES:
            for lg in ROUTE_LOG_N:
                args = synthetic(batch, 1 << lg, ROUTE_M, row_dtype, dtype,
                                 seed=lg, device=dev)
                plan = fused.plan_for(*args, "rinv")

                def kernel():
                    return fused._launch(plan, *args, -1.0, "rinv")

                def plain():
                    return fused.two_loop_plain(*args, -1.0, "rinv")
                got, want = kernel().float(), plain().float()
                err = ((got - want).abs().amax(1) /
                       want.abs().amax(1).clamp_min(1e-30)).max().item()
                row = dict(kind=kind, batch=batch, log_n=lg, err=err,
                           kernel_ms=median_ms(kernel, flush),
                           plain_ms=median_ms(plain, flush),
                           kernel_call_ms=per_call_ms(kernel),
                           plain_call_ms=per_call_ms(plain),
                           route=fused.route(*args, "rinv")[1] or "kernel",
                           warps=plan.warps, grid=plan.grid,
                           staged=plan.staged)
                rows.append(row)
                print(f"   {kind:8s} B={batch:4d} n=2^{lg}: device kernel "
                      f"{row['kernel_ms']:.4f} plain {row['plain_ms']:.4f} "
                      f"ms; per call kernel {row['kernel_call_ms']:.4f} "
                      f"plain {row['plain_call_ms']:.4f} ms; error "
                      f"{err:.2e}; plan {plan.warps}x{plan.stages} grid "
                      f"{plan.grid} staged {plan.staged}; route "
                      f"{row['route']}", flush=True)
                del args, got, want
                torch.cuda.empty_cache()
    return rows


def study_chunk(dev, rounds: int):
    """The largest-n solve (rosenbrock_split, n = 2^27, f32, m=6,
    epsilon=0; 6 and 16 iterations, differenced) with bf16 rows under
    each of CHUNK_BYTES and with f32 rows, in turns (forward then
    backward), then one profiled iteration of each chunk size's bf16-row
    solve (``torch.profiler``: the top device kernels)."""
    x0 = 2.0 * torch.rand(LARGEST_N, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev) - 1.0
    variants = [("bf16", b) for b in CHUNK_BYTES] + [("f32", None)]
    default = fused.PLAIN_CHUNK_BYTES

    def solve(rows, budget, iters):
        fused.PLAIN_CHUNK_BYTES = budget or default
        p = lt.LBFGSParams(epsilon=0.0, epsilon_rel=0.0,
                           max_iterations=iters, m=LARGEST_M)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lt.minimize(objectives.rosenbrock_split, x0, p,
                          history_dtype=torch.bfloat16 if rows == "bf16"
                          else None, device=dev)
        torch.cuda.synchronize()
        if int(res.niter) != iters or not bool(torch.isfinite(res.fx)):
            raise AssertionError(f"n=2^27: niter {int(res.niter)}")
        return time.perf_counter() - t0

    solve("bf16", None, 2)                             # warm-up
    times = {v: [] for v in variants}
    for r in range(rounds):
        for v in (variants if r % 2 == 0 else variants[::-1]):
            torch.cuda.reset_peak_memory_stats()
            k1, k2 = LARGEST_ITERS
            t1, t2 = solve(*v, k1), solve(*v, k2)
            times[v].append(dict(s_per_iter=(t2 - t1) / (k2 - k1),
                                 peak_gb=torch.cuda.max_memory_allocated()
                                 / 1e9))
            print(f"   round {r} {v[0]} rows, chunk {v[1]} B: "
                  f"{times[v][-1]['s_per_iter']:.4f} s/iteration, peak "
                  f"{times[v][-1]['peak_gb']:.2f} GB", flush=True)
            torch.cuda.empty_cache()
    out = []
    for v, t in times.items():
        med = float(np.median([x["s_per_iter"] for x in t]))
        out.append(dict(rows=v[0], chunk_bytes=v[1], s_per_iter=med,
                        turns=t))
        print(f"   {v[0]} rows, chunk {v[1]} B: median {med:.4f} "
              f"s/iteration over {len(t)} turns", flush=True)
    from torch.profiler import ProfilerActivity, profile
    for rows, budget in variants:
        fused.PLAIN_CHUNK_BYTES = budget or default
        s = lt.solver(objectives.rosenbrock_split,
                      lt.LBFGSParams(epsilon=0.0, epsilon_rel=0.0,
                                     max_iterations=100, m=LARGEST_M),
                      history_dtype=torch.bfloat16 if rows == "bf16"
                      else None, device=dev)
        state = s.init(x0)
        for _ in range(LARGEST_M + 1):
            state = s.step(state)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state = s.step(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"   profile, one iteration, {rows} rows chunk {budget} B: "
              f"host {wall * 1e3:.2f} ms, device busy {busy:.2f} ms in "
              f"{sum(e.count for e in kernels)} launches; top kernels (ms, "
              f"launches):", flush=True)
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"      {e.self_device_time_total / 1e3:9.3f} "
                  f"{e.count:5d}x  {e.key[:90]}", flush=True)
        del s, state
        torch.cuda.empty_cache()
    fused.PLAIN_CHUNK_BYTES = default
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="two_loop,two_loop_simple,"
                    "two_loop_plain", help="quality: the kernels to compare")
    ap.add_argument("--seeds", default="0-9",
                    help="quality: the start seeds, as FIRST-LAST")
    ap.add_argument("--polish-epsilon-rel", type=float, default=None,
                    help="quality: the df64 phases' epsilon_rel (default: "
                    "the recipe's, LBFGSParams' default)")
    ap.add_argument("--other", help="ab: the root of the other checkout")
    ap.add_argument("--rounds", type=int, default=4,
                    help="ab: rounds of turns at the main shape; chunk: "
                    "rounds of turns")
    ap.add_argument("--part", choices=("plans", "quality", "all", "ab",
                                       "route", "chunk"),
                    default="all")
    opts = ap.parse_args()
    part = opts.part
    first, last = (int(v) for v in opts.seeds.split("-"))
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
        out["quality"] = study_quality(dev, opts.kernels.split(","),
                                       tuple(range(first, last + 1)),
                                       opts.polish_epsilon_rel)
    if part == "route":
        print("== the dispatch rule: kernel against plain by (B, n)",
              flush=True)
        out["route"] = study_route(dev)
    if part == "chunk":
        print("== the largest-n solve by the plain version's chunk size",
              flush=True)
        out["chunk"] = study_chunk(dev, opts.rounds)
    if part == "ab":
        if not opts.other:
            ap.error("--part ab needs --other")
        print("== this kernel against the other tree's", flush=True)
        torch.manual_seed(0)
        out["ab"] = study_ab(dev, opts.other, opts.rounds)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "two_loop_study.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 1 if any(not c["ok"] for c in out.get("ab", {}).get("check", ())) \
        else 0


if __name__ == "__main__":
    sys.exit(main())
