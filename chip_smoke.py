#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it does.

    python3 chip_smoke.py

Phases (any failure makes the script exit 1 and print no result):

1. build the CUDA two-loop kernels from ``lbfgspp_tpu_torch/csrc`` (nvcc,
   sm_90a), print ptxas's registers and spills for each instantiation and
   the launch plans of the main shape (the native core's builds run
   beside it);
2. hold the kernel against its plain PyTorch version in float and double,
   in ``sweeps`` and ``rinv`` mode, at the main path's shape (B=4096, m=16,
   n=100) and at odd shapes (mixed fill levels with empty and wrapped
   rings, m=1, m=33, the ragged persistent walk B=4097, rows that are not
   16-byte multiples n=101, s / v as views at an odd storage offset, and
   n=1000, staged at one warp per SM in f32 and left in device memory
   in f64);
3. run f64 diagonal-quadratic and separable-quartic batches on the card:
   their iteration counts must equal the port's own CPU run;
4. run the main phase at full width: 4096 pairwise-Rosenbrock starts
   (n=100, f32, m=16, 162 iterations, Nocedal-Wright capped at 2 trials,
   ``on_ls_fail="restart"``, ``direction="rinv"``) through
   ``minimize_batched``, after one warm-up run.  Every x must be finite,
   every status a success, and the kernel's launch count must equal the
   batched iterations executed; prints solves/s and the fractions of
   instances within 1e-3 / 1e-4 of the optimum (informational: the
   every-run 1e-4 gate needs the df64 phases of a later slice);
5. time the kernel alone at the main path's shape on the main phase's
   final state (CUDA events, median of 25 launches, L2 flushed before
   each), in ``rinv`` and ``sweeps`` mode, f32 and f64, in turns with the
   first design ``two_loop_simple`` (simple, new, new, simple), beside its
   memory bound, its share of it and the plain version's time; before
   that, the card's achievable bandwidth (a 64 MB device copy timed the
   same way);
6. profile 20 iterations of the main phase (``torch.profiler``): host ms,
   eager ops and kernel launches per iteration, device busy time and
   idle share, and the top kernels and operators;
7. pair (df64) arithmetic on the card: ``two_sum``/``two_prod`` exact
   against f64, a square exact against rationals, and the pair ops, the
   compensated sum, ``exp`` and the pair objective of Rosenbrock equal to
   the same calls on the CPU bit for bit (one rounding per eager op: no
   FMA contraction, no folded constants);
8. the kernel against its plain version at the df64 phases' pair shapes
   (B=4096 and 768, n=200, m=16, histories lifted to pair space with zero
   lo halves), in ``rinv`` and ``sweeps`` mode;
9. the full three-phase main path at full width through
   ``minimize_batched`` (bench.py:81-116): the phase-4 main phase, 5
   warm-started df64 polish iterations and the deep stage (60 cold df64
   iterations on the worst 3/16 of the batch), both with More-Thuente at
   the full trial budget, after one warm-up run, three timed runs.  Prints
   each phase's seconds, solves/s, batched pair evaluations (lockstep
   More-Thuente trials) per iteration and the quality fractions after
   each phase; the kernel's launches must equal main iterations + (1 warm
   start + polish iterations) + deep iterations, the df64 interpreter
   must take no fallback, every x must be finite and every instance
   within 1e-4 of the optimum (the reference's every-run criterion);
10. profile the polish and the deep stage's first 5 iterations
   (``torch.profiler``): host ms, eager ops, launches and lockstep
   More-Thuente trials per iteration, device busy time and idle share;
11. the box-constrained path at full width (bench.py:139-175):
   ``minimize_b_batched`` on 4096 Rosenbrock starts, n=10, in [2, 4], f32,
   the prefix GCP, with the active-set df64 polish (``polish_iters=4``),
   after one warm-up run, three timed runs; then the same with x[2]
   unbounded (as in example-rosenbrock-box.cpp), whose polish has a free
   coordinate to refine.  Prints the seconds of the box solve and of the
   polish, box solves/s, batched evaluations per iteration, the BOXCQP
   lockstep iterations and exit-test syncs, the polish's L-BFGS steps and
   frac_within_1e-4 of (2, 4, ...) before and after the polish.  The
   two-loop kernel's launches must equal the polish's steps (the bench
   recipe's polish pins every coordinate and takes none); every x must be
   finite, every instance of the bench recipe within 1e-4 with fx <= 5 +
   1e-3, and the free variant's pinned pairs within 1e-4;
12. the kernel against its plain version on the box polish's own calls
   (B=4096, m=6, n=20 pair space, ``sweeps``), f32 and f64, and its time
   there beside its bound;
13. profile 10 box iterations (``torch.profiler``): host ms, eager ops,
   launches and device-to-host reads per iteration, device busy time and
   idle share;
14. time the kernel at the solver families' shapes (``sweeps``, f32):
   B=1, m=8, n=256 (the stochastic step), B=1024, m=6, n=64 (OWL-QN and
   the implicit adjoint's preconditioner) and its pair shape n=128 (the
   OWL-QN polish), beside the bound and the plain version's time;
15. OWL-QN on 1024 lassos with their own data (A 128 x 64, a 6-sparse w,
   lambda 0.01, f32; scripts/probe_families.py:31-66) through
   ``minimize_owlqn``: (a) at full f32, (b) with ``fast_phase_epsilon``
   (phase 1 with TF32 matmuls in the objective), (c) the df64
   ``polish_solve_owlqn`` of (a), each a warm-up that also captures the
   path's kernel calls (the kernel held against plain on every 7th) and
   three timed runs.  Prints solves/s, niter, statuses, nnz, the f64 KKT
   violation and the batched evaluations per iteration.  Launches must
   equal the batched iterations, the interpreter takes no fallback,
   every x is finite, (c)'s f64 full objective is within 1e-12 of (a)'s
   or below it, its pinned zeros are exact +0.0, and the first 64 are
   within 1e-5 of the port's f64 CPU solve;
16. multi-batch stochastic L-BFGS on a 2^16 x 256 logistic regression
   made on the card (batch 4096, overlap 0.25, step 0.5, m=8, 100 steps,
   f32; scripts/probe_families.py:71-99): iterations/s, the full-data
   loss before and after (at most 0.25 ln 2), ``nskip``, 100 launches,
   the kernel against plain on every call, and an f64 run on the card
   equal to the CPU's to 1e-8;
17. implicit differentiation (tests/test_implicit.py:83-107 scaled up):
   the d(validation loss)/d(log lambda) of 1024 ridge logistic
   regressions (512 + 512 rows, d=64, f32) through ``loss.backward()``,
   forward and backward seconds, CG lockstep iterations with and without
   the preconditioner; the backward's launches must equal the CG
   iterations + 1, every hypergradient finite, and an f64 run of the
   first 16 within 1e-5 of central finite differences (eps 1e-5) of the
   validation loss at Newton-refined argmins.

18. the kernel's bf16 modes (all bf16, as the Pallas kernel's bf16 mode;
   bf16 rows beside f32 operands, as a float32 solve with
   ``history_dtype=torch.bfloat16``) against the plain version, in
   ``sweeps`` and ``rinv``, at the main shape, m=1 with B=4097 and n=101
   (rows in device memory), s / v at an odd offset, and bf16 rows at B=1,
   m=6, n=2^27 (the kernel launched directly: ``two_loop`` sends that
   shape to the plain version), then a call through each plain route of
   ``fused.route`` (m=200 f32, m=120 f64, f16, n=2^27) counted in
   ``two_loop.plain_routes``, the kernel against plain in f32 and with
   bf16 rows at B = 1 to 2112 and n = 2^14..2^16 (the dispatch rule: the
   route taken must not lose on both device time and time per call by
   more than 25%), and the modes' times at the
   main shape on phase 4's state in turns with f32 (CUDA events, median of
   25, L2 flushed), beside the bound;
19. phase 4's main phase through ``lbfgs.minimize`` with f32 rows and
   with bf16 rows (``history_dtype``), in turns, then all in bf16 (x0
   bf16, ``sweeps``, epsilon 0.125): solves/s and quality fractions;
   every x finite, the launches of each mode equal the batched
   iterations, no plain route;
20. the largest-n solve (scripts/bench_largest_n.py's plain path):
   ``rosenbrock_split`` at n = 2^27, f32, m=6, epsilon=0, 6 and 16
   iterations differenced, with bf16 rows and with f32 rows: seconds per
   iteration, bytes per iteration and their share of the measured
   bandwidth, peak memory;
21. ``history_dtype=torch.bfloat16`` on phase 15's lasso and phase 16's
   stochastic run (rows stored in bf16, phase 16's loss gate), one
   ``scipy_compat.minimize`` solve on the card, 20 ``optax_compat.LBFGS``
   steps of a small MLP and a checkpoint round trip of a card state.

22. the collectives (``parallel/collectives.py``) on an NCCL group of one
   rank: each equals its local value, one call per site;
23. the feature-split logistic regression at n = 2^27
   (scripts/bench_largest_n_logreg.py: 8 rows regenerated from seeded
   generators in 4 row chunks in both passes of every evaluation, m=6,
   f32, epsilon 0) through ``minimize_sharded`` on that group, 6 and 16
   iterations differenced, f32 and bf16 rows: seconds per iteration,
   bytes per iteration against the measured bandwidth, peak memory,
   all-reduces per iteration by site; x, fx and niter bit-identical to
   the same solve on the oracle without its all-reduce;
24. ``tools/sharded_cases.chip_cases`` at n = 2^20, f64, on two gloo ranks
   sharing the card (CUDA tensors; ``tools/spawn_ranks.py``) against the
   same cases on the group of one: the logistic regression, the chained
   Rosenbrock in [2, 4] through ``minimize_b_sharded(gcp="auto")``, a
   lasso through ``minimize_owlqn_sharded`` and the hypergradient of
   ``implicit_minimize_sharded``: equal counts, x (or the gradient)
   within 1e-8, the solver's all-reduce sites within the JAX audit's
   budget;
25. ``minimize_batched(mesh=)`` and ``minimize_b_batched(mesh=)`` on the
   group of one: phases 9 and 11 again, bit for bit, with their
   launches, only the batch's own all-reduces (the selections' score
   gathers and the result's) and the every-run gates; then the box
   recipe through ``gcp="walk"``, ``"walk_chunked"`` and
   ``"walk_auto"``: box solves/s, walk rounds per GCP call, every
   instance within 1e-4.

26. the native core (``csrc/native``, built in phase 1 beside two_loop:
   nvcc for the card, g++ for the host), ptxas's registers, stack and
   spills for both kernels (one warp per instance) and their launch plans
   (warps per block, blocks per SM, the workspace in shared or device
   memory); the builtin quadratic (B=256, n=100, each search) through
   ``native_lbfgs_batch`` with counts and statuses equal to the host
   build and to the port's batched ``lbfgs.minimize`` on the card, x to
   1e-12; the anchor (Rosenbrock n=10 from 0: 22 iterations, fx <= 1e-12)
   on the card; random boxes (B=256, n=10, Rosenbrock) through
   ``native_lbfgsb_batch`` with the host build's statuses and fx to 1e-6
   relative (x within 1e-8 of the host's is counted); then the multistart
   at full width (4096 Rosenbrock starts ``uniform(-2, 2)``, n=100, f64,
   m=6, max_linesearch=256, max_iterations=400), each search in turns on
   the kernel (one launch), the host build on every core and the port's
   batched ``lbfgs.minimize``: solves/s, statuses, frac_within_1e-4 (the
   kernel's within 0.004 of the host's); phase 11's starts through the box
   kernel (every instance within 1e-4 of (2, 4, ...)); the kernels' time
   beside their bound (f64 flops from the solves' counts over the FP64
   peak); the builds without multiply-add contraction bit for bit against
   the host's ``Lanes`` build (the warp's summation order on one thread)
   on every random box, all 4096 instances of each search and the box
   starts; and the 2-D batch x feature case (``sharded_cases.mesh_2d``)
   on four gloo ranks sharing the card, equal to the single-process
   batched solve (x to 1e-12, niter equal).

Phase 5 also times the kernel at the pair shapes beside their bound;
phase 2 also checks the solver families' shapes.  The last lines are the
card's name and power limit (nvidia-smi), a JSON ``kernels`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
# outside tensor cores; the kernel computes bf16 operands in float32
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12}
L2_FLUSH_BYTES = 128 << 20      # > the 50 MB L2
TIMED_LAUNCHES = 25
COPY_PROBE_BYTES = 64 << 20     # the achievable-bandwidth probe
HEAD_START_CYCLES = 200_000_000  # ~0.1 s of card time before a timed run

PROFILE_WARMUP, PROFILE_ITERS = 10, 20
PROFILE_DEEP_ITERS = 5

MAIN_BATCH, MAIN_N, MAIN_M = 4096, 100, 16
MAIN_ITERS = 162
POLISH_ITERS, DEEP_ITERS, DEEP_FRAC = 5, 60, 3 / 16
DEEP_BATCH = max(1, min(MAIN_BATCH, int(round(DEEP_FRAC * MAIN_BATCH))))
FULL_PATH_RUNS = 3
BOX_BATCH, BOX_N, BOX_ITERS, BOX_POLISH_ITERS = 4096, 10, 60, 4
BOX_RUNS, PROFILE_BOX_ITERS = 3, 10
DEVICE = "cuda"
# The solver families (phases 14-17).
FAMILY_RUNS = 3
OWL_BATCH, OWL_ROWS, OWL_N, OWL_LAM, OWL_ITERS = 1024, 128, 64, 0.01, 150
OWL_POLISH_ITERS, OWL_CHECK = 30, 64
STOCH_ROWS, STOCH_DIM, STOCH_BATCH = 1 << 16, 256, 4096
STOCH_M, STOCH_STEPS = 8, 100
IMP_BATCH, IMP_ROWS, IMP_D, IMP_CHECK = 1024, 512, 64, 16
# The largest-n solve (phase 20; scripts/bench_largest_n.py) and the
# kernel's bf16-row check at its shape (phase 18).
LARGEST_N = 1 << 27
LOGREG_ROWS, LOGREG_CHUNKS = 8, 4     # scripts/bench_largest_n_logreg.py
SPLIT_N = 1 << 20                     # phase 24's two ranks on one card
SPLIT_TIMEOUT = 600
# The native core on the card (phase 26): the multistart settings of the
# verify recipe (m=6, max_linesearch=256, max_iterations=400), its checks'
# batch, and the 2-D batch x feature case on four gloo ranks.
NATIVE_BATCH, NATIVE_N, NATIVE_M = 4096, 100, 6
NATIVE_TRIALS, NATIVE_ITERS, NATIVE_CHECK = 256, 400, 256
NATIVE_LATENCY_REPS = 2000
MESH2D_B, MESH2D_N, MESH2D_TIMEOUT = 8, 32, 300
# The JAX audit's static all-reduce counts (tests/test_collective_audit.py)
# for the solver's own sites; an objective's own all-reduces come on top.
AUDIT_BUDGET = {"logreg": 6, "box_auto": 60, "owlqn": 5, "implicit": 12}
OBJECTIVE_SITES = ("logreg.", "chained.", "lasso.", "objective")
# The dispatch rule's sweep (phase 18): the batches of each type around
# its threshold, and n around fused.LARGE_N; the route two_loop takes may
# lose to the other on one of device time and time per call, or on both
# by at most this share.
RULE_POINTS = {"f32": (1, 8, 1056, 2112), "bf16rows": (1, 132, 264, 2112)}
RULE_LOG_N = (14, 15, 16)
RULE_MARGIN = 0.25


def _log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def random_history(torch, history, batch, n, m, ncorrs, seed, device):
    """A port history with ``ncorrs[b]`` accepted random pairs in instance
    b, built in f64 on ``device``."""
    rng = np.random.default_rng(seed)
    h = history.init_history(batch, n, m, torch.float64, device=device,
                             with_rinv=True)
    ncorrs = np.asarray(ncorrs)
    for t in range(int(ncorrs.max())):
        s = rng.standard_normal((batch, n))
        y = s * rng.uniform(0.5, 2.0, (batch, 1)) \
            + 0.3 * rng.standard_normal((batch, n))
        y[np.einsum("bn,bn->b", s, y) < 0] *= -1.0
        h, _ = history.update_history(
            h, torch.as_tensor(s, device=device),
            torch.as_tensor(y, device=device),
            torch.as_tensor(t < ncorrs, device=device))
    return h


def ptxas_report(log: str):
    """One line per compiled function (kernels and out-of-line device
    functions): its name and ptxas's registers, stack and spills."""
    mangled = []
    for line in log.splitlines():
        if "Function properties for" in line:
            mangled.append(line.split("Function properties for", 1)[1].strip())
    try:
        names = subprocess.run(["c++filt"], input="\n".join(mangled),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) != len(mangled):
        names = mangled
    out, k = [], -1
    for line in log.splitlines():
        if "Function properties for" in line:
            k += 1
        elif ("registers" in line or "spill" in line or "error" in line) \
                and k >= 0:
            out.append(f"{names[k][:70]}: {line.split(':', 1)[-1].strip()}")
    return out


def at_odd_offset(torch, t):
    """The same values as a contiguous view one element into its storage,
    so its address is not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def kernel_args(h, v):
    return (h.s, h.y, h.ys, h.theta, h.ptr, h.ncorr, h.sy, h.yy, h.rinv, v)


def cast(h, dtype):
    return type(h)(*(t.to(dtype) if t.is_floating_point() else t
                     for t in h))


def args_bytes(args, mode) -> int:
    """Bytes one call on ``kernel_args`` must move: each input read once,
    the output (v's shape and type) written once."""
    v = args[9]
    mats = (args[8] if mode == "rinv" else args[6], args[7])
    return sum(t.numel() * t.element_size()
               for t in args[:6] + (v,) + mats) + \
        v.numel() * v.element_size()


def two_loop_flops(batch, m, n, mode) -> int:
    # 2m dots and the 2m-row combine: 8mn; recursion: 3 (rinv) or 2m+1
    # (sweeps) [m, m] matvecs.
    matvecs = 3 if mode == "rinv" else 2 * m + 1
    return batch * (8 * m * n + 2 * n + 2 * m * m * matvecs)


def pair_state(torch, batch_mod, h, grad, batch, seed):
    """The df64 phases' first two-loop input, built from a main-phase
    final state: ``batch`` instances (all of them, or a random subset as
    the deep stage refines), the history lifted to pair space (zero lo
    halves, n -> 2n) and the pair gradient ``[g; g]``."""
    from lbfgspp_tpu_torch.types import tree_map
    idx = np.sort(np.random.default_rng(seed).permutation(
        grad.shape[0])[:batch])
    idx = torch.as_tensor(idx, device=grad.device)
    g = grad[idx]
    h2 = tree_map(lambda t: t[idx].contiguous(),
                  batch_mod._lift_history_pairs(h, "rinv"))
    return h2, torch.cat([g, g], dim=1).contiguous()


def cast_args(args, dtype):
    return tuple(t.to(dtype) if t is not None and t.is_floating_point()
                 else t for t in args)


def median_ms_of(torch, fn, flush) -> float:
    """CUDA-event time of ``fn``: the median of TIMED_LAUNCHES launches,
    the L2 flushed before each, the card held back while the host queues
    them all (so that the events time the card's work, not the host's
    enqueue)."""
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


def time_vs_bound(torch, fused, args, mode, flush) -> dict:
    """The kernel's and the plain version's time of one two-loop call
    (:func:`median_ms_of`) beside its bound: the larger of the bytes it
    must move over the memory rate and its operations over the peak
    rate."""
    k_ms = median_ms_of(torch, lambda: fused.two_loop(*args, -1.0, mode),
                        flush)
    p_ms = median_ms_of(torch, lambda: fused.two_loop_plain(*args, -1.0,
                                                            mode), flush)
    s, v = args[0], args[9]
    batch, m, n = s.shape
    nbytes = args_bytes(args, mode)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = two_loop_flops(batch, m, n, mode) / \
        PEAK_FLOPS[str(v.dtype)[6:]] * 1e3
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                mbytes=nbytes / 1e6, ops_ms=t_ops)


def native_flops(niter, nfev, n, m, obj_flops, box=False) -> float:
    """f64 flops of the native solves, counted from each instance's
    iterations k and evaluations e, iteration i (0-based) with c = min(i, m)
    corrections: per evaluation a trial point, the objective (``obj_flops``
    per coordinate) and ``g.d``, (4 + obj) n; per L-BFGS iteration the
    two-loop 8cn + 2n and the update's and norms' dots 10n; per L-BFGS-B
    iteration the Cauchy point's W'd and the update's S'S and L rows, 8cn,
    the vector work around them, 20n, and the middle matrix's inverse of
    order d = 2c, one LU (2/3) d^3 and d solves of 2 d^2.  The subspace
    step's products over the free set are left out (the outputs do not
    record its size), so the box count is a lower bound."""
    k = niter.double().cpu()
    per_eval = (4 + obj_flops) * n * nfev.double().cpu()
    # iterations with c corrections: one each for c < m while i < k, the
    # rest (k - m of them) at c = m
    c = k.new_tensor(range(m + 1))
    iters = (k[:, None] - c).clamp(min=0)
    iters[:, :m] = iters[:, :m].clamp(max=1)
    if not box:
        per_iter = (8 * c + 12) * n
    else:
        d = 2 * c
        per_iter = (8 * c + 20) * n + (2 / 3) * d ** 3 + 2 * d ** 3
    return float((per_eval.sum() + (iters * per_iter).sum()))


def bitwise(xa, oa, xb, ob) -> bool:
    """Whether two native runs (x and the outputs fx, gnorm, niter, nfev,
    status) are equal bit for bit, on any devices."""
    import torch

    def bits(t):
        t = t.cpu().contiguous()
        return t.double().view(torch.int64) if t.is_floating_point() else t
    return all(bits(a).equal(bits(b)) for a, b in zip((xa, *oa), (xb, *ob)))


def native_bound(niter, nfev, n, m, obj_flops, nbytes, box=False):
    """``(bound_ms, bound_by)`` of a native launch: its f64 flops over the
    card's FP64 (non-tensor) peak, or the bytes it must move (x0 and any
    bounds read, x and the five outputs written) over the memory rate."""
    t_ops = native_flops(niter, nfev, n, m, obj_flops, box) / \
        PEAK_FLOPS["float64"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def event_ms(torch, fn):
    """``(ms, fn())``: CUDA-event time of one call, the card idle before."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


def lasso_loss(x, d):
    """One lasso instance's smooth part, ``0.5 ||A x - b||^2``."""
    return 0.5 * ((d["A"] @ x - d["b"]) ** 2).sum()


def logreg_loss(w, batch):
    """Mean logistic loss of ``w`` on a batch of rows."""
    import torch
    logits = batch["X"] @ w
    return torch.mean(torch.logaddexp(torch.zeros_like(logits), logits)
                      - batch["y"] * logits)


def ridge_loss(w, th):
    """One ridge logistic regression (labels +-1), its weight
    ``exp(loglam)``."""
    import torch
    z = th["y"] * (th["A"] @ w)
    return torch.logaddexp(torch.zeros_like(z), -z).mean() + \
        0.5 * torch.exp(th["loglam"]) * (w * w).sum()


def frac_within(x, tol) -> float:
    return ((x.double() - 1.0).abs().max(dim=1).values <= tol).double() \
        .mean().item()


class Smoke:
    def __init__(self):
        self.failures = []
        self.kernel_rows = {}

    def phase(self, name, fn):
        _log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:       # report every phase, then fail the run
            # on both streams: a run's standard error holds little else,
            # so its end names the failed phase and the gate's message
            traceback.print_exc(file=sys.stdout)
            print(f"chip_smoke: phase {name!r} FAILED:", file=sys.stderr)
            traceback.print_exc(file=sys.stderr)
            self.failures.append(name)
            _log(f"   FAILED: {name}")
        _log(f"   ({time.perf_counter() - t0:.1f} s)")

    def fail(self) -> int:
        """Name the failed phases on both streams; the exit code."""
        _log("FAILED: " + ", ".join(self.failures))
        print("chip_smoke: FAILED: " + ", ".join(self.failures),
              file=sys.stderr)
        return 1


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import lbfgspp_tpu_torch as lt
        from lbfgspp_tpu_torch import batch as lbatch
        from lbfgspp_tpu_torch import native
        from lbfgspp_tpu_torch.ops import fused, history
        from lbfgspp_tpu_torch.tools.capture import capture_calls
        from lbfgspp_tpu_torch.utils import cuda_build, objectives
        from lbfgspp_tpu_torch.utils import doublefloat as dfl
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    smoke = Smoke()
    main_state = {}

    # 1 ---------------------------------------------------------------
    def build():
        # the native core's builds (nvcc for the card, g++ for the host;
        # each also without multiply-add contraction) run beside
        # two_loop's, one compiler process each
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            builds = [pool.submit(native.build, device, contract)
                      for device in ("cuda", "cpu")
                      for contract in (True, False)]
            fused.build()
            _log(f"   built two_loop in {time.perf_counter() - t0:.1f} s")
            for job in builds:
                job.result()
        _log(f"   built the native core for the card and the host in "
             f"{time.perf_counter() - t0:.1f} s (all builds)")
        for line in ptxas_report(cuda_build.build_logs.get("two_loop", "")):
            _log("   ptxas:", line)
        for dtype in (torch.float32, torch.float64):
            plan = fused.launch_plan(MAIN_BATCH, MAIN_M, MAIN_N,
                                     fused.KINDS[dtype, dtype],
                                     fused.num_sms(dev))
            _log(f"   plan {str(dtype)[6:]}: {plan}")

    smoke.phase("build the CUDA kernel", build)
    if smoke.failures:
        return smoke.fail()

    # 2 ---------------------------------------------------------------
    # Tolerance, relative to the largest output entry: 1e-11 in f64 and
    # 1e-4 in f32.  Both sides sum in another order; these random
    # histories are well conditioned.
    tolerances = {torch.float64: 1e-11, torch.float32: 1e-4}
    cases = [
        ("main shape", MAIN_BATCH, MAIN_N, MAIN_M,
         np.random.default_rng(3).integers(0, 3 * MAIN_M, MAIN_BATCH)),
        ("mixed/wrapped", 5, 24, 6, (0, 6, 9, 2, 7)),
        ("m=1", 3, 40, 1, (0, 1, 3)),
        ("m=33", 4, 33, 33, (0, 5, 33, 70)),
        ("ragged walk", MAIN_BATCH + 1, MAIN_N, MAIN_M,
         np.random.default_rng(4).integers(0, 3 * MAIN_M, MAIN_BATCH + 1)),
        ("n=101", 300, 101, MAIN_M,
         np.random.default_rng(5).integers(0, 3 * MAIN_M, 300)),
        ("odd offset", 300, MAIN_N, MAIN_M,
         np.random.default_rng(6).integers(0, 3 * MAIN_M, 300)),
        ("n=1000", 300, 1000, MAIN_M,
         np.random.default_rng(7).integers(0, 3 * MAIN_M, 300)),
        # the solver families' shapes (phases 15-17)
        ("stochastic", 1, STOCH_DIM, STOCH_M, (STOCH_M + 3,)),
        ("owlqn", OWL_BATCH, OWL_N, 6,
         np.random.default_rng(8).integers(0, 18, OWL_BATCH)),
        ("owlqn pair", OWL_BATCH, 2 * OWL_N, 6,
         np.random.default_rng(9).integers(0, 18, OWL_BATCH)),
    ]

    def compare():
        worst = []
        for label, batch, n, m, ncorrs in cases:
            h64 = random_history(torch, history, batch, n, m, ncorrs,
                                 seed=m, device=dev)
            v64 = torch.as_tensor(
                np.random.default_rng(1).standard_normal((batch, n)),
                device=dev)
            for dtype in (torch.float32, torch.float64):
                h, v = cast(h64, dtype), v64.to(dtype)
                if label == "odd offset":
                    h = h._replace(s=at_odd_offset(torch, h.s))
                    v = at_odd_offset(torch, v)
                for mode in ("sweeps", "rinv"):
                    plan = fused.plan_for(*kernel_args(h, v), mode)
                    got = fused.two_loop(*kernel_args(h, v), -1.0, mode)
                    want = fused.two_loop_plain(*kernel_args(h, v), -1.0,
                                                mode)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    scale = want.abs().max().item()
                    ok = err <= tolerances[dtype] * scale
                    paths = sorted(set(plan.copy.values()) - {"none"})
                    if not plan.staged:
                        paths.append("rows in memory")
                    _log(f"   {label:14s} B={batch:5d} m={m:2d} n={n:3d} "
                         f"{str(dtype)[6:]:8s} {mode:6s} max_abs_err="
                         f"{err:.3e} (scale {scale:.3e}) "
                         f"{'ok' if ok else 'TOO LARGE'}; copies "
                         f"{'+'.join(paths)}, {plan.warps} warps x "
                         f"{plan.stages} stages, grid {plan.grid}")
                    if not ok:
                        worst.append((label, str(dtype), mode, err))
                    if label == "main shape" and dtype == torch.float32 \
                            and mode == "rinv":
                        smoke.kernel_rows["max_abs_err"] = err
        if worst:
            raise AssertionError(f"kernel disagrees with plain: {worst}")

    smoke.phase("kernel vs plain version", compare)

    # 3 ---------------------------------------------------------------
    def parity():
        rng = np.random.default_rng(11)
        n, batch = 20, 64
        d = torch.as_tensor(rng.uniform(0.5, 10.0, n))
        b = torch.as_tensor(rng.uniform(-1.0, 1.0, n))
        c = torch.as_tensor(rng.uniform(0.1, 2.0, n))
        t = torch.as_tensor(rng.uniform(-1.0, 1.0, n))
        x0 = rng.uniform(-2.0, 2.0, (batch, n))
        p = lt.LBFGSParams(epsilon=1e-8, max_iterations=500)

        def problems(device):
            dd, bb, cc, tt = (a.to(device) for a in (d, b, c, t))

            def quad_fg(x):
                return 0.5 * torch.dot(x, dd * x) - torch.dot(bb, x), \
                    dd * x - bb

            def quartic_fg(x):
                e = x - tt
                e2 = e * e
                return torch.sum(cc * e2 * e2 + 0.5 * dd * e2), \
                    4.0 * cc * e2 * e + dd * e
            return {"quadratic": quad_fg, "quartic": quartic_fg}

        gpu, cpu = problems(dev), problems("cpu")
        for name in gpu:
            for direction in ("sweeps", "rinv"):
                rg = lt.minimize_batched(fun_and_grad=gpu[name],
                                         x0s=torch.as_tensor(x0), params=p,
                                         direction=direction, device=dev)
                rc = lt.minimize_batched(fun_and_grad=cpu[name],
                                         x0s=torch.as_tensor(x0), params=p,
                                         direction=direction, device="cpu")
                same = (rg.niter.cpu() == rc.niter).all().item() and \
                    (rg.status.cpu() == rc.status).all().item()
                _log(f"   f64 {name:9s} {direction:6s} B={batch} n={n}: "
                     f"iterations {int(rg.niter.min())}.."
                     f"{int(rg.niter.max())}, card == cpu: {same}")
                if not same:
                    raise AssertionError(f"{name}/{direction}: iteration "
                                         f"counts differ from the CPU run")

    smoke.phase("f64 quadratic/quartic batches: card vs CPU", parity)

    # 4 ---------------------------------------------------------------
    x0s = torch.as_tensor(np.random.default_rng(0).uniform(
        -2.0, 2.0, (MAIN_BATCH, MAIN_N)), dtype=torch.float32, device=dev)
    params = lt.LBFGSParams(epsilon=1e-5, max_iterations=MAIN_ITERS,
                            m=MAIN_M, max_linesearch=2)
    options = dict(direction="rinv", on_ls_fail="restart", device=dev)

    def main_phase():
        def solve():
            return lt.minimize_batched(objectives.rosenbrock, x0s, params,
                                       **options)

        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        _log(f"   warm-up run {time.perf_counter() - t0:.2f} s")
        times = []
        for rep in range(3):
            fused.two_loop.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches = fused.two_loop.launches
            executed = int(res.niter.max())    # no instance exits at init
            _log(f"   run {rep}: {times[-1]:.3f} s, "
                 f"{MAIN_BATCH / times[-1]:.1f} solves/s, kernel launches "
                 f"{launches}, batched iterations {executed}")
            if launches == 0 or launches != executed:
                raise AssertionError(f"launches {launches} != batched "
                                     f"iterations {executed}")
        x = res.x.double()
        if not torch.isfinite(x).all():
            raise AssertionError("non-finite x in the main phase")
        ok_status = torch.zeros_like(res.status, dtype=torch.bool)
        for s in lt.SUCCESS_STATUSES:
            ok_status |= res.status == int(s)
        if not ok_status.all():
            raise AssertionError(
                f"statuses outside SUCCESS_STATUSES: "
                f"{sorted(set(res.status[~ok_status].tolist()))}")
        err = (x - 1.0).abs().max(dim=1).values
        med = float(np.median(times))
        main_state.update(res=res, launches=launches)
        _log(f"   main phase B={MAIN_BATCH} n={MAIN_N} m={MAIN_M} f32 rinv "
             f"mls=2 restart: median {med:.3f} s = "
             f"{MAIN_BATCH / med:.1f} solves/s; iterations "
             f"{int(res.niter.min())}..{int(res.niter.max())}; "
             f"frac_within_1e-3={(err <= 1e-3).double().mean().item():.4f} "
             f"frac_within_1e-4={(err <= 1e-4).double().mean().item():.4f}")

    smoke.phase("main phase at full width", main_phase)

    # 5 ---------------------------------------------------------------
    def timing():
        res = main_state["res"]
        h32 = res.history
        v32 = res.grad.contiguous()
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

        def median_ms(fn):
            return median_ms_of(torch, fn, flush)

        src = torch.empty(COPY_PROBE_BYTES, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        copy_ms = median_ms(lambda: dst.copy_(src))
        _log(f"   achievable bandwidth: a {COPY_PROBE_BYTES >> 20} MB device "
             f"copy takes {copy_ms:.4f} ms = "
             f"{2 * COPY_PROBE_BYTES / copy_ms / 1e9:.3f} TB/s read+write "
             f"({2 * COPY_PROBE_BYTES / copy_ms * 1e3 / HBM_BYTES_PER_S:.1%}"
             f" of {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        main_state["bandwidth"] = 2 * COPY_PROBE_BYTES / copy_ms * 1e3
        read_ms = median_ms(lambda: src.view(torch.float32).sum())
        _log(f"   achievable read bandwidth: summing {COPY_PROBE_BYTES >> 20}"
             f" MB takes {read_ms:.4f} ms = "
             f"{COPY_PROBE_BYTES / read_ms / 1e9:.3f} TB/s")
        del src, dst

        # The real state: the kernel must be no less accurate than the
        # plain version against an f64 evaluation of the same inputs.
        ref = fused.two_loop_plain(*kernel_args(cast(h32, torch.float64),
                                                v32.double()), -1.0, "rinv")
        k32 = fused.two_loop(*kernel_args(h32, v32), -1.0, "rinv")
        p32 = fused.two_loop_plain(*kernel_args(h32, v32), -1.0, "rinv")
        ek = (k32.double() - ref).abs().max().item()
        ep = (p32.double() - ref).abs().max().item()
        _log(f"   main-phase state, f32 rinv: |kernel - f64| {ek:.3e}, "
             f"|plain - f64| {ep:.3e}")
        if not ek <= 4.0 * ep + 1e-6 * ref.abs().max().item():
            raise AssertionError("kernel less accurate than plain on the "
                                 "main-phase state")
        rows = smoke.kernel_rows
        for dtype in (torch.float32, torch.float64):
            h = h32 if dtype == torch.float32 else cast(h32, dtype)
            v = v32.to(dtype)
            args = kernel_args(h, v)
            name = str(dtype)[6:]
            for mode in ("rinv", "sweeps"):
                def new():
                    return fused.two_loop(*args, -1.0, mode)

                def simple():
                    return fused.two_loop_simple(*args, -1.0, mode)
                turns = [median_ms(f) for f in (simple, new, new, simple)]
                k_ms = (turns[1] + turns[2]) / 2
                s_ms = (turns[0] + turns[3]) / 2
                p_ms = median_ms(lambda: fused.two_loop_plain(*args, -1.0,
                                                              mode))
                nbytes = args_bytes(args, mode)
                flops = two_loop_flops(MAIN_BATCH, MAIN_M, MAIN_N, mode)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS[name] * 1e3
                bound = max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else "operations"
                _log(f"   two_loop {mode:6s} B={MAIN_BATCH} m={MAIN_M} "
                     f"n={MAIN_N} {name}: kernel {k_ms:.4f} ms "
                     f"({bound / k_ms:.1%} of bound), simple {s_ms:.4f} ms "
                     f"({bound / s_ms:.1%}), turns simple/new/new/simple "
                     f"{' '.join(f'{t:.4f}' for t in turns)}; plain "
                     f"{p_ms:.4f} ms; bound {bound:.4f} ms by {by} "
                     f"({nbytes / 1e6:.1f} MB; {flops / 1e6:.1f} MFLOP = "
                     f"{t_ops:.4f} ms)")
                if name == "float32" and mode == "rinv":
                    rows.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                                bound_by=by, simple_ms=s_ms)
                elif name == "float32":
                    rows.update(sweeps_ms=k_ms)
                elif mode == "rinv":
                    rows.update(ms_f64=k_ms, bound_ms_f64=bound)

        # The df64 phases' shape: pair space (n=200), f32, rinv, the whole
        # batch (polish) and 3/16 of it (deep stage).
        for label, batch in (("polish", MAIN_BATCH), ("deep", DEEP_BATCH)):
            h, v = pair_state(torch, lbatch, h32, v32, batch, seed=batch)
            args = kernel_args(h, v)
            row = time_vs_bound(torch, fused, args, "rinv", flush)
            plan = fused.plan_for(*args, "rinv")
            _log(f"   two_loop rinv B={batch} m={MAIN_M} n={v.shape[1]} "
                 f"float32 ({label} shape): kernel {row['ms']:.4f} ms "
                 f"({row['bound_ms'] / row['ms']:.1%} of bound); plain "
                 f"{row['plain_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms "
                 f"by {row['bound_by']} ({row['mbytes']:.1f} MB; operations "
                 f"{row['ops_ms']:.4f} ms); plan {plan.warps} warps x "
                 f"{plan.stages} stages, grid {plan.grid}, staged "
                 f"{plan.staged}")
            for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
                rows[f"{label}_shape_{key}"] = row[key]

    if "res" in main_state:
        smoke.phase("kernel timing at the main path's shape", timing)
    else:
        smoke.failures.append("kernel timing (no main-phase state)")

    # 6 ---------------------------------------------------------------
    def profile():
        from torch.profiler import ProfilerActivity
        calls = [0]

        def counted_rosenbrock(x):
            calls[0] += 1
            return objectives.rosenbrock(x)

        s = lt.solver(counted_rosenbrock, params, **options)
        state = s.init(x0s)
        for _ in range(PROFILE_WARMUP):
            state = s.step(state)
        torch.cuda.synchronize()
        nfev0, calls0 = state.nfev.clone(), calls[0]
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_ITERS):
                state = s.step(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        it = PROFILE_ITERS
        events = prof.key_averages()
        ops = sum(e.count for e in events if e.key.startswith("aten::"))
        evals = (state.nfev - nfev0).double() / it
        batched = (calls[0] - calls0) / it
        kernels = [e for e in events if e.device_type.name == "CUDA"]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        _log(f"   iterations {PROFILE_WARMUP + 1}-{PROFILE_WARMUP + it}, "
             f"profiler on: host {wall / it * 1e3:.3f} ms/iteration, "
             f"{ops / it:.1f} aten ops and "
             f"{sum(e.count for e in kernels) / it:.1f} kernel launches per "
             f"iteration; device busy {busy_ms / it:.3f} ms/iteration, "
             f"idle share {1 - busy_ms / 1e3 / wall:.3f}; objective "
             f"evaluations per instance per iteration mean "
             f"{evals.mean().item():.3f} max {evals.max().item():.3f}; "
             f"batched evaluations (line-search trials) per iteration "
             f"{batched:.2f}")
        _log("   top kernels, ms and launches per iteration:")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            _log(f"   {e.self_device_time_total / it / 1e3:8.4f} "
                 f"{e.count / it:6.1f}x  {e.key[:80]}")
        _log("   top host operators, ms and calls per iteration:")
        cpu_ops = [e for e in events if e.key.startswith("aten::")]
        for e in sorted(cpu_ops, key=lambda e: -e.self_cpu_time_total)[:8]:
            _log(f"   {e.self_cpu_time_total / it / 1e3:8.4f} "
                 f"{e.count / it:6.1f}x  {e.key}")

    smoke.phase("where the main phase's time goes", profile)

    # 7 ---------------------------------------------------------------
    def pair_arithmetic():
        import fractions

        rng = np.random.default_rng(21)
        size = 1 << 20

        def on_card(values, dtype=torch.float32):
            return torch.as_tensor(values, dtype=dtype, device=dev)

        a = on_card(rng.uniform(-10, 10, size))
        b = on_card(rng.uniform(-1e-3, 1e-3, size))
        c = on_card(rng.uniform(-30, 30, size))
        s, e = dfl.two_sum(a, b)
        bad_sum = int((s.double() + e.double() !=
                       a.double() + b.double()).sum())
        p, e = dfl.two_prod(a, c)
        bad_prod = int((p.double() + e.double() !=
                        a.double() * c.double()).sum())
        _log(f"   f32 two_sum / two_prod on the card, {size} pairs each, "
             f"against f64: {bad_sum} / {bad_prod} inexact")

        a64 = on_card(rng.uniform(-10, 10, 4096), torch.float64)
        b64 = on_card(rng.uniform(-10, 10, 4096), torch.float64)
        c64 = b64 * 1e-9
        p, e = dfl.two_prod(a64, b64)
        s, f = dfl.two_sum(a64, c64)
        F = fractions.Fraction
        bad64 = sum(
            F(pi) + F(ei) != F(ai) * F(bi) or F(si) + F(fi) != F(ai) + F(ci)
            for ai, bi, ci, pi, ei, si, fi in zip(
                *(t.cpu().tolist() for t in (a64, b64, c64, p, e, s, f))))
        _log(f"   f64 two_sum / two_prod on the card, 4096 pairs, against "
             f"rationals: {bad64} inexact")

        # (1 + x) - 1: a compiler that folds the constant loses x's lo word
        hi = on_card(np.linspace(-0.34, 0.34, 4096))
        x = dfl.DF(hi, hi * 2.0 ** -30)
        one = dfl.lift(torch.ones_like(hi))
        lifted = dfl.add(one, x)
        back = dfl.sub(lifted, one)
        err_back = ((back.hi.double() + back.lo.double()) -
                    (x.hi.double() + x.lo.double())).abs().max().item()
        _log(f"   (1 + x) - 1 in f32 pairs: lo words kept "
             f"{bool((lifted.lo != 0).any())}, |result - x| {err_back:.3e}")

        # the same calls on the card and on the CPU, bit for bit
        def bits(t):
            return t.contiguous().view(torch.int32 if t.dtype ==
                                       torch.float32 else torch.int64).cpu()

        def same(got, want):
            return all(torch.equal(bits(g), bits(w))
                       for g, w in zip(got, want))

        def random_pair(seed, shape, dtype, positive=False):
            r = np.random.default_rng(seed)
            h = r.uniform(0.0 if positive else -5.0, 5.0, shape)
            h = torch.as_tensor(h, dtype=dtype)
            lo = h * torch.as_tensor(r.uniform(-0.5, 0.5, shape),
                                     dtype=dtype) * torch.finfo(dtype).eps
            return dfl.DF(h, lo)

        def to_dev(d):
            return dfl.DF(d.hi.to(dev), d.lo.to(dev))

        mismatched = []
        for dtype in (torch.float32, torch.float64):
            xa = random_pair(1, (64, 1000), dtype)
            xb = random_pair(2, (64, 1000), dtype)
            xp = random_pair(3, (64, 1000), dtype, positive=True)
            cases = {
                "add": lambda u, v, w: dfl.add(u, v),
                "sub": lambda u, v, w: dfl.sub(u, v),
                "mul": lambda u, v, w: dfl.mul(u, v),
                "div": lambda u, v, w: dfl.div(u, v),
                "sqrt": lambda u, v, w: dfl.sqrt(w),
                "df_sum": lambda u, v, w: dfl.df_sum(u, (1,)),
                "df_dot": lambda u, v, w: dfl.df_dot(u, v),
                "exp": lambda u, v, w: dfl.exp(dfl.DF(u.hi * 6.0,
                                                      u.lo * 6.0)),
            }
            for name, fn in cases.items():
                got = fn(to_dev(xa), to_dev(xb), to_dev(xp))
                if not same(got, fn(xa, xb, xp)):
                    mismatched.append(f"{name} {str(dtype)[6:]}")
        fg2 = dfl.df64_pair_fun_and_grad(objectives.rosenbrock)
        r = np.random.default_rng(4)
        hi2 = r.uniform(-2, 2, (256, MAIN_N)).astype(np.float32)
        lo2 = (hi2 * r.uniform(-0.5, 0.5, hi2.shape) * 2.0 ** -24).astype(
            np.float32)
        x2 = torch.as_tensor(np.concatenate([hi2, lo2], axis=1))
        dfl.FALLBACKS.clear()
        if not same(fg2(x2.to(dev)), fg2(x2)):
            mismatched.append("the pair objective of rosenbrock")
        fallbacks = sum(dfl.FALLBACKS.values())
        _log(f"   card against CPU, bit for bit (f32 and f64 pairs): add, "
             f"sub, mul, div, sqrt, df_sum, df_dot, exp and the pair "
             f"objective of rosenbrock: "
             f"{'all equal' if not mismatched else 'DIFFER: ' + ', '.join(mismatched)}"
             f"; interpreter fallbacks {fallbacks}")
        if bad_sum or bad_prod or bad64 or mismatched or fallbacks or \
                not err_back < 1e-13:
            raise AssertionError("pair arithmetic is not exact on the card")

    smoke.phase("pair (df64) arithmetic on the card", pair_arithmetic)

    # 8 ---------------------------------------------------------------
    def pair_kernel():
        res = main_state["res"]
        worst = []
        for label, batch in (("polish", MAIN_BATCH), ("deep", DEEP_BATCH)):
            h, v = pair_state(torch, lbatch, res.history, res.grad, batch,
                              seed=batch)
            zero_lo = bool((h.s[:, :, MAIN_N:] == 0).all()) and \
                bool((h.y[:, :, MAIN_N:] == 0).all())
            for mode in ("rinv", "sweeps"):
                got = fused.two_loop(*kernel_args(h, v), -1.0, mode)
                want = fused.two_loop_plain(*kernel_args(h, v), -1.0, mode)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                ok = err <= tolerances[torch.float32] * scale
                _log(f"   {label} shape B={batch:5d} m={MAIN_M} "
                     f"n={v.shape[1]} float32 {mode:6s} (main-phase state "
                     f"lifted, lo halves zero: {zero_lo}): max_abs_err="
                     f"{err:.3e} (scale {scale:.3e}) "
                     f"{'ok' if ok else 'TOO LARGE'}")
                if not (ok and zero_lo):
                    worst.append((label, mode, err))
                if label == "polish" and mode == "rinv":
                    smoke.kernel_rows["pair_max_abs_err"] = err
        if worst:
            raise AssertionError(f"kernel disagrees with plain: {worst}")

    if "res" in main_state:
        smoke.phase("kernel vs plain version at the pair shapes", pair_kernel)
    else:
        smoke.failures.append("pair-shape kernel check (no main-phase state)")

    # 9 ---------------------------------------------------------------
    pparams = lt.LBFGSParams(epsilon=1e-5, max_iterations=MAIN_ITERS,
                             m=MAIN_M)
    recipe = dict(polish_iters=POLISH_ITERS, polish_params=pparams,
                  polish_warm=True, polish_line_search="morethuente",
                  deep_frac=DEEP_FRAC, deep_iters=DEEP_ITERS, **options)
    full_state = {}

    def full_path():
        # Phase boundaries, read from the two batch functions the path
        # calls between its phases (a sync on each side of the polish),
        # and the batched pair evaluations (lockstep More-Thuente trials,
        # the start point's and the exhausted searches' re-evaluations).
        marks = {"polish": []}
        polish_solve, merge = lbatch.polish_solve, lbatch._merge_polished
        interpret, calls = dfl._interpret, [0]

        def counted(*args):
            calls[0] += 1
            return interpret(*args)

        def timed_polish(*args, **kwargs):
            torch.cuda.synchronize()
            t0, calls[0] = time.perf_counter(), 0
            out = polish_solve(*args, **kwargs)
            torch.cuda.synchronize()
            marks["polish"].append((t0, time.perf_counter(), out, calls[0]))
            return out

        def kept_merge(res, pol):
            marks["main"] = res
            return merge(res, pol)

        def solve():
            return lt.minimize_batched(objectives.rosenbrock, x0s, params,
                                       **recipe)

        lbatch.polish_solve, lbatch._merge_polished = timed_polish, kept_merge
        dfl._interpret = counted
        try:
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            _log(f"   warm-up run {time.perf_counter() - t0:.2f} s")
            runs = []
            for rep in range(FULL_PATH_RUNS):
                marks["polish"].clear()
                dfl.FALLBACKS.clear()
                fused.two_loop.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solve()
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                launches = fused.two_loop.launches
                fallbacks = sum(dfl.FALLBACKS.values())
                (t1, t2, pol, pcalls), (d0, d1, deep, dcalls) = \
                    marks["polish"]
                main = marks["main"]
                iters = [int(r.niter.max()) for r in (main, pol, deep)]
                expected = iters[0] + 1 + iters[1] + iters[2]
                secs = [t1 - t0, t2 - t1, t3 - t2, t3 - t0]
                fracs = " | ".join(
                    f"{label} {frac_within(r.x, 1e-3):.4f} "
                    f"{frac_within(r.x, 1e-4):.4f}" for label, r in
                    (("main", main), ("polish", pol), ("deep", res)))
                _log(f"   run {rep}: main {secs[0]:.3f} s, polish "
                     f"{secs[1]:.3f} s, deep {secs[2]:.3f} s (its solve "
                     f"{d1 - d0:.3f} s), total {secs[3]:.3f} s = "
                     f"{MAIN_BATCH / secs[3]:.1f} solves/s; iterations main "
                     f"{iters[0]}, polish {iters[1]}, deep {iters[2]}; "
                     f"batched pair evaluations per iteration polish "
                     f"{(pcalls - 1) / iters[1]:.2f}, deep "
                     f"{(dcalls - 1) / iters[2]:.2f}; "
                     f"kernel launches {launches}, expected {iters[0]} + "
                     f"(1 + {iters[1]}) + {iters[2]} = {expected}; "
                     f"interpreter fallbacks {fallbacks}; frac_within "
                     f"1e-3 1e-4 after each phase: {fracs}")
                if launches != expected:
                    raise AssertionError(f"launches {launches} != expected "
                                         f"{expected}")
                if fallbacks:
                    raise AssertionError(f"df64 fallbacks: "
                                         f"{dict(dfl.FALLBACKS)}")
                runs.append(secs)
        finally:
            lbatch.polish_solve, lbatch._merge_polished = polish_solve, merge
            dfl._interpret = interpret
        full_state.update(launches=launches, main=main, result=res,
                          polished=merge(main, pol))
        med = np.median(np.asarray(runs), axis=0)
        _log(f"   full path B={MAIN_BATCH} n={MAIN_N} m={MAIN_M} (f32 main "
             f"rinv mls=2 restart; {POLISH_ITERS} warm df64 polish "
             f"iterations; deep stage {DEEP_ITERS} iterations on "
             f"{DEEP_BATCH} instances; More-Thuente): median seconds main "
             f"{med[0]:.3f}, polish {med[1]:.3f}, deep {med[2]:.3f}, total "
             f"{med[3]:.3f} = {MAIN_BATCH / med[3]:.1f} solves/s")
        x = res.x.double()
        if not torch.isfinite(x).all():
            raise AssertionError("non-finite x after the full path")
        err = (x - 1.0).abs().max(dim=1).values
        miss = torch.nonzero(err > 1e-4).flatten().tolist()
        _log(f"   every-run criterion max|x - 1| <= 1e-4: "
             f"frac_within_1e-4={(err <= 1e-4).double().mean().item():.4f}, "
             f"worst {err.max().item():.3e}; instances beyond: "
             f"{[(i, round(err[i].item(), 8)) for i in miss] or 'none'}")
        if miss:
            raise AssertionError(f"{len(miss)} instances beyond 1e-4")

    if "res" in main_state:
        smoke.phase("the full three-phase main path at full width",
                    full_path)
    else:
        smoke.failures.append("full path (the main phase failed)")

    # 10 --------------------------------------------------------------
    def profile_df64():
        from torch.profiler import ProfilerActivity
        main, polished = full_state["main"], full_state["polished"]
        calls = [0]
        interpret = dfl._interpret

        def counted(*args):
            calls[0] += 1
            return interpret(*args)

        def polish():
            return lbatch.polish_solve(
                objectives.rosenbrock, main.x, pparams, POLISH_ITERS,
                line_search="morethuente", direction="rinv",
                warm_history=main.history, device=dev)

        def deep():
            # its first iterations: the profiler's own cost grows with
            # every event, and a deep iteration runs ~30,000 eager ops
            return lbatch.deep_polish(
                objectives.rosenbrock, polished, pparams, DEEP_BATCH,
                PROFILE_DEEP_ITERS, line_search="morethuente",
                direction="rinv")

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        dfl._interpret = counted
        try:
            for label, run in (("polish", polish), ("deep", deep)):
                calls[0] = 0
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    out = run()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                if label == "polish":
                    niter, nfev = out.niter, out.nfev - 1
                else:
                    picked = out.niter != polished.niter
                    niter = (out.niter - polished.niter)[picked]
                    nfev = (out.nfev - polished.nfev)[picked] - 1
                steps = int(niter.max())
                events = prof.key_averages()
                ops = sum(e.count for e in events
                          if e.key.startswith("aten::"))
                kernels = [e for e in events
                           if e.device_type.name == "CUDA"]
                busy_ms = sum(e.self_device_time_total
                              for e in kernels) / 1e3
                _log(f"   {label}: {steps} iterations of {niter.numel()} "
                     f"instances, profiler on: {wall:.3f} s, host "
                     f"{wall / steps * 1e3:.3f} ms/iteration, "
                     f"{ops / steps:.1f} aten ops and "
                     f"{sum(e.count for e in kernels) / steps:.1f} kernel "
                     f"launches per iteration; device busy "
                     f"{busy_ms / steps:.3f} ms/iteration, idle share "
                     f"{1 - busy_ms / 1e3 / wall:.3f}; batched pair "
                     f"evaluations (lockstep More-Thuente trials) per "
                     f"iteration {(calls[0] - 1) / steps:.3f}; evaluations "
                     f"per instance per iteration mean "
                     f"{nfev.sum().item() / niter.sum().item():.3f}")
                for e in sorted(kernels,
                                key=lambda e: -e.self_device_time_total)[:5]:
                    _log(f"   {e.self_device_time_total / steps / 1e3:8.4f}"
                         f" ms {e.count / steps:7.1f}x  {e.key[:80]}")
        finally:
            dfl._interpret = interpret

    if "polished" in full_state:
        smoke.phase("where the df64 phases' time goes", profile_df64)

    # 11 --------------------------------------------------------------
    # The box-constrained path (bench.py:139-175): the bench's box recipe
    # as it stands, and the same with coordinate 2 unbounded (as in
    # example-rosenbrock-box.cpp), whose polish has a free coordinate to
    # refine and so takes L-BFGS steps that launch the two-loop kernel.
    box_state = {}
    bx0s = torch.as_tensor(np.random.default_rng(0).uniform(
        2.0, 4.0, (BOX_BATCH, BOX_N)), dtype=torch.float32, device=dev)
    bparams = lt.LBFGSBParams(epsilon=1e-6, max_iterations=BOX_ITERS)
    xstar_box = torch.as_tensor(np.tile([2.0, 4.0], BOX_N // 2), device=dev)

    def box_path():
        from lbfgspp_tpu_torch import lbfgs as tlbfgs
        from lbfgspp_tpu_torch.ops import subspace

        evals = [0]

        def counted_rosenbrock(x):
            evals[0] += 1
            return objectives.rosenbrock(x)

        marks = {}
        polish_b, build = lbatch.polish_solve_b, tlbfgs._build_solver

        def timed_polish(*args, **kwargs):
            torch.cuda.synchronize()
            marks["polish_start"] = (time.perf_counter(), evals[0])
            marks["box"] = kwargs["prior"]
            out = polish_b(*args, **kwargs)
            torch.cuda.synchronize()
            marks["polish_end"] = time.perf_counter()
            return out

        def counting_build(*args, **kwargs):
            # the polish's solver, its batched steps counted (run as
            # lbfgs.solver's run does)
            s = build(*args, **kwargs)

            def step(c):
                marks["polish_steps"] += 1
                return s.step(c)

            def run(c):
                while not bool(c.done.all()):
                    c = step(c)
                return c
            return s._replace(step=step, run=run)

        def solve(lb, ub):
            return lt.minimize_b_batched(
                counted_rosenbrock, bx0s, lb, ub, bparams, gcp="prefix",
                polish_iters=BOX_POLISH_ITERS, device=dev)

        variants = {
            "bench": (torch.full((BOX_N,), 2.0, device=dev),
                      torch.full((BOX_N,), 4.0, device=dev)),
            "free x[2]": (torch.full((BOX_N,), 2.0, device=dev).index_fill(
                0, torch.tensor([2], device=dev), -float("inf")),
                torch.full((BOX_N,), 4.0, device=dev).index_fill(
                0, torch.tensor([2], device=dev), float("inf")))}
        lbatch.polish_solve_b = timed_polish
        tlbfgs._build_solver = counting_build
        try:
            for label, (lb, ub) in variants.items():
                solve(lb, ub)
                torch.cuda.synchronize()
                runs = []
                for rep in range(BOX_RUNS):
                    fused.two_loop.launches = 0
                    subspace.COUNTS.clear()
                    marks["polish_steps"] = 0
                    evals[0] = 0
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = solve(lb, ub)
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    launches = fused.two_loop.launches
                    t1, box_evals = marks["polish_start"]
                    box = marks["box"]
                    iters = int(box.niter.max())
                    steps = marks["polish_steps"]
                    counts = dict(subspace.COUNTS)
                    lock = counts.get("lockstep", 0)
                    calls = max(counts.get("calls", 0), 1)
                    inst_iters = float(counts.get("instance_iterations", 0))
                    runs.append((t1 - t0, t2 - t1, t2 - t0))
                    err0 = (box.x.double() - xstar_box).abs().max(1).values
                    err = (res.x.double() - xstar_box).abs().max(1).values
                    _log(f"   {label} run {rep}: box solve {t1 - t0:.3f} s, "
                         f"polish {t2 - t1:.3f} s, total {t2 - t0:.3f} s = "
                         f"{BOX_BATCH / (t2 - t0):.1f} box solves/s; box "
                         f"iterations {iters}; batched evaluations per "
                         f"iteration {(box_evals - 1) / iters:.2f}; BOXCQP "
                         f"lockstep iterations per call {lock / calls:.2f} "
                         f"(instances' mean {inst_iters / max(counts.get('instances', 1), 1):.3f}), "
                         f"exit-test syncs {counts.get('syncs', 0)} in "
                         f"{calls} calls; polish L-BFGS steps {steps}; "
                         f"two-loop launches {launches} (expected: one per "
                         f"polish step, {steps}); frac_within_1e-4 before "
                         f"the polish {(err0 <= 1e-4).double().mean().item():.4f}"
                         f", after {(err <= 1e-4).double().mean().item():.4f}")
                    if launches != steps:
                        raise AssertionError(f"{label}: launches {launches} "
                                             f"!= polish steps {steps}")
                    if not torch.isfinite(res.x).all():
                        raise AssertionError(f"{label}: non-finite x")
                med = np.median(np.asarray(runs), axis=0)
                box_state[label] = dict(res=res, box=box, launches=launches,
                                        steps=steps, seconds=med)
                _log(f"   {label}: B={BOX_BATCH} n={BOX_N} f32 prefix GCP, "
                     f"{BOX_POLISH_ITERS} polish iterations: median seconds "
                     f"box {med[0]:.3f}, polish {med[1]:.3f}, total "
                     f"{med[2]:.3f} = {BOX_BATCH / med[2]:.1f} box solves/s")
        finally:
            lbatch.polish_solve_b = polish_b
            tlbfgs._build_solver = build
        res = box_state["bench"]["res"]
        err = (res.x.double() - xstar_box).abs().max(1).values
        fx_ok = bool((res.fx.double() <= 5.0 + 1e-3).all())
        miss = torch.nonzero(err > 1e-4).flatten().tolist()
        _log(f"   bench box recipe: frac_within_1e-4 of tile([2, 4]) = "
             f"{(err <= 1e-4).double().mean().item():.4f}, worst "
             f"{err.max().item():.3e}; every fx <= 5 + 1e-3: {fx_ok}; "
             f"instances beyond: {miss[:20] or 'none'}")
        if miss or not fx_ok:
            raise AssertionError(f"box recipe: {len(miss)} instances beyond "
                                 f"1e-4, fx gate {fx_ok}")
        free = box_state["free x[2]"]
        pinned = torch.ones(BOX_N, dtype=torch.bool, device=dev)
        pinned[2:4] = False
        perr = (free["res"].x.double() - xstar_box)[:, pinned].abs().max()
        _log(f"   free x[2]: pinned pairs within {perr.item():.3e} of (2, 4);"
             f" polish steps {free['steps']}")
        if free["steps"] < 1 or perr.item() > 1e-4:
            raise AssertionError("free x[2]: the polish took no step, or a "
                                 "pinned pair is off its bounds")

    smoke.phase("the box-constrained path at full width", box_path)

    # 12 --------------------------------------------------------------
    def box_kernel():
        """The kernel against its plain version on the box polish's own
        calls (B=4096, m=6, n=20 pair space, sweeps), f32 and f64, and
        its time there."""
        from lbfgspp_tpu_torch import lbfgs as tlbfgs
        lb, ub = (torch.full((BOX_N,), v, device=dev) for v in (2.0, 4.0))
        lb[2], ub[2] = -float("inf"), float("inf")
        calls = capture_calls(lambda: lt.minimize_b_batched(
            objectives.rosenbrock, bx0s, lb, ub, bparams, gcp="prefix",
            polish_iters=BOX_POLISH_ITERS, device=dev))
        worst = []
        for dtype in (torch.float32, torch.float64):
            for args in calls:
                args = cast_args(args, dtype)
                got = fused.two_loop(*args, -1.0, "sweeps")
                want = fused.two_loop_plain(*args, -1.0, "sweeps")
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                ok = err <= tolerances[dtype] * scale
                if not ok:
                    worst.append((str(dtype), err, scale))
            _log(f"   box shape B={args[0].shape[0]} m={args[0].shape[1]} "
                 f"n={args[0].shape[2]} {str(dtype)[6:]} sweeps, "
                 f"{len(calls)} calls of the polish: last max_abs_err "
                 f"{err:.3e} (scale {scale:.3e}) "
                 f"{'ok' if not worst else 'TOO LARGE'}")
            if dtype == torch.float32:
                smoke.kernel_rows["box_max_abs_err"] = err
        if worst:
            raise AssertionError(f"kernel disagrees with plain: {worst}")
        args = calls[0]
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
        row = time_vs_bound(torch, fused, args, "sweeps", flush)
        batch, m, n2 = args[0].shape
        share = row["bound_ms"] / row["ms"]
        _log(f"   two_loop sweeps B={batch} m={m} n={n2} float32 (box "
             f"shape): kernel {row['ms']:.4f} ms ({share:.1%} of bound); "
             f"plain {row['plain_ms']:.4f} ms; "
             f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
             f"({row['mbytes']:.2f} MB; operations {row['ops_ms']:.5f} ms)")
        for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
            smoke.kernel_rows[f"box_shape_{key}"] = row[key]

    if "free x[2]" in box_state:
        smoke.phase("kernel vs plain version at the box polish's shape",
                    box_kernel)
    else:
        smoke.failures.append("box-shape kernel check (the box path failed)")

    # 13 --------------------------------------------------------------
    def profile_box():
        from torch.profiler import ProfilerActivity
        from lbfgspp_tpu_torch.ops import subspace
        lb, ub = (torch.full((BOX_N,), v, device=dev) for v in (2.0, 4.0))
        s = lt.solver_b(objectives.rosenbrock, lb, ub, bparams, gcp="prefix",
                        device=dev)
        state = s.init(bx0s)
        torch.cuda.synchronize()
        subspace.COUNTS.clear()
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_BOX_ITERS):
                state = s.step(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        it = PROFILE_BOX_ITERS
        events = prof.key_averages()
        ops = sum(e.count for e in events if e.key.startswith("aten::"))
        kernels = [e for e in events if e.device_type.name == "CUDA"]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        syncs = sum(e.count for e in events
                    if e.key == "aten::_local_scalar_dense")
        _log(f"   box iterations 1-{it} at B={BOX_BATCH}, profiler on: host "
             f"{wall / it * 1e3:.3f} ms/iteration, {ops / it:.1f} aten ops "
             f"and {sum(e.count for e in kernels) / it:.1f} kernel launches "
             f"per iteration, {syncs / it:.1f} device-to-host reads per "
             f"iteration (BOXCQP exit tests "
             f"{subspace.COUNTS.get('syncs', 0) / it:.2f}); device busy "
             f"{busy_ms / it:.3f} ms/iteration, idle share "
             f"{1 - busy_ms / 1e3 / wall:.3f}; instances done "
             f"{int(state.done.sum())}/{BOX_BATCH}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
            _log(f"   {e.self_device_time_total / it / 1e3:8.4f} ms "
                 f"{e.count / it:7.1f}x  {e.key[:80]}")

    smoke.phase("where the box path's time goes", profile_box)

    # 14 --------------------------------------------------------------
    def family_kernel_times():
        """The kernel's time at the solver families' shapes (phases
        15-17), sweeps, f32, on random histories at the paths' fill
        levels, beside its bound and the plain version's time."""
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
        for label, batch, n, m in (("stochastic", 1, STOCH_DIM, STOCH_M),
                                   ("owlqn", OWL_BATCH, OWL_N, 6),
                                   ("owlqn_pair", OWL_BATCH, 2 * OWL_N, 6)):
            ncorrs = np.random.default_rng(n).integers(m, 3 * m, batch)
            h = cast(random_history(torch, history, batch, n, m, ncorrs,
                                    seed=n, device=dev), torch.float32)
            v = torch.as_tensor(np.random.default_rng(1).standard_normal(
                (batch, n)), dtype=torch.float32, device=dev)
            row = time_vs_bound(torch, fused, kernel_args(h, v), "sweeps",
                                flush)
            plan = fused.plan_for(*kernel_args(h, v), "sweeps")
            _log(f"   two_loop sweeps B={batch} m={m} n={n} float32 "
                 f"({label} shape): kernel {row['ms']:.4f} ms "
                 f"({row['bound_ms'] / row['ms']:.1%} of bound); plain "
                 f"{row['plain_ms']:.4f} ms; bound {row['bound_ms']:.5f} ms "
                 f"by {row['bound_by']} ({row['mbytes']:.3f} MB); plan "
                 f"{plan.warps} warps x {plan.stages} stages, grid "
                 f"{plan.grid}, staged {plan.staged}")
            for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
                smoke.kernel_rows[f"{label}_shape_{key}"] = row[key]

    smoke.phase("the kernel's time at the solver families' shapes",
                family_kernel_times)

    # 15 --------------------------------------------------------------
    # OWL-QN on the repo's recorded lasso family (scripts/probe_families.py
    # :31-66): every instance its own A (128 x 64, / sqrt(128)), a 6-sparse
    # w of N(0, 9) and noise 0.02, lambda 0.01, f32, from x0 = 0.
    owl_state = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    owl_a = torch.randn(OWL_BATCH, OWL_ROWS, OWL_N, generator=gen,
                        device=dev) / OWL_ROWS ** 0.5
    owl_w = torch.zeros(OWL_BATCH, OWL_N, device=dev)
    owl_w[:, :6] = 3.0 * torch.randn(OWL_BATCH, 6, generator=gen, device=dev)
    owl_b = (owl_a @ owl_w[:, :, None])[:, :, 0] + 0.02 * torch.randn(
        OWL_BATCH, OWL_ROWS, generator=gen, device=dev)
    owl_data = {"A": owl_a, "b": owl_b}
    owl_params = lt.LBFGSParams(epsilon=1e-5, epsilon_rel=0.0,
                                max_iterations=OWL_ITERS)

    def owlqn_path():
        from lbfgspp_tpu_torch import owlqn
        from lbfgspp_tpu_torch.linesearch import morethuente
        a64, b64 = owl_a.double(), owl_b.double()

        def full64(x):
            r = (a64 @ x.double()[:, :, None])[:, :, 0] - b64
            return 0.5 * (r * r).sum(1) + OWL_LAM * x.double().abs().sum(1)

        def kkt64(x):
            x = x.double()
            r = (a64 @ x[:, :, None])[:, :, 0] - b64
            g = (a64.transpose(1, 2) @ r[:, :, None])[:, :, 0]
            return owlqn.pseudo_gradient(x, g, OWL_LAM).abs().amax(1)

        polish_iters = [0]

        def counted_morethuente(*args, **kwargs):
            # one search per lockstep polish iteration
            polish_iters[0] += 1
            return morethuente(*args, **kwargs)

        def solve_a():
            return lt.minimize_owlqn(lasso_loss, torch.zeros_like(owl_w),
                                     OWL_LAM, owl_params, data=owl_data,
                                     device=dev)

        def solve_b():
            return lt.minimize_owlqn(lasso_loss, torch.zeros_like(owl_w),
                                     OWL_LAM, owl_params, data=owl_data,
                                     fast_phase_epsilon=1e-3, device=dev)

        polish_params = lt.LBFGSParams(epsilon=1e-9, epsilon_rel=0.0,
                                       max_iterations=100)

        def solve_c():
            return lt.polish_solve_owlqn(
                lasso_loss, owl_state["a"].x, OWL_LAM, polish_params,
                OWL_POLISH_ITERS, data=owl_data,
                line_search=counted_morethuente, on_ls_fail="restart",
                restarts=2, prior=owl_state["a"], device=dev)

        def timed(label, solve, iterations):
            """Capture (the warm-up), hold the kernel against plain on
            the captured calls, then the timed runs; ``iterations()`` is
            the run's batched iterations, one launch each."""
            calls = capture_calls(solve, every=7)     # also the warm-up
            worst = 0.0
            for args in calls:
                got = fused.two_loop(*args, -1.0, "sweeps")
                want = fused.two_loop_plain(*args, -1.0, "sweeps")
                err = ((got - want).abs().max() /
                       want.abs().max().clamp_min(1e-30)).item()
                worst = max(worst, err)
            shape = tuple(calls[0][0].shape) if calls else None
            _log(f"   {label}: kernel vs plain on {len(calls)} of the "
                 f"path's calls (every 7th, [B, m, n] = {shape}, sweeps "
                 f"f32): worst relative error {worst:.3e}")
            if not worst <= 1e-4:
                raise AssertionError(f"{label}: kernel disagrees with plain")
            secs = []
            for _ in range(FAMILY_RUNS):
                owlqn.COUNTS.clear()
                dfl.FALLBACKS.clear()
                polish_iters[0] = 0
                fused.two_loop.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solve()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                launches = fused.two_loop.launches
                want = iterations()
                if launches != want:
                    raise AssertionError(f"{label}: launches {launches} != "
                                         f"batched iterations {want}")
                if not torch.isfinite(res.x).all():
                    raise AssertionError(f"{label}: non-finite x")
                if sum(dfl.FALLBACKS.values()):
                    raise AssertionError(f"{label}: interpreter fallbacks "
                                         f"{dict(dfl.FALLBACKS)}")
            kkt = kkt64(res.x)
            q = [kkt.median().item(), kkt.quantile(0.99).item(),
                 kkt.max().item()]
            statuses = dict(sorted(collections.Counter(
                res.status.tolist()).items()))
            nnz = (res.x != 0).sum(1).double()
            evals = owlqn.COUNTS["evaluations"]
            _log(f"   {label}: median {np.median(secs):.3f} s of "
                 f"{', '.join(f'{s:.3f}' for s in secs)} = "
                 f"{OWL_BATCH / np.median(secs):.1f} solves/s; niter p50 "
                 f"{res.niter.double().median().item():.0f} max "
                 f"{int(res.niter.max())}; statuses {statuses}; nnz p50 "
                 f"{nnz.median().item():.0f}; f64 KKT violation p50 "
                 f"{q[0]:.3e} p99 {q[1]:.3e} max {q[2]:.3e}; batched "
                 f"iterations {want}, kernel launches {launches}"
                 + (f", batched evaluations {evals} (start points "
                    f"included), {evals / want:.2f} per iteration"
                    if evals else "") + "; interpreter fallbacks 0")
            owl_state[label] = res
            owl_state[f"{label} launches"] = launches
            owl_state[f"{label} seconds"] = float(np.median(secs))
            return res

        res_a = timed("a", solve_a, lambda: owlqn.COUNTS["iterations"])
        timed("b", solve_b, lambda: owlqn.COUNTS["iterations"])
        res_c = timed("c", solve_c, lambda: polish_iters[0])

        fa, fc = full64(res_a.x), full64(res_c.x)
        worse = int((fc > fa).sum())
        bar = fc <= fa + 1e-12
        pinned = (res_a.x == 0) & (res_a.grad.abs() <= OWL_LAM)
        xc = res_c.x[pinned]
        exact = bool((xc == 0).all()) and not bool(torch.signbit(xc).any())
        _log(f"   (c) vs (a): full L1 objective in f64 lower for "
             f"{int((fc < fa).sum())}, equal for {int((fc == fa).sum())}, "
             f"higher for {worse} (largest rise "
             f"{(fc - fa).clamp_min(0).max().item():.3e}); within (a) + "
             f"1e-12 (the bar of tests/test_polish.py:657) for "
             f"{int(bar.sum())}/{OWL_BATCH}; {int(pinned.sum())} pinned "
             f"zeros, all exact +0.0: {exact}")
        if not bool(bar.all()):
            raise AssertionError("the polish raised some full objective")
        if not exact:
            raise AssertionError("a pinned zero moved")
        k = min(OWL_CHECK, OWL_BATCH)
        ref = lt.minimize_owlqn(
            lasso_loss, torch.zeros(k, OWL_N, dtype=torch.float64), OWL_LAM,
            lt.LBFGSParams(epsilon=1e-10, epsilon_rel=0.0,
                           max_iterations=400),
            data={"A": a64[:k].cpu(), "b": b64[:k].cpu()}, device="cpu")
        r = (a64[:k].cpu() @ ref.x[:, :, None])[:, :, 0] - b64[:k].cpu()
        fstar = 0.5 * (r * r).sum(1) + OWL_LAM * ref.x.abs().sum(1)
        gap = (fc[:k].cpu() - fstar).abs() / fstar.abs().clamp_min(1.0)
        _log(f"   (c) against the port's f64 CPU solve of the first {k} "
             f"(epsilon 1e-10, 400 iterations): |F - F*| / max(1, |F*|) "
             f"max {gap.max().item():.3e} (limit 1e-5)")
        if not bool((gap <= 1e-5).all()):
            raise AssertionError("the polished objective is off the f64 "
                                 "optimum")

    smoke.phase("OWL-QN lasso at full width, its fast phase and its df64 "
                "polish", owlqn_path)

    # 16 --------------------------------------------------------------
    # Multi-batch L-BFGS on logistic regression (scripts/probe_families.py
    # :71-99): 2^16 rows, dim 256, data made on the card.
    stoch_state = {}

    def logreg_data(rows, dim, dtype, seed, device):
        g = torch.Generator(device=device).manual_seed(seed)
        w = torch.randn(dim, generator=g, device=device, dtype=dtype)
        x = torch.randn(rows, dim, generator=g, device=device, dtype=dtype)
        u = torch.rand(rows, generator=g, device=device, dtype=dtype)
        return {"X": x, "y": (u < torch.sigmoid(x @ w)).to(dtype)}

    def stochastic_path():
        data = logreg_data(STOCH_ROWS, STOCH_DIM, torch.float32, 1, dev)
        p = lt.LBFGSParams(m=STOCH_M, max_iterations=STOCH_STEPS)
        x0 = torch.zeros(STOCH_DIM, device=dev)

        def solve():
            return lt.minimize_stochastic(
                logreg_loss, x0, data, p, batch_size=STOCH_BATCH,
                overlap_frac=0.25, step_size=0.5, device=dev)

        calls = capture_calls(solve)                  # also the warm-up
        worst = max(((fused.two_loop(*a, -1.0, "sweeps")
                      - fused.two_loop_plain(*a, -1.0, "sweeps")).abs().max()
                     / fused.two_loop_plain(*a, -1.0, "sweeps").abs().max()
                     .clamp_min(1e-30)).item() for a in calls)
        _log(f"   kernel vs plain on the {len(calls)} calls of a run "
             f"([B, m, n] = {tuple(calls[0][0].shape)}, sweeps f32): worst "
             f"relative error {worst:.3e}")
        if not worst <= 1e-4:
            raise AssertionError("kernel disagrees with plain")
        secs = []
        for _ in range(FAMILY_RUNS):
            fused.two_loop.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches = fused.two_loop.launches
            if launches != STOCH_STEPS:
                raise AssertionError(f"launches {launches} != "
                                     f"{STOCH_STEPS} steps")
        if not torch.isfinite(res.x).all():
            raise AssertionError("non-finite x")
        f0 = logreg_loss(x0, data).item()
        f1 = logreg_loss(res.x, data).item()
        _log(f"   B=1 rows={STOCH_ROWS} dim={STOCH_DIM} batch "
             f"{STOCH_BATCH} overlap 0.25 step 0.5 m={STOCH_M} f32: median "
             f"{np.median(secs):.3f} s of "
             f"{', '.join(f'{s:.3f}' for s in secs)} = "
             f"{STOCH_STEPS / np.median(secs):.1f} iterations/s; "
             f"full-data loss {f0:.6f} -> {f1:.6f} (limit 0.25 ln 2 = "
             f"{0.25 * math.log(2):.6f}); nskip {int(res.nskip)}; kernel "
             f"launches {launches}")
        stoch_state.update(launches=launches, seconds=float(np.median(secs)))
        if not f1 <= 0.25 * math.log(2):
            raise AssertionError("the full-data loss stayed above "
                                 "0.25 ln 2")
        # f64 on the card against the port's CPU run on the same data
        small = logreg_data(1 << 12, 64, torch.float64, 2, "cpu")
        runs = [lt.minimize_stochastic(
            logreg_loss, torch.zeros(64, dtype=torch.float64),
            {k: v.to(d) for k, v in small.items()},
            lt.LBFGSParams(m=STOCH_M, max_iterations=20), batch_size=512,
            overlap_frac=0.25, step_size=0.5, device=d).x.cpu()
            for d in (dev, "cpu")]
        rel = ((runs[0] - runs[1]).abs().max() /
               runs[1].abs().max()).item()
        _log(f"   f64, 2^12 rows x dim 64, 20 steps: card vs CPU max|dx| / "
             f"max|x| = {rel:.3e} (limit 1e-8)")
        if not rel <= 1e-8:
            raise AssertionError("the card's f64 run differs from the CPU's")

    smoke.phase("stochastic L-BFGS at full width", stochastic_path)

    # 17 --------------------------------------------------------------
    # Implicit differentiation: the hypergradient of tests/test_implicit.py
    # :83-107 scaled up, B ridge logistic regressions with their own data,
    # theta = log lambda on a grid over [-4, 0].
    imp_state = {}

    def ridge_data(batch, dtype, seed, device):
        """Training and validation rows with labels of random sign (the
        test's own data, per instance), and the log lambda grid."""
        g = torch.Generator(device=device).manual_seed(seed)

        def rows():
            a = torch.randn(batch, IMP_ROWS, IMP_D, generator=g,
                            device=device, dtype=dtype)
            return a, torch.sign(torch.randn(batch, IMP_ROWS, generator=g,
                                             device=device, dtype=dtype))
        (a, y), (av, yv) = rows(), rows()
        loglam = torch.linspace(-4.0, 0.0, batch, device=device, dtype=dtype)
        return a, y, av, yv, loglam

    def val_loss(res_x, av, yv):
        z = yv * (av @ res_x[:, :, None])[:, :, 0]
        return torch.logaddexp(torch.zeros_like(z), -z).mean(1)

    def hypergrad(a, y, av, yv, loglam, params, precondition=True):
        """d(validation loss)/d(log lambda) of every instance, the
        seconds of the backward and its kernel launches."""
        loglam = loglam.clone().requires_grad_()
        res = lt.implicit_minimize(
            ridge_loss, torch.zeros(a.shape[0], IMP_D, dtype=a.dtype,
                                    device=a.device),
            {"loglam": loglam, "A": a, "y": y}, params,
            precondition=precondition, device=a.device)
        torch.cuda.synchronize()
        t1, launches = time.perf_counter(), fused.two_loop.launches
        val_loss(res.x, av, yv).sum().backward()
        torch.cuda.synchronize()
        return (loglam.grad, res, time.perf_counter() - t1,
                fused.two_loop.launches - launches)

    def implicit_path():
        from lbfgspp_tpu_torch import diff
        a, y, av, yv, loglam = ridge_data(IMP_BATCH, torch.float32, 3, dev)
        p32 = lt.LBFGSParams(epsilon=1e-5, epsilon_rel=0.0,
                             max_iterations=200)
        calls = capture_calls(                        # also the warm-up
            lambda: hypergrad(a, y, av, yv, loglam, p32))
        worst = max(((fused.two_loop(*c, 1.0, "sweeps")
                      - fused.two_loop_plain(*c, 1.0, "sweeps")).abs().max()
                     / fused.two_loop_plain(*c, 1.0, "sweeps").abs().max()
                     .clamp_min(1e-30)).item() for c in calls)
        _log(f"   kernel vs plain on the {len(calls)} calls of the forward "
             f"solve and the backward's preconditioner ([B, m, n] = "
             f"{tuple(calls[-1][0].shape)}, sweeps f32): worst relative "
             f"error {worst:.3e}")
        if not worst <= 1e-4:
            raise AssertionError("kernel disagrees with plain")
        cg = {}
        for pre in (False, True):
            diff.COUNTS.clear()
            fused.two_loop.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grad, res, back, launches = hypergrad(a, y, av, yv, loglam, p32,
                                                  pre)
            total = time.perf_counter() - t0
            cg[pre] = diff.COUNTS["cg_iterations"]
            _log(f"   precondition={pre}: forward {total - back:.3f} s "
                 f"(niter p50 {res.niter.double().median().item():.0f} max "
                 f"{int(res.niter.max())}), backward {back:.3f} s; CG "
                 f"lockstep iterations {cg[pre]} (an instance's mean "
                 f"{diff.COUNTS['instance_iterations'] / IMP_BATCH:.2f}); "
                 f"kernel launches in the backward {launches}")
            if not torch.isfinite(grad).all():
                raise AssertionError("a non-finite hypergradient")
            want = cg[pre] + 1 if pre else 0
            if launches != want:
                raise AssertionError(f"backward launches {launches} != "
                                     f"{want}")
        imp_state.update(launches=launches, cg=cg[True])
        # f64, the first 16, against central finite differences
        k, eps = min(IMP_CHECK, IMP_BATCH), 1e-5
        a, y, av, yv, loglam = (t[:k].double() for t in (a, y, av, yv,
                                                         loglam))
        p64 = lt.LBFGSParams(epsilon=1e-10, epsilon_rel=0.0,
                             max_iterations=200)
        grad = hypergrad(a, y, av, yv, loglam, p64)[0]
        with torch.no_grad():
            # The f64 solve stops at the Armijo test's rounding floor
            # (gradient norm ~1e-8), whose noise in x is ~1e-4 of a central
            # difference at eps 1e-5; two Newton steps on each solve (the
            # exact 64 x 64 Hessian) put the differenced points on the
            # argmin.
            fd = []
            for sign in (1.0, -1.0):
                th = {"loglam": loglam + sign * eps, "A": a, "y": y}
                x = lt.implicit_minimize(
                    ridge_loss, torch.zeros(k, IMP_D, dtype=torch.float64,
                                            device=dev), th, p64,
                    device=dev).x
                for _ in range(2):
                    g = torch.func.vmap(torch.func.grad(ridge_loss))(x, th)
                    h = torch.func.vmap(torch.func.hessian(ridge_loss))(x,
                                                                      th)
                    x = x - torch.linalg.solve(h, g[:, :, None])[:, :, 0]
                fd.append(val_loss(x, av, yv))
            fd = (fd[0] - fd[1]) / (2 * eps)
        err = ((grad - fd).abs() / fd.abs().clamp_min(1.0)).max().item()
        _log(f"   f64, the first {k}: |hypergradient - central difference "
             f"(eps 1e-5, Newton-refined argmins)| / max(1, |fd|) max "
             f"{err:.3e} (limit 1e-5)")
        if not err <= 1e-5:
            raise AssertionError("hypergradient off the finite differences")

    smoke.phase("implicit differentiation at full width", implicit_path)

    # 18 --------------------------------------------------------------
    # The kernel's bf16 modes: all-bf16 (the Pallas kernel's bf16 mode) and
    # bf16 rows beside f32 operands (a float32 solve whose history stores
    # bf16 rows).  Tolerances: bf16 rows 1e-4 of the largest output, as
    # phase 2's f32; all bf16 2^-8 of each instance's largest output
    # against the plain version computed in f32 from the same bf16 inputs
    # (the kernel rounds its f32 result once, at most half a bf16 ulp).
    bf16 = torch.bfloat16
    kinds = {"bf16": bf16, "bf16rows": torch.float32}   # kind -> operands
    bf16_state = {}

    def bf16_args(args, op):
        """bf16 rows (s, y); every other floating operand in ``op``."""
        return tuple(t.to(bf16 if k < 2 else op)
                     if t is not None and t.is_floating_point() else t
                     for k, t in enumerate(args))

    def bf16_error(args, got, mode):
        """(the gated error, per instance over its largest output; its
        error against the plain f32 rounded once and against the plain
        version that rounds per op, the same way)."""
        def rel(a, b):
            return ((a.float() - b.float()).abs().amax(1) /
                    b.float().abs().amax(1).clamp_min(1e-30)).max().item()
        if got.dtype == bf16:
            f32 = fused.two_loop_plain(*cast_args(args, torch.float32),
                                       -1.0, mode)
            per_op = fused.two_loop_plain(*args, -1.0, mode)
            return rel(got, f32), rel(got, f32.to(bf16)), rel(got, per_op)
        want = fused.two_loop_plain(*args, -1.0, mode)
        err = ((got - want).abs().max() / want.abs().max()).item()
        return err, err, err

    def synthetic(batch, n, m, op, seed, rows=bf16):
        """Random rows (bf16 by default) and well-scaled [m, m] operands
        made on the card (a history of this size is not built pair by
        pair)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        s = torch.randn(batch, m, n, generator=g, device=dev).to(rows)
        y = torch.randn(batch, m, n, generator=g, device=dev).to(rows)
        ys = torch.rand(batch, m, generator=g, device=dev) + 1.0
        mats = [0.01 * torch.randn(batch, m, m, generator=g, device=dev)
                for _ in range(3)]
        v = torch.randn(batch, n, generator=g, device=dev)
        ints = [torch.full((batch,), m, dtype=torch.int32, device=dev)] * 2
        return (s, y) + tuple(
            t.to(op) if t.is_floating_point() else t
            for t in (ys, torch.ones(batch, device=dev), *ints, *mats, v))

    def bf16_kernel():
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
        worst = []
        shapes = [
            ("main shape", MAIN_BATCH, MAIN_N, MAIN_M,
             np.random.default_rng(3).integers(0, 3 * MAIN_M, MAIN_BATCH)),
            ("m=1 B=4097 n=101", MAIN_BATCH + 1, 101, 1,
             np.random.default_rng(4).integers(0, 3, MAIN_BATCH + 1)),
            ("odd offset", 300, MAIN_N, MAIN_M,
             np.random.default_rng(6).integers(0, 3 * MAIN_M, 300)),
        ]
        for label, batch, n, m, ncorrs in shapes:
            h64 = random_history(torch, history, batch, n, m, ncorrs,
                                 seed=m, device=dev)
            v64 = torch.as_tensor(np.random.default_rng(1).standard_normal(
                (batch, n)), device=dev)
            for kind, op in kinds.items():
                args = bf16_args(kernel_args(h64, v64), op)
                if label == "odd offset":
                    args = (at_odd_offset(torch, args[0]),) + args[1:9] + \
                        (at_odd_offset(torch, args[9]),)
                for mode in ("sweeps", "rinv"):
                    plan, why = fused.route(*args, mode)
                    if plan is None or plan.kind != kind:
                        raise AssertionError(f"{label} {kind}: routed to "
                                             f"{why}")
                    got = fused.two_loop(*args, -1.0, mode)
                    torch.cuda.synchronize()
                    err, rounded, per_op = bf16_error(args, got, mode)
                    limit = 2.0 ** -8 if op == bf16 else 1e-4
                    ok = err <= limit
                    _log(f"   {label:16s} {kind:8s} {mode:6s} error "
                         f"{err:.3e} (limit {limit:.3e}) "
                         f"{'ok' if ok else 'TOO LARGE'}; against plain f32 "
                         f"rounded once {rounded:.3e}, against plain per op "
                         f"{per_op:.3e}; plan {plan.warps} warps x "
                         f"{plan.stages} stages, staged {plan.staged}, "
                         f"copies {sorted(set(plan.copy.values()))}")
                    if not ok:
                        worst.append((label, kind, mode, err))
                    if label == "main shape" and mode == "rinv":
                        smoke.kernel_rows[f"{kind}_max_abs_err"] = \
                            (got.float() - fused.two_loop_plain(
                                *cast_args(args, torch.float32), -1.0,
                                mode)).abs().max().item()
        # The largest-n shape: bf16 rows of one instance, m=6, n=2^27.
        # two_loop sends it to the plain version ("large n"); the kernel
        # is launched here directly (one launch per mode, seconds each).
        big = synthetic(1, LARGEST_N, 6, torch.float32, seed=5)
        for mode in ("rinv", "sweeps"):
            plan = fused.plan_for(*big, mode)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            got = fused._launch(plan, *big, -1.0, mode)
            e1.record()
            torch.cuda.synchronize()
            err = bf16_error(big, got, mode)[0]
            p_ms = median_ms_of(torch, lambda: fused.two_loop_plain(
                *big, -1.0, mode), flush)
            nbytes = args_bytes(big, mode)
            _log(f"   B=1 m=6 n=2^{LARGEST_N.bit_length() - 1} bf16rows "
                 f"{mode:6s}: kernel {e0.elapsed_time(e1):.1f} ms (one "
                 f"launch, rows in memory, warps {plan.warps}), plain "
                 f"{p_ms:.3f} ms, bound {nbytes / HBM_BYTES_PER_S * 1e3:.3f}"
                 f" ms ({nbytes / 1e9:.2f} GB); error {err:.3e} (limit "
                 f"1e-4) {'ok' if err <= 1e-4 else 'TOO LARGE'}")
            if not err <= 1e-4:
                worst.append(("largest n", "bf16rows", mode, err))
        # The dispatch: every plain route once, counted apart.
        fused.reset_counts()
        fused.two_loop(*big, -1.0, "rinv")
        del big, got
        torch.cuda.empty_cache()
        for label, batch, n, m, dtype in (
                ("m=200 f32", 4, MAIN_N, 200, torch.float32),
                ("m=120 f64", 4, MAIN_N, 120, torch.float64),
                ("f16", 5, 24, 6, torch.float16)):
            h = random_history(torch, history, batch, n, m, [m + 3] * batch,
                               seed=m, device=dev)
            args = cast_args(kernel_args(h, torch.as_tensor(
                np.random.default_rng(2).standard_normal((batch, n)),
                device=dev)), dtype)
            got = fused.two_loop(*args, -1.0, "rinv")
            torch.cuda.synchronize()
            _log(f"   {label}: routed to the plain version; finite "
                 f"{bool(torch.isfinite(got).all())}")
        routes = dict(fused.two_loop.plain_reasons)
        _log(f"   plain routes {fused.two_loop.plain_routes} {routes}, "
             f"kernel launches {fused.two_loop.launches}")
        if routes != {"large n": 1, "shared memory": 2, "dtype": 1} or \
                fused.two_loop.launches:
            raise AssertionError("the plain routes are not as expected")
        # The dispatch rule on (B, n): f32 and bf16 rows, m=6, rinv, the
        # kernel (launched with its own plan) against plain around LARGE_N
        # and around each type's batch threshold; device time (CUDA events,
        # the host held back) and the time a solver's loop pays per call
        # (host clock over 25 calls in a row, then a synchronize: the plain
        # version's ~40 launches included).  The route two_loop takes must
        # not lose on both by more than RULE_MARGIN.
        def per_call_ms(fn, calls=25):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / calls * 1e3

        for kind, batches in RULE_POINTS.items():
            for batch in batches:
                for lg in RULE_LOG_N:
                    args = synthetic(batch, 1 << lg, 6, torch.float32,
                                     seed=lg, rows=torch.float32
                                     if kind == "f32" else bf16)
                    plan = fused.plan_for(*args, "rinv")

                    def kernel():
                        return fused._launch(plan, *args, -1.0, "rinv")

                    def plain():
                        return fused.two_loop_plain(*args, -1.0, "rinv")
                    k_ms, p_ms = (median_ms_of(torch, f, flush)
                                  for f in (kernel, plain))
                    k_call, p_call = per_call_ms(kernel), per_call_ms(plain)
                    took = fused.route(*args, "rinv")[1] or "kernel"
                    # the route's times over the other's, per metric
                    ratios = (k_ms / p_ms, k_call / p_call)
                    if took != "kernel":
                        ratios = tuple(1.0 / r for r in ratios)
                    bad = min(ratios) > 1.0 + RULE_MARGIN
                    _log(f"   rule {kind:8s} B={batch:4d} n=2^{lg}: device "
                         f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; per "
                         f"call in a loop kernel {k_call:.4f} ms, plain "
                         f"{p_call:.4f} ms -> two_loop takes the {took} "
                         f"(its time over the other's: device "
                         f"{ratios[0]:.2f}, per call {ratios[1]:.2f})"
                         f"{'; LOSES ON BOTH' if bad else ''}")
                    if bad:
                        worst.append(("rule", kind, batch, lg, ratios))
                    del args
                torch.cuda.empty_cache()
        if worst:
            raise AssertionError(f"bf16 kernel disagrees with plain: {worst}")

    def bf16_timing():
        """At the main shape on phase 4's state, in turns (f32, bf16 rows,
        bf16, bf16, bf16 rows, f32), beside the bound."""
        res = main_state["res"]
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
        base = kernel_args(res.history, res.grad.contiguous())
        variants = {"f32": base, "bf16rows": bf16_args(base, torch.float32),
                    "bf16": bf16_args(base, bf16)}
        for mode in ("rinv", "sweeps"):
            times = collections.defaultdict(list)
            for kind in ("f32", "bf16rows", "bf16", "bf16", "bf16rows",
                         "f32"):
                args = variants[kind]
                times[kind].append(median_ms_of(
                    torch, lambda: fused.two_loop(*args, -1.0, mode), flush))
            for kind in ("bf16rows", "bf16"):
                args = variants[kind]
                row = time_vs_bound(torch, fused, args, mode, flush)
                k_ms = float(np.mean(times[kind]))
                f_ms = float(np.mean(times["f32"]))
                _log(f"   two_loop {mode:6s} B={MAIN_BATCH} m={MAIN_M} "
                     f"n={MAIN_N} {kind:8s}: kernel {k_ms:.4f} ms (turns "
                     f"{' '.join(f'{t:.4f}' for t in times[kind])}; "
                     f"{row['bound_ms'] / k_ms:.1%} of bound), f32 rows "
                     f"{f_ms:.4f} ms; plain {row['plain_ms']:.4f} ms; bound "
                     f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
                     f"({row['mbytes']:.1f} MB)")
                if mode == "rinv":
                    smoke.kernel_rows.update({
                        f"{kind}_ms": k_ms,
                        f"{kind}_plain_ms": row["plain_ms"],
                        f"{kind}_bound_ms": row["bound_ms"],
                        f"{kind}_bound_by": row["bound_by"]})
                else:
                    smoke.kernel_rows[f"{kind}_sweeps_ms"] = k_ms

    smoke.phase("the kernel's bf16 modes against plain, and the plain "
                "routes", bf16_kernel)
    if "res" in main_state:
        smoke.phase("the kernel's bf16 modes' time at the main shape",
                    bf16_timing)

    # 19 --------------------------------------------------------------
    def bf16_main_phase():
        """Phase 4's main phase through lbfgs.minimize with f32 rows and
        with bf16 rows, in turns; then everything in bf16."""
        def solve(rows):
            return lt.minimize(objectives.rosenbrock, x0s, params,
                               direction="rinv", on_ls_fail="restart",
                               history_dtype=rows, device=dev)

        solve(bf16)                                  # warm-up
        for rows in (None, bf16, bf16, None):
            fused.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve(rows)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            kind = "bf16rows" if rows is not None else "f32"
            executed = int(res.niter.max())
            err = (res.x.double() - 1.0).abs().max(dim=1).values
            _log(f"   {kind:8s} rows: {secs:.3f} s = {MAIN_BATCH / secs:.1f} "
                 f"solves/s; iterations {int(res.niter.min())}..{executed};"
                 f" launches {dict(fused.two_loop.kind_launches)}, plain "
                 f"routes {fused.two_loop.plain_routes}; "
                 f"frac_within_1e-3={(err <= 1e-3).double().mean().item():.4f}"
                 f" frac_within_1e-4={(err <= 1e-4).double().mean().item():.4f}")
            if not torch.isfinite(res.x).all():
                raise AssertionError(f"{kind} rows: non-finite x")
            if fused.two_loop.kind_launches[kind] != executed or \
                    fused.two_loop.launches != executed or \
                    fused.two_loop.plain_routes:
                raise AssertionError(f"{kind} rows: launches "
                                     f"{dict(fused.two_loop.kind_launches)}"
                                     f" != batched iterations {executed}")
            if rows is not None:
                if res.history.s.dtype != bf16:
                    raise AssertionError("the rows are not stored in bf16")
                bf16_state["bf16rows launches"] = executed
        # everything in bf16: x0, rows and operands (the Pallas mode, sweeps)
        p16 = lt.LBFGSParams(epsilon=0.125, max_iterations=MAIN_ITERS,
                             m=MAIN_M, max_linesearch=2)
        fused.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lt.minimize(objectives.rosenbrock, x0s.to(bf16), p16,
                          direction="sweeps", on_ls_fail="restart",
                          device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        executed = int(res.niter.max())
        err = (res.x.double() - 1.0).abs().max(dim=1).values
        _log(f"   all bf16 (sweeps, epsilon 0.125): {secs:.3f} s = "
             f"{MAIN_BATCH / secs:.1f} solves/s; iterations "
             f"{int(res.niter.min())}..{executed}; launches "
             f"{dict(fused.two_loop.kind_launches)}, plain routes "
             f"{fused.two_loop.plain_routes}; max|x - 1| < 0.2 (the bar of "
             f"tests/test_dtypes.py:25-31) for "
             f"{(err < 0.2).double().mean().item():.4f} of the instances "
             f"(stated, not gated); median max|x - 1| "
             f"{err.median().item():.4f}; statuses "
             f"{dict(sorted(collections.Counter(res.status.tolist()).items()))}")
        if res.x.dtype != bf16 or not torch.isfinite(res.x).all():
            raise AssertionError("all bf16: x not finite bf16")
        if fused.two_loop.kind_launches["bf16"] != executed or \
                fused.two_loop.plain_routes:
            raise AssertionError("all bf16: launches != batched iterations")
        bf16_state["bf16 launches"] = executed

    smoke.phase("a bf16-row main phase at full width", bf16_main_phase)

    # 20 --------------------------------------------------------------
    def largest_n():
        """scripts/bench_largest_n.py's plain path: one rosenbrock_split
        solve at n = 2^27, f32, m=6, epsilon=0, for 6 and 16 iterations,
        differenced; bf16 rows, then f32 rows."""
        m, k1, k2 = 6, 6, 16
        n = LARGEST_N
        x0 = 2.0 * torch.rand(n, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev) - 1.0
        # bytes one iteration must move (scripts/bench_largest_n.py:126-133):
        # the two passes of the direction over s and y, the Grams' read
        # and the ring write, ~10 vectors of f32
        for rows, size in ((bf16, 2), (None, 4)):
            secs = {}
            for k in (k1, k2):
                p = lt.LBFGSParams(epsilon=0.0, epsilon_rel=0.0,
                                   max_iterations=k, m=m)
                fused.reset_counts()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = lt.minimize(objectives.rosenbrock_split, x0, p,
                                  history_dtype=rows, device=dev)
                torch.cuda.synchronize()
                secs[k] = time.perf_counter() - t0
                if int(res.niter) != k or not bool(torch.isfinite(
                        res.fx)):
                    raise AssertionError(f"n=2^27: niter {int(res.niter)}, "
                                         f"fx {float(res.fx)}")
                del res
            per_iter = (secs[k2] - secs[k1]) / (k2 - k1)
            total = 2 * (2 * m) * n * size + (2 * m) * n * size + \
                4 * n * 4 + 10 * n * 4
            peak = torch.cuda.max_memory_allocated()
            label = "bf16" if rows is not None else "f32"
            _log(f"   n=2^27 {label} rows: {secs[k1]:.3f} s for {k1} and "
                 f"{secs[k2]:.3f} s for {k2} iterations -> "
                 f"{per_iter:.4f} s/iteration; ~{total / 1e9:.2f} GB per "
                 f"iteration = {total / per_iter / main_state.get('bandwidth', HBM_BYTES_PER_S):.1%} "
                 f"of the measured bandwidth; peak memory "
                 f"{peak / 1e9:.2f} GB; the direction took the plain route "
                 f"{dict(fused.two_loop.plain_reasons)}, kernel launches "
                 f"{fused.two_loop.launches}")
            torch.cuda.empty_cache()

    smoke.phase("the largest-n solve (n = 2^27)", largest_n)

    # 21 --------------------------------------------------------------
    def bf16_families_and_front_ends():
        import tempfile
        from lbfgspp_tpu_torch import optax_compat, owlqn, scipy_compat
        from lbfgspp_tpu_torch.utils import checkpoint
        # phase 15's lasso, bf16 rows
        owlqn.COUNTS.clear()
        fused.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lt.minimize_owlqn(lasso_loss, torch.zeros_like(owl_w), OWL_LAM,
                                owl_params, data=owl_data,
                                history_dtype=bf16, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        a64, b64 = owl_a.double(), owl_b.double()
        x = res.x.double()
        r = (a64 @ x[:, :, None])[:, :, 0] - b64
        g = (a64.transpose(1, 2) @ r[:, :, None])[:, :, 0]
        kkt = owlqn.pseudo_gradient(x, g, OWL_LAM).abs().amax(1)
        iters = owlqn.COUNTS["iterations"]
        _log(f"   lasso B={OWL_BATCH}, bf16 rows: {secs:.3f} s = "
             f"{OWL_BATCH / secs:.1f} solves/s; niter p50 "
             f"{res.niter.double().median().item():.0f} max "
             f"{int(res.niter.max())}; f64 KKT violation p50 "
             f"{kkt.median().item():.3e} max {kkt.max().item():.3e}; "
             f"launches {dict(fused.two_loop.kind_launches)} for {iters} "
             f"batched iterations")
        if res.history.s.dtype != bf16 or not torch.isfinite(res.x).all() \
                or fused.two_loop.kind_launches["bf16rows"] != iters:
            raise AssertionError("lasso with bf16 rows")
        # phase 16's stochastic run, bf16 rows
        data = logreg_data(STOCH_ROWS, STOCH_DIM, torch.float32, 1, dev)
        fused.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lt.minimize_stochastic(
            logreg_loss, torch.zeros(STOCH_DIM, device=dev), data,
            lt.LBFGSParams(m=STOCH_M, max_iterations=STOCH_STEPS),
            batch_size=STOCH_BATCH, overlap_frac=0.25, step_size=0.5,
            history_dtype=bf16, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        f1 = logreg_loss(res.x, data).item()
        _log(f"   stochastic, bf16 rows: {secs:.3f} s = "
             f"{STOCH_STEPS / secs:.1f} iterations/s; full-data loss "
             f"{f1:.6f} (limit {0.25 * math.log(2):.6f}); nskip "
             f"{int(res.nskip)}; launches "
             f"{dict(fused.two_loop.kind_launches)}")
        if res.history.s.dtype != bf16 or not f1 <= 0.25 * math.log(2) or \
                fused.two_loop.kind_launches["bf16rows"] != STOCH_STEPS:
            raise AssertionError("stochastic with bf16 rows")
        # scipy_compat: one solve; x stays on the card
        out = scipy_compat.minimize(
            objectives.rosenbrock, torch.full((MAIN_N,), -1.2,
                                              dtype=torch.float64,
                                              device=dev),
            options={"gtol": 1e-8, "maxiter": 1000}, device=dev)
        err = (out.x - 1.0).abs().max().item()
        _log(f"   scipy_compat.minimize, Rosenbrock n={MAIN_N} f64: nit "
             f"{out.nit}, nfev {out.nfev}, success {out.success} "
             f"({out.message}), x on {out.x.device}, max|x - 1| {err:.3e}")
        if not (out.success and out.x.device.type == "cuda" and err < 1e-6):
            raise AssertionError("scipy_compat.minimize")
        # optax_compat: 20 optimizer steps of a small regression model
        gen = torch.Generator(device=dev).manual_seed(4)
        feats = torch.randn(512, 16, generator=gen, device=dev)
        target = torch.tanh(feats @ torch.randn(16, 1, generator=gen,
                                                device=dev))
        model = torch.nn.Sequential(torch.nn.Linear(16, 32),
                                    torch.nn.Tanh(),
                                    torch.nn.Linear(32, 1)).to(dev)
        opt = optax_compat.LBFGS(model.parameters(),
                                 lt.LBFGSParams(m=8), history_dtype=bf16)

        def closure():
            opt.zero_grad()
            loss = ((model(feats) - target) ** 2).mean()
            loss.backward()
            return loss

        first = closure().item()
        for _ in range(20):
            opt.step(closure)
        last = closure().item()
        _log(f"   optax_compat.LBFGS, bf16 rows, 20 steps of an MLP "
             f"(16-32-1): loss {first:.6f} -> {last:.6f}; niter "
             f"{int(optax_compat.niter(opt))}, status "
             f"{int(optax_compat.status(opt))}")
        if not (math.isfinite(last) and last < 0.5 * first):
            raise AssertionError("optax_compat did not train")
        # checkpoint: a card state (bf16 rows) saved, restored, resumed
        s = lt.solver(objectives.rosenbrock, params, direction="rinv",
                      history_dtype=bf16, device=dev)
        state = s.init(x0s[:256])
        for _ in range(5):
            state = s.step(state)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "state.npz")
            checkpoint.save_state(path, state)
            back = checkpoint.load_state(path, s.init(x0s[:256]))
        a = s.finalize(s.run_fixed(state, 10))
        b = s.finalize(s.run_fixed(back, 10))
        same = torch.equal(a.x, b.x) and torch.equal(a.niter, b.niter)
        _log(f"   checkpoint of a card state (B=256, bf16 rows, after 5 "
             f"steps): restored on {back.x.device}, rows {back.hist.s.dtype},"
             f" 10 more steps bit-identical: {same}")
        if not same:
            raise AssertionError("a restored state did not resume exactly")

    smoke.phase("bf16 rows on the lasso and stochastic paths; the interop "
                "front ends", bf16_families_and_front_ends)

    # 22 --------------------------------------------------------------
    import torch.distributed as dist
    from lbfgspp_tpu_torch.parallel import collectives as coll
    from lbfgspp_tpu_torch.tools import sharded_cases, spawn_ranks
    split_state = {}

    def collectives_on_one():
        """Every collective on an NCCL group of one rank: each equals its
        local value, and each call ticks its site's counter once."""
        import socket
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1)
        split_state["group"] = dist.group.WORLD
        got = sharded_cases.collectives(seed=4, device="cuda")
        d = {k: torch.as_tensor(v, device=dev) for k, v in
             sharded_cases.collective_inputs(4, 0).items()}
        a, b, mat = d["a"], d["b"], d["mat"]
        want = {
            "psum": a, "pdot": torch.linalg.vecdot(a, b),
            "psqnorm": torch.linalg.vecdot(a, a),
            "pnorm": torch.linalg.vecdot(a, a).sqrt(), "pmax": a,
            "pmin": a, "pall": d["flags"],
            "pmax_abs": a.abs().amax(1),
            "pdot2": torch.stack([torch.linalg.vecdot(a, b),
                                  torch.linalg.vecdot(b, b)], 1),
            "pmatvec": (mat @ a[:, :, None])[:, :, 0],
            "pgram": mat @ mat.transpose(1, 2),
            "pfused": torch.cat([a, mat.reshape(3, -1)], 1),
            "gather_rows": torch.arange(5.0, dtype=a.dtype, device=dev)
            [:, None].expand(-1, 2),
            "gather_bool": torch.arange(5, device=dev) > 2}
        bad = [k for k, v in want.items() if not torch.equal(got[k], v)]
        counts = got["counts"]
        _log(f"   NCCL group of one ({dist.get_backend()}): "
             f"{len(want)} collectives equal their local values: "
             f"{not bad}; calls by site {counts}")
        if bad or any(v != 1 for k, v in counts.items() if k != "gather") \
                or counts.get("gather") != 2:
            raise AssertionError(f"collectives on one rank: {bad}, {counts}")

    smoke.phase("the collectives on an NCCL group of one", collectives_on_one)

    # 23 --------------------------------------------------------------
    def sharded_logreg():
        """scripts/bench_largest_n_logreg.py on the card: the feature-split
        logistic regression (make_sharded_logreg's pattern, the design
        matrix regenerated from seeded generators in row chunks in both
        passes of every evaluation) at n = 2^27, 8 rows, m=6, f32,
        epsilon 0, through minimize_sharded on the NCCL group of one, 6
        and 16 iterations differenced, f32 and bf16 rows; held bit for
        bit against the same solve by lbfgs's solver on the oracle with
        the all-reduce taken out."""
        from lbfgspp_tpu_torch import lbfgs as tlbfgs
        group = split_state["group"]
        n, rows, chunks, m = LARGEST_N, LOGREG_ROWS, LOGREG_CHUNKS, 6
        rc = rows // chunks
        labels = torch.sign(torch.randn(rows, generator=torch.Generator(
            device=dev).manual_seed(1), device=dev))
        evals = [0]

        def a_chunk(c):
            gen = torch.Generator(device=dev).manual_seed(1000 + c)
            return torch.randn(rc, n, generator=gen, device=dev) / \
                math.sqrt(n)

        def make_fg(grp):
            def fg(w):
                evals[0] += 1
                logits = torch.cat([w @ a_chunk(c).T
                                    for c in range(chunks)], 1)
                logits = coll.psum(logits, grp, "logreg.logits")
                z = -labels * logits
                d = -labels * torch.sigmoid(z)
                grad = torch.zeros_like(w)
                for c in range(chunks):
                    grad += d[:, c * rc:(c + 1) * rc] @ a_chunk(c)
                return torch.logaddexp(torch.zeros_like(z), z).sum(-1), grad
            return fg

        x0 = torch.zeros(n, device=dev)
        k1, k2 = 6, 16
        for hdt, size in ((None, 4), (bf16, 2)):
            label = "f32" if hdt is None else "bf16"
            secs, per_site = {}, {}
            for k in (k1, k2):
                p = lt.LBFGSParams(epsilon=0.0, epsilon_rel=0.0,
                                   max_iterations=k, m=m)
                coll.COUNTS.clear()
                fused.reset_counts()
                evals[0] = 0
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = lt.minimize_sharded(
                    local_fun_and_grad=make_fg(group), x0=x0, params=p,
                    mesh=group, history_dtype=hdt, device=dev)
                torch.cuda.synchronize()
                secs[k] = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
                per_site = {s: v / k for s, v in sorted(coll.COUNTS.items())}
                ev = evals[0]
                if int(res.niter) != k or not bool(torch.isfinite(res.fx)):
                    raise AssertionError(f"sharded logreg: niter "
                                         f"{int(res.niter)}, fx "
                                         f"{float(res.fx)}")
            per_iter = (secs[k2] - secs[k1]) / (k2 - k1)
            # the history's bytes an iteration moves (phase 20's count)
            # and the design matrix's: each evaluation writes and reads
            # every chunk twice (value and gradient passes)
            hist_bytes = 2 * (2 * m) * n * size + (2 * m) * n * size + \
                14 * n * 4
            a_bytes = 2 * 2 * rows * n * 4 * ev / k2
            bw = main_state.get("bandwidth", HBM_BYTES_PER_S)
            plain = tlbfgs._build_solver(
                make_fg(None), lt.LBFGSParams(epsilon=0.0, epsilon_rel=0.0,
                                              max_iterations=k2, m=m),
                history_dtype=hdt, device=dev)
            ref = plain.finalize(plain.run(plain.init(x0[None])))
            same = torch.equal(res.x, ref.x[0]) and \
                int(res.niter) == int(ref.niter[0]) and \
                torch.equal(res.fx, ref.fx[0])
            _log(f"   n=2^27 logreg, {label} rows: {secs[k1]:.3f} s for {k1}"
                 f" and {secs[k2]:.3f} s for {k2} iterations -> "
                 f"{per_iter:.4f} s/iteration; {ev / k2:.2f} evaluations "
                 f"per iteration; ~{(hist_bytes + a_bytes) / 1e9:.2f} GB "
                 f"per iteration (history {hist_bytes / 1e9:.2f}, design "
                 f"matrix {a_bytes / 1e9:.2f}) = "
                 f"{(hist_bytes + a_bytes) / per_iter / bw:.1%} of the "
                 f"measured bandwidth; peak memory {peak / 1e9:.2f} GB; "
                 f"all-reduces per iteration by site {per_site}; the "
                 f"direction's route {dict(fused.two_loop.plain_reasons)}; "
                 f"bit-identical to the unsharded solve: {same}")
            if not same:
                raise AssertionError(f"{label}: the sharded solve on one "
                                     f"rank differs from the unsharded one")
            split_state[f"logreg_{label}"] = per_iter
            del res, ref
            torch.cuda.empty_cache()

    if "group" in split_state:
        smoke.phase("the feature-split logistic regression at n = 2^27",
                    sharded_logreg)

    # 24 --------------------------------------------------------------
    def two_ranks_on_one_card():
        """sharded_cases.chip_cases at n = 2^20, f64, on two gloo ranks
        whose tensors are on the card, against the same cases on the
        parent's NCCL group of one."""
        t0 = time.perf_counter()
        ranks = spawn_ranks.run(
            "lbfgspp_tpu_torch.tools.sharded_cases:chip_cases", 2,
            args=(SPLIT_N, "cuda"), backend="gloo", timeout=SPLIT_TIMEOUT)
        t1 = time.perf_counter()
        one = spawn_ranks.to_numpy(sharded_cases.chip_cases(SPLIT_N,
                                                            "cuda"))
        t2 = time.perf_counter()
        _log(f"   two gloo ranks {t1 - t0:.1f} s (process start "
             f"included), one NCCL rank {t2 - t1:.1f} s")
        problems = []
        for name, budget in AUDIT_BUDGET.items():
            want, got = one[name], [r[name] for r in ranks]
            if name == "implicit":      # the hypergradient, replicated
                x2, x1 = got[0]["grad"], want["grad"]
                counts = {**got[0]["forward"], **got[0]["backward"]}
            else:
                x2 = np.concatenate([g["x"] for g in got])
                x1, counts = want["x"], got[0]["counts"]
            err = float(np.abs(x2 - x1).max() / max(np.abs(x1).max(),
                                                    1e-300))
            iters = int(np.asarray(got[0]["niter"]).reshape(-1)[0])
            sites = {s: v for s, v in counts.items()
                     if not s.startswith(OBJECTIVE_SITES)}
            own = {s: v for s, v in counts.items() if s not in sites}
            _log(f"   {name}: niter {iters} (one rank "
                 f"{int(np.asarray(want['niter']).reshape(-1)[0])}); "
                 f"max rel. difference {err:.3e}; solver all-reduce sites "
                 f"{len(sites)} (budget {budget}), calls per iteration "
                 f"{sum(sites.values()) / max(iters, 1):.2f}, the "
                 f"objective's {sum(own.values()) / max(iters, 1):.2f}; "
                 f"walk rounds {got[0].get('walk_rounds', 0)}")
            if iters != int(np.asarray(want["niter"]).reshape(-1)[0]) or \
                    not err <= 1e-8 or len(sites) > budget:
                problems.append(name)
        if problems:
            raise AssertionError(f"two ranks vs one: {problems}")

    if "group" in split_state:
        smoke.phase("feature-split solves on two gloo ranks sharing the "
                    "card", two_ranks_on_one_card)

    # 25 --------------------------------------------------------------
    def mesh_paths():
        """minimize_batched(mesh=) and minimize_b_batched(mesh=) on the
        NCCL group of one: phases 9 and 11 again, bit for bit, with the
        same launches and no collective inside the solves; then the
        sortless walk GCPs on the box recipe without a mesh."""
        from lbfgspp_tpu_torch.ops import cauchy
        group = split_state["group"]
        coll.COUNTS.clear()
        fused.two_loop.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lt.minimize_batched(objectives.rosenbrock, x0s, params,
                                  mesh=group, **recipe)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, counts = fused.two_loop.launches, dict(coll.COUNTS)
        ref = full_state["result"]
        same = all(torch.equal(getattr(res, f), getattr(ref, f)) for f in
                   ("x", "fx", "niter", "nfev", "status"))
        err = (res.x.double() - 1.0).abs().max(dim=1).values
        split_state["mesh_launches"] = launches
        _log(f"   full path, mesh= on one rank: {secs:.3f} s = "
             f"{MAIN_BATCH / secs:.1f} solves/s; bit-identical to phase 9: "
             f"{same}; launches {launches} (phase 9: "
             f"{full_state['launches']}); all-reduces {counts}; every-run "
             f"max|x - 1| {err.max().item():.3e}")
        if not same or launches != full_state["launches"] or \
                not all(s.startswith("batch.") for s in counts) or \
                bool((err > 1e-4).any()):
            raise AssertionError("mesh= full path")
        lb, ub = (torch.full((BOX_N,), v, device=dev) for v in (2.0, 4.0))
        coll.COUNTS.clear()
        fused.two_loop.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lt.minimize_b_batched(objectives.rosenbrock, bx0s, lb, ub,
                                    bparams, gcp="prefix",
                                    polish_iters=BOX_POLISH_ITERS,
                                    mesh=group, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, counts = fused.two_loop.launches, dict(coll.COUNTS)
        ref = box_state["bench"]["res"]
        same = all(torch.equal(getattr(res, f), getattr(ref, f)) for f in
                   ("x", "fx", "niter", "nfev", "status"))
        err = (res.x.double() - xstar_box).abs().max(1).values
        split_state["mesh_box_launches"] = launches
        _log(f"   box recipe, mesh= on one rank: {secs:.3f} s = "
             f"{BOX_BATCH / secs:.1f} box solves/s; bit-identical to phase "
             f"11: {same}; launches {launches} (phase 11: "
             f"{box_state['bench']['launches']}); all-reduces {counts}; "
             f"max|x - (2, 4, ...)| {err.max().item():.3e}")
        if not same or launches != box_state["bench"]["launches"] or \
                not all(s.startswith("batch.") for s in counts) or \
                bool((err > 1e-4).any()):
            raise AssertionError("mesh= box recipe")
        for gcp in ("walk", "walk_chunked", "walk_auto"):
            cauchy.WALK_COUNTS.clear()
            calls = [0]
            fn = cauchy.GCP_IMPLS[gcp]

            def counted(*args, **kwargs):
                calls[0] += 1
                return fn(*args, **kwargs)

            cauchy.GCP_IMPLS[gcp] = counted
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = lt.minimize_b_batched(
                    objectives.rosenbrock, bx0s, lb, ub, bparams, gcp=gcp,
                    polish_iters=BOX_POLISH_ITERS, device=dev)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            finally:
                cauchy.GCP_IMPLS[gcp] = fn
            err = (res.x.double() - xstar_box).abs().max(1).values
            rounds = cauchy.WALK_COUNTS["rounds"]
            _log(f"   box recipe, gcp={gcp}: {secs:.3f} s = "
                 f"{BOX_BATCH / secs:.1f} box solves/s (prefix: "
                 f"{BOX_BATCH / box_state['bench']['seconds'][2]:.1f}); "
                 f"{calls[0]} GCP calls, {rounds} lockstep walk rounds "
                 f"({rounds / max(calls[0], 1):.2f} a call); "
                 f"frac_within_1e-4 {(err <= 1e-4).double().mean().item():.4f}"
                 f", worst {err.max().item():.3e}")
            if bool((err > 1e-4).any()):
                raise AssertionError(f"gcp={gcp}: instances beyond 1e-4")

    if "group" in split_state and "result" in full_state and \
            "bench" in box_state:
        smoke.phase("mesh= batches on an NCCL group of one; the walk "
                    "GCPs on the box recipe", mesh_paths)
    # 26 --------------------------------------------------------------
    native_state = {}

    def native_core():
        """The native core (csrc/native) on the card against its host build
        and the port's batched solvers, then the multistart and the box
        recipe at full width, the builds without multiply-add contraction
        bit for bit between card and host, one host solve through each
        binding, then the 2-D batch x feature composition on four gloo
        ranks sharing the card."""
        from lbfgspp_tpu_torch import lbfgs as tlbfgs
        for line in ptxas_report(cuda_build.build_logs.get("native_batch",
                                                           "")):
            _log("   ptxas:", line)
        f64 = torch.float64
        rng = np.random.default_rng(26)
        problems = []
        mp = lt.LBFGSParams(m=NATIVE_M, max_linesearch=NATIVE_TRIALS,
                            max_iterations=NATIVE_ITERS)
        plans = {"native_lbfgs_batch": native.plan(False, NATIVE_N, mp, dev),
                 "native_lbfgsb_batch": native.plan(True, BOX_N, bparams,
                                                    dev)}
        for name, pl in plans.items():
            _log(f"   {name} plan: one warp per instance, {pl.warps} warps "
                 f"per block, {pl.blocks_per_sm} blocks per SM "
                 f"({pl.warps * pl.blocks_per_sm} instances an SM), the "
                 f"workspace in {pl.placement} memory ({pl.shared_bytes} "
                 f"bytes of shared memory a block)")
        native_state["plans"] = {k: dict(v._asdict(), placement=v.placement)
                                 for k, v in plans.items()}
        # (a) exactness on the builtin quadratic: card = host = plain
        x0 = rng.uniform(-2, 2, (NATIVE_CHECK, NATIVE_N))
        p = lt.LBFGSParams(epsilon=1e-6, max_iterations=NATIVE_ITERS,
                           max_linesearch=NATIVE_TRIALS, m=NATIVE_M)
        err = 0.0
        for ls in native.LS_KINDS:
            card = native.minimize_batch("quadratic", x0, p, ls, device=dev)
            host = native.minimize_batch("quadratic", x0, p, ls,
                                         device="cpu")
            plain = lt.minimize(fun_and_grad=objectives.quadratic_fg,
                                x0=torch.as_tensor(x0, device=dev), params=p,
                                line_search=ls, device=dev)
            same = all(torch.equal(getattr(card, f).cpu(),
                                   getattr(other, f).cpu())
                       for other in (host, plain)
                       for f in ("niter", "nfev", "status"))
            dx = (card.x.cpu() - host.x).abs().max().item()
            dp = (card.x - plain.x).abs().max().item()
            err = max(err, dx)
            _log(f"   quadratic B={NATIVE_CHECK} n={NATIVE_N} {ls}: counts "
                 f"and statuses equal to the host build and the plain "
                 f"batched solve: {same}; max|x - host| {dx:.3e}, max|x - "
                 f"plain| {dp:.3e}; iterations "
                 f"{dict(collections.Counter(card.niter.tolist()))}")
            if not same or dx > 1e-12 or dp > 1e-12:
                problems.append(f"quadratic {ls}")
        native_state["max_abs_err"] = err
        # (b) the anchor on the card
        res = native.minimize("rosenbrock", torch.zeros(10),
                              lt.LBFGSParams(epsilon=1e-6, max_iterations=100),
                              device=dev)
        _log(f"   rosenbrock n=10 from 0 on the card: {res.niter.item()} "
             f"iterations, fx {res.fx.item():.3e}, status "
             f"{res.status.item()} (anchor: 22, fx <= 1e-12)")
        if res.niter.item() != 22 or res.fx.item() > 1e-12 or \
                res.x.device.type != dev.type:
            problems.append("anchor")
        # (c) random boxes through the box kernel's launcher against the
        # host build.  The warp sums in another order than the host, and
        # nvcc and g++ each contract multiply-adds into FMAs in their own
        # places, so the default builds part in the last bits; these
        # solves stop at ~1e-5 projected gradient or a 1e-10 relative
        # change of fx, and the parted rounding moves x along Rosenbrock's
        # flat valleys at an unchanged fx: the statuses equal and fx to
        # 1e-6 relative, x counted.  The card's build without contraction
        # (nvcc -fmad=false) must equal the host's Lanes build without
        # contraction (g++ -ffp-contract=off) bit for bit.
        lb = rng.uniform(-2, 1, (NATIVE_CHECK, 10))
        ub = lb + rng.uniform(0.1, 3, (NATIVE_CHECK, 10))
        xb = np.clip(rng.uniform(-2, 2, (NATIVE_CHECK, 10)), lb, ub)
        bp = lt.LBFGSBParams(max_iterations=200)

        def box_pair(contract):
            """(card, host): the host's Serial build, or without contraction
            its Lanes build."""
            xs, xh = torch.tensor(xb, device=dev), torch.tensor(xb)
            out = native.native_lbfgsb_batch(
                "rosenbrock", xs, torch.tensor(lb, device=dev),
                torch.tensor(ub, device=dev), bp, contract=contract)
            host = native.native_lbfgsb_batch if contract else \
                native._lanes_b_batch
            oh = host("rosenbrock", xh, torch.tensor(lb), torch.tensor(ub),
                      bp)
            return (xs, out), (xh, oh)

        (xc, oc), (xh, oh) = box_pair(True)
        xc = xc.cpu()
        dx = (xc - xh).abs().max(1).values
        rel = ((oc.fx.cpu() - oh.fx).abs() / oh.fx.abs().clamp(min=1e-300))
        st = torch.equal(oc.status.cpu(), oh.status)
        native_state["box_max_abs_err"] = dx.max().item()
        _log(f"   random boxes B={NATIVE_CHECK} n=10: statuses equal {st} "
             f"({dict(collections.Counter(oh.status.tolist()))}); "
             f"iterations equal on {(oc.niter.cpu() == oh.niter).sum().item()}"
             f"; x within 1e-8 of the host on {(dx <= 1e-8).sum().item()}, "
             f"max|dx| {dx.max().item():.3e}; max relative |dfx| "
             f"{rel.max().item():.3e}")
        if not st or rel.max().item() > 1e-6 or \
                not torch.isfinite(xc).all():
            problems.append("random boxes")
        (xc, oc), (xh, oh) = box_pair(False)
        same = bitwise(xc, oc, xh, oh)
        _log(f"   random boxes without contraction: card = Lanes host build "
             f"bit for bit {same} (x, fx, gnorm, niter, nfev, status)")
        if not same:
            problems.append("random boxes without contraction")
        # (d) the multistart at full width, each search, in turns: the
        # kernel, the host build on every core, the port's batched solve
        X0 = np.random.default_rng(0).uniform(-2, 2, (NATIVE_BATCH, NATIVE_N))
        native.reset_counts()
        runs = {}
        for ls in native.LS_KINDS:
            xs = torch.as_tensor(X0, device=dev).clone()
            ms, out = event_ms(torch, lambda: native.native_lbfgs_batch(
                "rosenbrock", xs, mp, ls))
            xh = torch.as_tensor(X0).clone()
            t0 = time.perf_counter()
            oh = native.native_lbfgs_batch("rosenbrock", xh, mp, ls)
            host_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = lt.minimize(fun_and_grad=objectives.rosenbrock_fg,
                                x0=torch.as_tensor(X0, device=dev), params=mp,
                                line_search=ls, device=dev)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            fr = [frac_within(x, 1e-4) for x in (xs, xh, plain.x)]
            runs[ls] = dict(ms=ms, plain_ms=plain_s * 1e3, out=out,
                            host_niter=oh.niter)
            _log(f"   multistart {ls}: kernel {ms:.2f} ms = "
                 f"{NATIVE_BATCH / ms * 1e3:.1f} solves/s; host build on "
                 f"{os.cpu_count()} cores {host_s:.3f} s = "
                 f"{NATIVE_BATCH / host_s:.1f} solves/s; the port's batched "
                 f"lbfgs.minimize {plain_s:.3f} s = "
                 f"{NATIVE_BATCH / plain_s:.1f} solves/s; frac_within_1e-4 "
                 f"kernel / host / batched {fr[0]:.4f} / {fr[1]:.4f} / "
                 f"{fr[2]:.4f}; statuses kernel "
                 f"{dict(collections.Counter(out.status.tolist()))}, host "
                 f"{dict(collections.Counter(oh.status.tolist()))}, batched "
                 f"{dict(collections.Counter(plain.status.tolist()))}; mean "
                 f"iterations {out.niter.double().mean().item():.1f}, "
                 f"evaluations {out.nfev.double().mean().item():.1f}")
            if not torch.isfinite(xs).all() or abs(fr[0] - fr[1]) > 0.004:
                problems.append(f"multistart {ls}")
        # (e) the box recipe's shape (phase 11's starts, params) in f64
        bxs = bx0s.to(f64).clone()
        blo, bhi = torch.full_like(bxs, 2.0), torch.full_like(bxs, 4.0)
        bms, bout = event_ms(torch, lambda: native.native_lbfgsb_batch(
            "rosenbrock", bxs, blo, bhi, bparams))
        launches = (native.native_lbfgs_batch.launches,
                    native.native_lbfgsb_batch.launches)
        berr = (bxs - xstar_box).abs().max(1).values
        bhost = bx0s.to(f64).cpu().clone()
        native.native_lbfgsb_batch("rosenbrock", bhost, blo.cpu(),
                                   bhi.cpu(), bparams)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bplain = lt.minimize_b(fun_and_grad=objectives.rosenbrock_fg,
                               x0=bx0s.to(f64), lb=2.0, ub=4.0,
                               params=bparams, gcp="scan", device=dev)
        torch.cuda.synchronize()
        bplain_ms = (time.perf_counter() - t0) * 1e3
        phase11 = BOX_BATCH / box_state["bench"]["seconds"][0] \
            if "bench" in box_state else float("nan")
        _log(f"   box recipe B={BOX_BATCH} n={BOX_N} f64 through "
             f"native_lbfgsb_batch: {bms:.2f} ms = "
             f"{BOX_BATCH / bms * 1e3:.1f} box solves/s (phase 11's box "
             f"solve: {phase11:.1f}; lbfgsb.minimize(gcp='scan') on the "
             f"card {bplain_ms:.1f} ms); frac_within_1e-4 "
             f"{(berr <= 1e-4).double().mean().item():.4f}, worst "
             f"{berr.max().item():.3e}; max|x - host| "
             f"{(bxs.cpu() - bhost).abs().max().item():.3e}; statuses "
             f"{dict(collections.Counter(bout.status.tolist()))}")
        if bool((berr > 1e-4).any()):
            problems.append("box recipe")
        _log(f"   launches on the main path: native_lbfgs_batch "
             f"{launches[0]}, native_lbfgsb_batch {launches[1]}")
        if launches != (len(native.LS_KINDS), 1):
            problems.append(f"launches {launches}")
        nw = runs["nocedalwright"]
        bound, by = native_bound(
            nw["out"].niter, nw["out"].nfev, NATIVE_N, NATIVE_M, 6,
            NATIVE_BATCH * (2 * NATIVE_N * 8 + 28))
        bbound, bby = native_bound(
            bout.niter, bout.nfev, BOX_N, bparams.m, 6,
            BOX_BATCH * (4 * BOX_N * 8 + 28), box=True)
        native_state.update(
            launches=launches, ms=nw["ms"], plain_ms=nw["plain_ms"],
            bound_ms=bound, bound_by=by,
            ms_by_search={k: v["ms"] for k, v in runs.items()},
            plain_ms_by_search={k: v["plain_ms"] for k, v in runs.items()},
            box_ms=bms, box_plain_ms=bplain_ms, box_bound_ms=bbound,
            box_bound_by=bby)
        _log(f"   nocedalwright kernel {nw['ms']:.2f} ms against its bound "
             f"{bound:.4f} ms ({by}; {bound / nw['ms']:.3%}); box kernel "
             f"{bms:.2f} ms against {bbound:.4f} ms ({bby}; "
             f"{bbound / bms:.3%})")
        # (f) the builds without contraction at the main shape: the
        # multistart of each search and the box recipe's starts, card =
        # the host's Lanes build bit for bit per instance (after the
        # counted run: these launches are comparisons)
        for ls in native.LS_KINDS:
            xs = torch.as_tensor(X0, device=dev).clone()
            xh = torch.as_tensor(X0).clone()
            out = native.native_lbfgs_batch("rosenbrock", xs, mp, ls,
                                            contract=False)
            oh = native._lanes_batch("rosenbrock", xh, mp, ls)
            same = bitwise(xs, out, xh, oh)
            eq = runs[ls]["out"].niter.cpu() == runs[ls]["host_niter"]
            _log(f"   multistart {ls} without contraction: card = Lanes host "
                 f"build bit for bit on all {NATIVE_BATCH} instances {same}"
                 f"; frac_within_1e-4 {frac_within(xs, 1e-4):.4f}; the "
                 f"default builds' niter equal to the Serial host's on "
                 f"{eq.sum().item()}")
            if not same:
                problems.append(f"multistart {ls} without contraction")
        bxs, bhost = bx0s.to(f64).clone(), bx0s.to(f64).cpu().clone()
        same = bitwise(
            bxs, native.native_lbfgsb_batch("rosenbrock", bxs, blo, bhi,
                                            bparams, contract=False),
            bhost, native._lanes_b_batch("rosenbrock", bhost, blo.cpu(),
                                         bhi.cpu(), bparams))
        _log(f"   box recipe without contraction: card = Lanes host build "
             f"bit for bit {same}")
        if not same:
            problems.append("box recipe without contraction")
        native_state["bit_identical_without_contraction"] = not any(
            "without contraction" in q for q in problems)
        # (g) the host's single builtin solve through its two bindings:
        # the CPython one (fastcall.cpp) and ctypes, alternated
        one = lt.LBFGSParams(epsilon=1e-6, max_iterations=100)
        x10, cp1 = torch.zeros(10, dtype=f64), native._cparams(one)
        fast = native._fast()
        times = {"fastcall": [], "ctypes": []}
        for _ in range(NATIVE_LATENCY_REPS):
            x10.zero_()
            t0 = time.perf_counter_ns()
            fast.minimize(0, x10.numpy(), ctypes.addressof(cp1), 2)
            times["fastcall"].append(time.perf_counter_ns() - t0)
            x10.zero_()
            t0 = time.perf_counter_ns()
            native._ctypes_minimize("rosenbrock", x10, one, "nocedalwright")
            times["ctypes"].append(time.perf_counter_ns() - t0)
        med = {k: sorted(v)[len(v) // 2] / 1e3 for k, v in times.items()}
        _log(f"   one host solve (rosenbrock n=10 from 0, 22 iterations), "
             f"median of {NATIVE_LATENCY_REPS}: fastcall {med['fastcall']:.2f}"
             f" us, ctypes {med['ctypes']:.2f} us")
        # (h) the 2-D batch x feature composition, four gloo ranks
        d2 = np.random.default_rng(0).uniform(-2.0, 2.0, (MESH2D_B, MESH2D_N))
        x2 = np.zeros((MESH2D_B, MESH2D_N))
        p2 = dict(epsilon=1e-10, max_iterations=60)
        t0 = time.perf_counter()
        ranks = spawn_ranks.run(
            "lbfgspp_tpu_torch.tools.sharded_cases:mesh_2d", 4,
            args=(d2, x2, p2, 2, dev.type), backend="gloo",
            timeout=MESH2D_TIMEOUT)
        d2t = torch.as_tensor(d2, device=dev)
        one = tlbfgs._build_solver(
            lambda x: sharded_cases.weighted(x, d2t), lt.LBFGSParams(**p2),
            device=dev)
        ref = one.finalize(one.run(one.init(torch.as_tensor(x2,
                                                             device=dev))))
        worst, same = 0.0, True
        for r in ranks:
            (lo, hi), (c0, c1) = r["rows"], r["cols"]
            want = ref.x[lo:hi, c0:c1].cpu().numpy()
            worst = max(worst, float(np.abs(r["x"] - want).max()))
            same &= np.array_equal(r["niter"], ref.niter[lo:hi].cpu())
        _log(f"   2 batch blocks x 2 feature shards on four gloo ranks "
             f"({time.perf_counter() - t0:.1f} s, the ranks' start "
             f"included): niter equal {same}, max|x - single| {worst:.3e}")
        if not same or worst > 1e-12:
            problems.append("2-D composition")
        if problems:
            raise AssertionError(f"native core: {problems}")

    smoke.phase("the native core on the card; the 2-D batch x feature "
                "composition", native_core)
    if dist.is_initialized():
        dist.destroy_process_group()

    if smoke.failures:
        return smoke.fail()

    rows = smoke.kernel_rows
    kernel = {
        "name": "two_loop",
        "route": "cuda",
        "source": "lbfgspp_tpu_torch/csrc/two_loop.cu",
        "replaces": "lbfgspp_tpu/ops/fused.py:111",
        # the full three-phase path's launches (phase 9)
        "launches": full_state["launches"],
        "max_abs_err": rows["max_abs_err"],
        "ms": rows["ms"],
        "plain_ms": rows["plain_ms"],
        "bound_ms": rows["bound_ms"],
        "bound_by": rows["bound_by"],
        "library_ms": None,     # no single PyTorch call computes a*H*v
        "main_phase_launches": main_state["launches"],
        "ms_f64": rows["ms_f64"],
        "bound_ms_f64": rows["bound_ms_f64"],
        "sweeps_ms": rows["sweeps_ms"],
        "simple_ms": rows["simple_ms"],
        "pair_max_abs_err": rows["pair_max_abs_err"],
    }
    for label in ("polish", "deep", "box"):
        for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
            kernel[f"{label}_shape_{key}"] = rows[f"{label}_shape_{key}"]
    kernel["box_max_abs_err"] = rows["box_max_abs_err"]
    # the box path's launches: the bench recipe's polish takes no L-BFGS
    # step (every coordinate pinned), the free-x[2] variant's takes some
    kernel["box_path_launches"] = box_state["bench"]["launches"]
    kernel["box_free_path_launches"] = box_state["free x[2]"]["launches"]
    # the solver families: the kernel's time at their shapes (phase 14)
    # and its launches on their paths (phases 15-17)
    for label in ("owlqn", "owlqn_pair", "stochastic"):
        for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
            kernel[f"{label}_shape_{key}"] = rows[f"{label}_shape_{key}"]
    kernel["owlqn_launches"] = owl_state["a launches"]
    kernel["owlqn_fast_phase_launches"] = owl_state["b launches"]
    kernel["owlqn_polish_launches"] = owl_state["c launches"]
    kernel["stochastic_launches"] = stoch_state["launches"]
    kernel["implicit_launches"] = imp_state["launches"]
    # the mesh= paths on the NCCL group of one (phase 25): the full path's
    # and the box recipe's launches, equal to phases 9 and 11
    kernel["mesh_launches"] = split_state["mesh_launches"]
    kernel["mesh_box_launches"] = split_state["mesh_box_launches"]
    # The bf16 instantiations of the same kernel (phases 18-19): launches
    # on their main paths (the bf16-row main phase, the all-bf16 run),
    # error and times at the main shape in rinv mode.
    modes = []
    for kind, what in (("bf16rows", "bf16 rows, f32 operands"),
                       ("bf16", "all bf16, the Pallas kernel's bf16 mode")):
        modes.append({
            "name": f"two_loop_{kind}",
            "route": "cuda",
            "source": "lbfgspp_tpu_torch/csrc/two_loop.cu",
            "replaces": "lbfgspp_tpu/ops/fused.py:111",
            "launches": bf16_state[f"{kind} launches"],
            "max_abs_err": rows[f"{kind}_max_abs_err"],
            "ms": rows[f"{kind}_ms"],
            "plain_ms": rows[f"{kind}_plain_ms"],
            "bound_ms": rows[f"{kind}_bound_ms"],
            "bound_by": rows[f"{kind}_bound_by"],
            "library_ms": None,
            "types": what,
            "sweeps_ms": rows[f"{kind}_sweeps_ms"],
        })
    # The native core's two kernels (phase 26): not TPU kernels; they
    # replace the JAX package's host C++ solves.
    ns = native_state
    natives = [{
        "name": "native_lbfgs_batch",
        "route": "cuda",
        "source": "lbfgspp_tpu_torch/csrc/native/batch.cu",
        "replaces": "lbfgspp_tpu/native/core.cpp:575",
        "kind": "host C++ solve of the JAX package, not a TPU kernel",
        "launches": ns["launches"][0],
        "max_abs_err": ns["max_abs_err"],
        "ms": ns["ms"],
        "plain_ms": ns["plain_ms"],
        "bound_ms": ns["bound_ms"],
        "bound_by": ns["bound_by"],
        "library_ms": None,     # no PyTorch call computes a solve
        "bit_identical_without_contraction":
            ns["bit_identical_without_contraction"],
        "ms_by_search": ns["ms_by_search"],
        "plain_ms_by_search": ns["plain_ms_by_search"],
        "plan": ns["plans"]["native_lbfgs_batch"],
    }, {
        "name": "native_lbfgsb_batch",
        "route": "cuda",
        "source": "lbfgspp_tpu_torch/csrc/native/batch.cu",
        "replaces": "lbfgspp_tpu/native/lbfgsb.cpp:606",
        "kind": "host C++ solve of the JAX package, not a TPU kernel",
        "launches": ns["launches"][1],
        "max_abs_err": ns["box_max_abs_err"],
        "ms": ns["box_ms"],
        "plain_ms": ns["box_plain_ms"],
        "bound_ms": ns["box_bound_ms"],
        "bound_by": ns["box_bound_by"],
        "library_ms": None,
        "bit_identical_without_contraction":
            ns["bit_identical_without_contraction"],
        "plan": ns["plans"]["native_lbfgsb_batch"],
    }]
    print(card_line())
    print(json.dumps({"kernels": [kernel] + modes + natives}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
