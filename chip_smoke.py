#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it does.

    python3 chip_smoke.py

Phases (any failure makes the script exit 1 and print no result):

1. build the CUDA two-loop kernels from ``lbfgspp_tpu_torch/csrc`` (nvcc,
   sm_90a), print ptxas's registers and spills for each instantiation and
   the launch plans of the main shape;
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
13. the kernel's error against the same function evaluated in f64 on the
   same f32 inputs, per call and instance, beside ``two_loop_simple``'s
   and the plain version's, at the main shape (every 8th call of the main
   phase), the pair shape (the polish's calls) and the box shape (the box
   polish's calls): the kernel's median and 99th percentile must not
   exceed the plain version's;
14. profile 10 box iterations (``torch.profiler``): host ms, eager ops,
   launches and device-to-host reads per iteration, device busy time and
   idle share.

Phase 5 also times the kernel at the pair shapes beside their bound.  The
last lines are the card's name and power limit (nvidia-smi), a JSON
``kernels`` line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}   # outside tensor cores
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


def two_loop_bytes(h, v, mode) -> int:
    """Bytes one call must move: each input read once, the output written
    once."""
    mats = (h.rinv if mode == "rinv" else h.sy, h.yy)
    ins = (h.s, h.y, h.ys, h.theta, h.ptr, h.ncorr, v) + mats
    return sum(t.numel() * t.element_size() for t in ins) + \
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
            traceback.print_exc(file=sys.stdout)
            self.failures.append(name)
            _log(f"   FAILED: {name}")
        _log(f"   ({time.perf_counter() - t0:.1f} s)")


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
        t0 = time.perf_counter()
        fused.build()
        _log(f"   built two_loop in {time.perf_counter() - t0:.1f} s")
        for line in ptxas_report(cuda_build.build_logs.get("two_loop", "")):
            _log("   ptxas:", line)
        for dtype in (torch.float32, torch.float64):
            plan = fused.launch_plan(MAIN_BATCH, MAIN_M, MAIN_N, dtype,
                                     fused.num_sms(dev))
            _log(f"   plan {str(dtype)[6:]}: {plan}")

    smoke.phase("build the CUDA kernel", build)
    if smoke.failures:
        _log("FAILED: " + ", ".join(smoke.failures))
        return 1

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
                nbytes = two_loop_bytes(h, v, mode)
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
            n2 = v.shape[1]
            k_ms = median_ms(lambda: fused.two_loop(*args, -1.0, "rinv"))
            p_ms = median_ms(lambda: fused.two_loop_plain(*args, -1.0,
                                                          "rinv"))
            nbytes = two_loop_bytes(h, v, "rinv")
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = two_loop_flops(batch, MAIN_M, n2, "rinv") / \
                PEAK_FLOPS["float32"] * 1e3
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            plan = fused.plan_for(*args, "rinv")
            _log(f"   two_loop rinv B={batch} m={MAIN_M} n={n2} float32 "
                 f"({label} shape): kernel {k_ms:.4f} ms ({bound / k_ms:.1%}"
                 f" of bound); plain {p_ms:.4f} ms; bound {bound:.4f} ms by "
                 f"{by} ({nbytes / 1e6:.1f} MB; operations {t_ops:.4f} ms);"
                 f" plan {plan.warps} warps x {plan.stages} stages, grid "
                 f"{plan.grid}, staged {plan.staged}")
            rows.update({f"{label}_shape_ms": k_ms,
                         f"{label}_shape_plain_ms": p_ms,
                         f"{label}_shape_bound_ms": bound,
                         f"{label}_shape_bound_by": by})

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
        full_state.update(launches=launches, main=main,
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
        k_ms = median_ms_of(torch, lambda: fused.two_loop(*args, -1.0,
                                                          "sweeps"), flush)
        p_ms = median_ms_of(torch, lambda: fused.two_loop_plain(
            *args, -1.0, "sweeps"), flush)
        batch, m, n2 = args[0].shape
        nbytes = sum(t.numel() * t.element_size() for t in args
                     if t is not None and t is not args[8]) + \
            args[9].numel() * args[9].element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = two_loop_flops(batch, m, n2, "sweeps") / \
            PEAK_FLOPS["float32"] * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        _log(f"   two_loop sweeps B={batch} m={m} n={n2} float32 (box "
             f"shape): kernel {k_ms:.4f} ms ({bound / k_ms:.1%} of bound); "
             f"plain {p_ms:.4f} ms; bound {bound:.4f} ms by {by} "
             f"({nbytes / 1e6:.2f} MB; operations {t_ops:.5f} ms)")
        smoke.kernel_rows.update(box_shape_ms=k_ms, box_shape_plain_ms=p_ms,
                                 box_shape_bound_ms=bound,
                                 box_shape_bound_by=by)

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

    if smoke.failures:
        _log("FAILED: " + ", ".join(smoke.failures))
        return 1

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
    print(card_line())
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
