#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it does.

    python3 chip_smoke.py

Phases (any failure makes the script exit 1 and print no result):

1. build the CUDA two-loop kernel from ``lbfgspp_tpu_torch/csrc`` (nvcc,
   sm_90a) and print its register/spill report;
2. hold the kernel against its plain PyTorch version in float and double,
   in ``sweeps`` and ``rinv`` mode, at the main path's shape (B=4096, m=16,
   n=100) and at odd shapes (mixed fill levels with empty and wrapped
   rings, m=1, m=33);
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
   each) beside its memory bound and the plain version's time;
6. profile 20 iterations of the main phase (``torch.profiler``): host ms,
   eager ops and kernel launches per iteration, device busy time and
   idle share, and the top kernels and operators.

The last lines are the card's name and power limit (nvidia-smi), a JSON
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
PROFILE_WARMUP, PROFILE_ITERS = 10, 20

MAIN_BATCH, MAIN_N, MAIN_M = 4096, 100, 16
MAIN_ITERS = 162
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
        from lbfgspp_tpu_torch.ops import fused, history
        from lbfgspp_tpu_torch.utils import cuda_build, objectives
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
        for line in cuda_build.build_logs.get("two_loop", "").splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                _log("   ptxas:", line.strip())

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
                for mode in ("sweeps", "rinv"):
                    got = fused.two_loop(*kernel_args(h, v), -1.0, mode)
                    want = fused.two_loop_plain(*kernel_args(h, v), -1.0,
                                                mode)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    scale = want.abs().max().item()
                    ok = err <= tolerances[dtype] * scale
                    _log(f"   {label:14s} B={batch:5d} m={m:2d} n={n:3d} "
                         f"{str(dtype)[6:]:8s} {mode:6s} max_abs_err="
                         f"{err:.3e} (scale {scale:.3e}) "
                         f"{'ok' if ok else 'TOO LARGE'}")
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
        h = res.history
        v = res.grad.contiguous()
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

        def median_ms(fn):
            fn()
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

        # The real state: the kernel must be no less accurate than the
        # plain version against an f64 evaluation of the same inputs.
        ref = fused.two_loop_plain(*kernel_args(cast(h, torch.float64),
                                                v.double()), -1.0, "rinv")
        k32 = fused.two_loop(*kernel_args(h, v), -1.0, "rinv")
        p32 = fused.two_loop_plain(*kernel_args(h, v), -1.0, "rinv")
        ek = (k32.double() - ref).abs().max().item()
        ep = (p32.double() - ref).abs().max().item()
        _log(f"   main-phase state, f32 rinv: |kernel - f64| {ek:.3e}, "
             f"|plain - f64| {ep:.3e}")
        if not ek <= 4.0 * ep + 1e-6 * ref.abs().max().item():
            raise AssertionError("kernel less accurate than plain on the "
                                 "main-phase state")
        for mode in ("rinv", "sweeps"):
            args = kernel_args(h, v)
            k_ms = median_ms(lambda: fused.two_loop(*args, -1.0, mode))
            p_ms = median_ms(lambda: fused.two_loop_plain(*args, -1.0,
                                                          mode))
            nbytes = two_loop_bytes(h, v, mode)
            flops = two_loop_flops(MAIN_BATCH, MAIN_M, MAIN_N, mode)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS["float32"] * 1e3
            bound = max(t_bytes, t_ops)
            _log(f"   two_loop {mode:6s} B={MAIN_BATCH} m={MAIN_M} "
                 f"n={MAIN_N} f32: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                 f"ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB; "
                 f"{flops / 1e6:.1f} MFLOP = {t_ops:.4f} ms), "
                 f"{bound / k_ms:.1%} of bound")
            if mode == "rinv":
                smoke.kernel_rows.update(
                    ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")

    if "res" in main_state:
        smoke.phase("kernel timing at the main path's shape", timing)
    else:
        smoke.failures.append("kernel timing (no main-phase state)")

    # 6 ---------------------------------------------------------------
    def profile():
        from torch.profiler import ProfilerActivity
        s = lt.solver(objectives.rosenbrock, params, **options)
        state = s.init(x0s)
        for _ in range(PROFILE_WARMUP):
            state = s.step(state)
        torch.cuda.synchronize()
        nfev0 = state.nfev.clone()
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
        kernels = [e for e in events if e.device_type.name == "CUDA"]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        _log(f"   iterations {PROFILE_WARMUP + 1}-{PROFILE_WARMUP + it}, "
             f"profiler on: host {wall / it * 1e3:.3f} ms/iteration, "
             f"{ops / it:.1f} aten ops and "
             f"{sum(e.count for e in kernels) / it:.1f} kernel launches per "
             f"iteration; device busy {busy_ms / it:.3f} ms/iteration, "
             f"idle share {1 - busy_ms / 1e3 / wall:.3f}; objective "
             f"evaluations per instance per iteration mean "
             f"{evals.mean().item():.3f} max {evals.max().item():.3f}")
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

    if smoke.failures:
        _log("FAILED: " + ", ".join(smoke.failures))
        return 1

    kernel = {
        "name": "two_loop",
        "route": "cuda",
        "source": "lbfgspp_tpu_torch/csrc/two_loop.cu",
        "replaces": "lbfgspp_tpu/ops/fused.py:111",
        "launches": main_state["launches"],
        "max_abs_err": smoke.kernel_rows["max_abs_err"],
        "ms": smoke.kernel_rows["ms"],
        "plain_ms": smoke.kernel_rows["plain_ms"],
        "bound_ms": smoke.kernel_rows["bound_ms"],
        "bound_by": smoke.kernel_rows["bound_by"],
        "library_ms": None,     # no single PyTorch call computes a*H*v
    }
    print(card_line())
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
