#!/usr/bin/env python3
"""The probe of the native kernels on one NVIDIA GPU: what it costs,
whether it changes an answer, and whether its clocks agree with the
profiler's.

    python3 -m lbfgspp_tpu_torch.tools.native_probe_study [--batch 120000] \
        [--reps 5] [--traced 3] [--box]

Builds the card library and prints ptxas's lines for both instantiations
of ``native_lbfgs_batch`` (``--box``: ``native_lbfgsb_batch``) and their
plans.  Then, at the benchmark's multistart shape (``--batch`` Rosenbrock
starts uniform in [-2, 2]^100 from seed 0, m = 6, ``max_linesearch`` 256,
``max_iterations`` 400), for the Nocedal-Wright and the bracketing search,
or with ``--box`` at the box cell's (starts uniform in [2, 4]^10, every
coordinate in [2, 4] but x[2], unbounded; m = 6, epsilon 1e-6,
``max_iterations`` 60): times the default and the probed kernel with CUDA
events, in turns (default, probed, probed, default, ``--reps`` times),
holds the probed outputs bit for bit against the default's, prints each
probed launch's summary as shares (eval, search, direction, other; the
box kernel's Cauchy points and subspace steps besides, inside direction),
slot use and SM clock, and profiles the last launch's occupancy from its
records: the most instances in their slots at once, the mean over the
launch and over its middle half, how long the count took to reach its
most (the ramp) and how long it stayed below the middle's mean at the end
(the tail).  Last, ``--traced`` launches under ``torch.profiler``: the sum
of the probe's launch spans (``%globaltimer``) over the trace's device
time of the kernel (CUPTI's clock), and the host span
``lbfgspp.native.launch``'s mean length.  The last line is a JSON
summary.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from lbfgspp_tpu_torch import LBFGSBParams, LBFGSParams, native
from lbfgspp_tpu_torch.tools.native_study import event_ms, ptxas_lines, \
    same_bits
from lbfgspp_tpu_torch.utils import cuda_build

N, M, TRIALS, ITERS = 100, 6, 256, 400
SEARCHES = ("nocedalwright", "bracketing")
BOX_N, BOX_ITERS, BOX_EPSILON = 10, 60, 1e-6


def shares(rec: dict) -> dict:
    """A summary's phase shares, slot use (%) and SM clock (GHz)."""
    out = {k: 100.0 * rec[k] / rec["total"]
           for k in ("eval", "search", "direction")}
    out["other"] = 100.0 - sum(out.values())
    for k in ("cauchy", "subspace"):
        if k in rec:
            out[k] = 100.0 * rec[k] / rec["total"]
    out["slot_use"] = 100.0 * rec["busy_ns"] / (rec["slots"] *
                                                rec["span_ns"])
    out["sm_ghz"] = rec["total"] / rec["busy_ns"]
    return out


def occupancy(probe: torch.Tensor) -> dict:
    """The instances in their slots over a launch, from its records
    ``[B, 6]``: the most at once, the time-weighted mean over the launch
    and over its middle half (``steady``), the ramp (ms from the first
    start to the first time at the most) and the tail (ms from the last
    time at or above the steady mean to the last end)."""
    rec = probe.cpu()
    t = torch.cat([rec[:, 0], rec[:, 1]])
    step = torch.cat([torch.ones(len(rec), dtype=torch.int64),
                      -torch.ones(len(rec), dtype=torch.int64)])
    order = torch.argsort(t * 2 + (step > 0), stable=True)  # ends first
    t, active = t[order], torch.cumsum(step[order], 0)
    lo, hi = int(t[0]), int(t[-1])

    def mean(a: int, b: int) -> float:
        """active over [a, b): active[i] holds from t[i] to t[i + 1]."""
        dwell = (t[1:].clamp(a, b) - t[:-1].clamp(a, b)).double()
        return float((active[:-1].double() * dwell).sum()) / (b - a)

    most = int(active.max())
    steady = mean(lo + (hi - lo) // 4, lo + 3 * (hi - lo) // 4)
    last = (active >= steady).nonzero().flatten()[-1]
    return dict(most=most, mean=mean(lo, hi), steady=steady,
                ramp_ms=(int(t[(active == most).nonzero()[0, 0]]) - lo) / 1e6,
                tail_ms=(hi - int(t[last])) / 1e6)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def kernel_device_s(prof, kernel: str) -> float:
    """The trace's device time of ``kernel``, seconds."""
    total = 0.0
    for e in prof.key_averages():
        if kernel in e.key:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
    return total / 1e6


def _cases(box: bool, batch: int, dev):
    """The study's launches: ``(params, {label: (run(xs), traced(x0))},
    starts)``, ``run`` the kernel's wrapper on ``xs`` in place and
    ``traced`` the public batch call."""
    if not box:
        p = LBFGSParams(m=M, max_linesearch=TRIALS, max_iterations=ITERS)
        x0 = torch.as_tensor(np.random.default_rng(0).uniform(
            -2, 2, (batch, N)), device=dev)
        return p, {ls: (
            lambda xs, ls=ls: native.native_lbfgs_batch("rosenbrock", xs, p,
                                                        ls),
            lambda x0, ls=ls: native.minimize_batch("rosenbrock", x0, p, ls,
                                                    device=dev))
            for ls in SEARCHES}, x0
    p = LBFGSBParams(m=M, epsilon=BOX_EPSILON, max_iterations=BOX_ITERS)
    lo = torch.full((BOX_N,), 2.0, dtype=torch.float64, device=dev)
    hi = torch.full_like(lo, 4.0)
    lo[2], hi[2] = -np.inf, np.inf
    lb, ub = (t.expand(batch, BOX_N).contiguous() for t in (lo, hi))
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(
        2, 4, (batch, BOX_N)), device=dev)
    return p, {"box": (
        lambda xs: native.native_lbfgsb_batch("rosenbrock", xs, lb, ub, p),
        lambda x0: native.minimize_b_batch("rosenbrock", x0, lo, hi, p,
                                           device=dev))}, x0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=120000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--traced", type=int, default=3)
    ap.add_argument("--box", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("native_probe_study needs an NVIDIA GPU")
    dev = torch.device("cuda")
    kernel = "native_lbfgsb_batch" if args.box else "native_lbfgs_batch"
    print(f"{card_line()}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    native.build(dev)
    for line in ptxas_lines(cuda_build.build_logs.get("native_batch", "")):
        if kernel in line:
            print(f"ptxas {line}", flush=True)
    p, cases, x0 = _cases(args.box, args.batch, dev)
    plans = {k: native.plan(args.box, x0.shape[1], p, dev,
                            probed=k == "probed")
             for k in ("default", "probed")}
    print(f"plans {plans}", flush=True)
    summary = dict(device=card_line(), batch=args.batch,
                   plans={k: list(v) for k, v in plans.items()})

    for label, (launch, traced_call) in cases.items():
        def run(probed):
            xs = x0.clone()
            out = []
            with native.probing(probed):
                ms = event_ms(lambda: out.append(launch(xs)))
            return ms, xs, out[0]

        run(False)
        run(True)
        native.reset_counts()
        times = {"default": [], "probed": []}
        for _ in range(args.reps):
            for probed in (False, True, True, False):
                times["probed" if probed else "default"].append(
                    run(probed)[0])
        recs = native.probe_records()
        _, xd, od = run(False)
        _, xp, op = run(True)
        bits = same_bits(xd, od, xp, op)
        occ = occupancy(native._probe_buffer(args.batch, xp.device,
                                             args.box))
        med = {k: statistics.median(v) for k, v in times.items()}
        cost = 100.0 * (med["probed"] / med["default"] - 1.0)
        per = [shares(r) for r in recs]
        print(f"{label}: kernel ms default {times['default']} probed "
              f"{times['probed']}; medians {med}; probe cost {cost:+.3f}%; "
              f"probed = default bit for bit {bits}", flush=True)
        for r, s in zip(recs, per):
            print(f"{label}: record {r} -> " + ", ".join(
                f"{k} {v:.4f}" for k, v in s.items()), flush=True)
        print(f"{label}: occupancy of {recs[0]['slots']} slots: {occ}",
              flush=True)

        native.reset_counts()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.traced):
                traced_call(x0)
            torch.cuda.synchronize()
        traced = native.probe_records()
        span_s = sum(r["span_ns"] for r in traced) / 1e9
        dev_s = kernel_device_s(prof, kernel)
        host_ms = statistics.mean(r["host_ns"] for r in traced) / 1e6
        print(f"{label}: traced {len(traced)} launches: probe spans "
              f"{span_s!r} s, trace's {kernel} {dev_s!r} s, ratio "
              f"{100.0 * span_s / dev_s:.3f}%; host span mean "
              f"{host_ms!r} ms", flush=True)
        summary[label] = dict(
            ms=med, cost_pct=cost, bits=bits, occupancy=occ,
            shares={k: statistics.median(s[k] for s in per) for k in per[0]},
            clocks_pct=100.0 * span_s / dev_s, host_ms=host_ms)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
