#!/usr/bin/env python3
"""The probe of ``native_lbfgs_batch`` on one NVIDIA GPU: what it costs,
whether it changes an answer, and whether its clocks agree with the
profiler's.

    python3 -m lbfgspp_tpu_torch.tools.native_probe_study [--batch 120000] \
        [--reps 5] [--traced 3]

Builds the card library and prints ptxas's lines for both instantiations
of ``native_lbfgs_batch`` and their plans.  Then, at the benchmark's
multistart shape (``--batch`` Rosenbrock starts uniform in [-2, 2]^100
from seed 0, m = 6, ``max_linesearch`` 256, ``max_iterations`` 400), for
the Nocedal-Wright and the bracketing search: times the default and the
probed kernel with CUDA events, in turns (default, probed, probed,
default, ``--reps`` times), holds the probed outputs bit for bit against
the default's, prints each probed launch's summary as shares (eval,
search, direction, other), slot use and SM clock, and profiles the last
launch's occupancy from its records: the most instances in their slots
at once, the mean over the launch and over its middle half, how long the
count took to reach its most (the ramp) and how long it stayed below the
middle's mean at the end (the tail).
Last, ``--traced`` launches under ``torch.profiler``: the sum of the
probe's launch spans (``%globaltimer``) over the trace's device time of
the kernel (CUPTI's clock), and the host span ``lbfgspp.native.launch``'s
mean length.  The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from lbfgspp_tpu_torch import LBFGSParams, native
from lbfgspp_tpu_torch.tools.native_study import event_ms, ptxas_lines, \
    same_bits
from lbfgspp_tpu_torch.utils import cuda_build

N, M, TRIALS, ITERS = 100, 6, 256, 400
SEARCHES = ("nocedalwright", "bracketing")
KERNEL = "native_lbfgs_batch"


def shares(rec: dict) -> dict:
    """A summary's phase shares, slot use (%) and SM clock (GHz)."""
    out = {k: 100.0 * rec[k] / rec["total"]
           for k in ("eval", "search", "direction")}
    out["other"] = 100.0 - sum(out.values())
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


def kernel_device_s(prof) -> float:
    """The trace's device time of the kernel, seconds."""
    total = 0.0
    for e in prof.key_averages():
        if KERNEL in e.key:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
    return total / 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=120000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--traced", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("native_probe_study needs an NVIDIA GPU")
    dev = torch.device("cuda")
    print(f"{card_line()}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    native.build(dev)
    for line in ptxas_lines(cuda_build.build_logs.get("native_batch", "")):
        if KERNEL in line:
            print(f"ptxas {line}", flush=True)
    p = LBFGSParams(m=M, max_linesearch=TRIALS, max_iterations=ITERS)
    plans = {k: native.plan(False, N, p, dev, probed=k == "probed")
             for k in ("default", "probed")}
    print(f"plans {plans}", flush=True)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(
        -2, 2, (args.batch, N)), device=dev)
    summary = dict(device=card_line(), batch=args.batch,
                   plans={k: list(v) for k, v in plans.items()})

    def run(ls, probed):
        xs = x0.clone()
        out = []
        with native.probing(probed):
            ms = event_ms(lambda: out.append(
                native.native_lbfgs_batch("rosenbrock", xs, p, ls)))
        return ms, xs, out[0]

    for ls in SEARCHES:
        run(ls, False)
        run(ls, True)
        native.reset_counts()
        times = {"default": [], "probed": []}
        for _ in range(args.reps):
            for probed in (False, True, True, False):
                times["probed" if probed else "default"].append(
                    run(ls, probed)[0])
        recs = native.probe_records()
        _, xd, od = run(ls, False)
        _, xp, op = run(ls, True)
        bits = same_bits(xd, od, xp, op)
        occ = occupancy(native._probe_buffer(args.batch, xp.device))
        med = {k: statistics.median(v) for k, v in times.items()}
        cost = 100.0 * (med["probed"] / med["default"] - 1.0)
        per = [shares(r) for r in recs]
        print(f"{ls}: kernel ms default {times['default']} probed "
              f"{times['probed']}; medians {med}; probe cost {cost:+.3f}%; "
              f"probed = default bit for bit {bits}", flush=True)
        for r, s in zip(recs, per):
            print(f"{ls}: record {r} -> " + ", ".join(
                f"{k} {v:.4f}" for k, v in s.items()), flush=True)
        print(f"{ls}: occupancy of {recs[0]['slots']} slots: {occ}",
              flush=True)

        native.reset_counts()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.traced):
                native.minimize_batch("rosenbrock", x0, p, ls, device=dev)
            torch.cuda.synchronize()
        traced = native.probe_records()
        span_s = sum(r["span_ns"] for r in traced) / 1e9
        dev_s = kernel_device_s(prof)
        host_ms = statistics.mean(r["host_ns"] for r in traced) / 1e6
        print(f"{ls}: traced {len(traced)} launches: probe spans "
              f"{span_s!r} s, trace's {KERNEL} {dev_s!r} s, ratio "
              f"{100.0 * span_s / dev_s:.3f}%; host span mean "
              f"{host_ms!r} ms", flush=True)
        summary[ls] = dict(
            ms=med, cost_pct=cost, bits=bits, occupancy=occ,
            shares={k: statistics.median(s[k] for s in per) for k in per[0]},
            clocks_pct=100.0 * span_s / dev_s, host_ms=host_ms)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
