#!/usr/bin/env python3
"""Measurements of the native kernels (``csrc/native/batch.cu``) on one
NVIDIA GPU.

    python3 -m lbfgspp_tpu_torch.tools.native_study [--reps 3] \
        [--bounds 8/10 6/12 ...]

Builds the kernels (the default build and the one without multiply-add
contraction) and the host builds (``Serial``; ``Lanes`` without
contraction), prints ptxas's registers, stack and spills and each
kernel's launch plan, then at ``chip_smoke.py`` phase 26's shapes (4096
Rosenbrock starts ``uniform(-2, 2)``, n = 100, m = 6, ``max_linesearch``
256, ``max_iterations`` 400, each search; the box recipe's 4096 starts in
[2, 4]^10 through More-Thuente) times each kernel with CUDA events (median
of ``--reps`` launches, each on a fresh copy of the starts), holds the
build without contraction bit for bit against the ``Lanes`` build, and
prints frac_within_1e-4 beside the ``Serial`` host build's.  Each
``--bounds`` entry ``k/k`` builds the kernels again under other launch
bounds (``LBFGSPP_LBFGS_MIN_BLOCKS`` / ``LBFGSPP_LBFGSB_MIN_BLOCKS``: at
most 65536 / (64 k) registers a thread), prints its ptxas lines and plans,
and times it beside the default in turns.  The last line is a JSON
summary.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess

import numpy as np
import torch

from lbfgspp_tpu_torch import LBFGSBParams, LBFGSParams, native
from lbfgspp_tpu_torch.utils import cuda_build

B, N, M = 4096, 100, 6
TRIALS, ITERS = 256, 400
BOX_N = 10


def ptxas_lines(log: str):
    """ptxas's registers, stack and spills per kernel of a build log."""
    out, name = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    try:
        return subprocess.run(["c++filt"], input="\n".join(out),
                              capture_output=True, text=True,
                              timeout=60).stdout.splitlines() or out
    except (OSError, subprocess.SubprocessError):
        return out


def event_ms(fn) -> float:
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def same_bits(xa, oa, xb, ob) -> bool:
    def bits(t):
        t = t.cpu().contiguous()
        return t.view(torch.int64) if t.is_floating_point() else t
    return all(bits(a).equal(bits(b)) for a, b in zip((xa, *oa), (xb, *ob)))


def frac(x) -> float:
    return ((x.double().cpu() - 1).abs().max(1).values <= 1e-4) \
        .double().mean().item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--bounds", nargs="*", default=[],
                    help="launch bounds to build and time, e.g. 8/10")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("native_study needs an NVIDIA GPU")
    dev = torch.device("cuda")
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    with concurrent.futures.ThreadPoolExecutor(4 + len(args.bounds)) as pool:
        jobs = [pool.submit(native.build, d, c) for d in ("cuda", "cpu")
                for c in (True, False)]
        capped = {}
        for k, bounds in enumerate(args.bounds):
            lb_, lbb = bounds.split("/")
            capped[f"b{k}:{bounds}"] = pool.submit(
                cuda_build.load, f"native_batch_b{k}", native._CUDA_SOURCES,
                (f"-DLBFGSPP_LBFGS_MIN_BLOCKS={lb_}",
                 f"-DLBFGSPP_LBFGSB_MIN_BLOCKS={lbb}"))
        for job in jobs:
            job.result()
        libs = {"default": native._device_lib(True),
                **{k: native._typed_device(j.result())
                   for k, j in capped.items()}}
    for name in ("native_batch", "native_batch_exact",
                 *(f"native_batch_{k.split(':')[0]}" for k in libs
                   if k != "default")):
        for line in ptxas_lines(cuda_build.build_logs.get(name, "")):
            print(f"ptxas {name}: {line}", flush=True)

    mp = LBFGSParams(m=M, max_linesearch=TRIALS, max_iterations=ITERS)
    bp = LBFGSBParams()
    for label, lib in libs.items():
        print(f"plan {label}: lbfgs n={N} "
              f"{native.plan(False, N, mp, dev, lib)}; lbfgsb n={BOX_N} "
              f"{native.plan(True, BOX_N, bp, dev, lib)}", flush=True)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-2, 2, (B, N)))
    bx0 = torch.as_tensor(np.random.default_rng(11).uniform(2, 4,
                                                           (B, BOX_N)))
    blo, bhi = torch.full_like(bx0, 2.0), torch.full_like(bx0, 4.0)
    summary = {"device": torch.cuda.get_device_name(0)}

    def run(lib, box, ls, contract=True):
        """One launch on fresh starts; (ms, x, outputs)."""
        src = bx0 if box else x0
        xs = src.to(dev).clone()
        out = native._outputs(B, dev)
        kw = dict(lb=blo.to(dev), ub=bhi.to(dev)) if box else {}
        lk = lib if contract else native._device_lib(False)
        ms = event_ms(lambda: native._launch(
            lk, box, 0, xs, bp if box else mp, native.LS_KINDS.get(ls, 0),
            out, **kw))
        return ms, xs, out

    cases = [(False, ls) for ls in native.LS_KINDS] + [(True, "box")]
    for box, ls in cases:
        times = {k: [] for k in libs}
        for _ in range(args.reps):
            for k, lib in (list(libs.items()) + list(libs.items())[::-1]):
                times[k].append(run(lib, box, ls)[0])
        _, xk, ok = run(libs["default"], box, ls)
        _, xe, oe = run(None, box, ls, contract=False)
        xl, xh = (bx0 if box else x0).clone(), (bx0 if box else x0).clone()
        if box:
            ol = native._lanes_b_batch("rosenbrock", xl, blo, bhi, bp)
            oh = native.native_lbfgsb_batch("rosenbrock", xh, blo, bhi, bp)
        else:
            ol = native._lanes_batch("rosenbrock", xl, mp, ls)
            oh = native.native_lbfgs_batch("rosenbrock", xh, mp, ls)
        bits = same_bits(xe, oe, xl, ol)
        med = {k: float(np.median(v)) for k, v in times.items()}
        xstar = torch.tensor([2.0, 4.0] * (BOX_N // 2), dtype=torch.float64)
        if box:
            fr = [((x.cpu() - xstar).abs().max(1).values <= 1e-4)
                  .double().mean().item() for x in (xk, xh)]
        else:
            fr = [frac(xk), frac(xh)]
        print(f"{ls}: kernel ms {med}; without contraction = Lanes bit for "
              f"bit {bits}; frac_within_1e-4 kernel {fr[0]:.4f} host "
              f"{fr[1]:.4f}; niter equal to the host on "
              f"{(ok.niter.cpu() == oh.niter).sum().item()}; mean niter "
              f"{ok.niter.double().mean().item():.1f}, nfev "
              f"{ok.nfev.double().mean().item():.1f}", flush=True)
        summary[ls] = dict(ms=med, bits=bits, frac=fr)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
