"""The native core's CUDA source, built and run on the CPU.

``lbfgspp_tpu_torch/csrc/native/batch.cu`` is compiled with g++ and the host
build's flags (``cuda_build.HOST_FLAGS``) against a small emulation of the
CUDA features it uses (``__global__``, ``blockIdx``, ``threadIdx``,
``blockDim``, the launch, ``cudaGetLastError``): each block's 32 threads
run at once as host threads, one instance each, on their own rows of one
workspace buffer.  Both kernels run B = 37 instances (two blocks, the
second ragged) that mix a converged start, instances that reach
``max_iterations``, a line-search failure and a huge start, through its C
launchers as the port's wrappers call them, and are held bit for bit
against the host build's single solves (``csrc/native/host.cpp``) of the
same instances: a workspace offset, stride or size slip would show as a
difference, or in the canaries written into the slack behind each row.  A
wider box run (n = 64, m = 12, random boxes) reaches the subspace step's
BOXCQP iterations with many free coordinates, where the workspace's
derived peak (``native_doubles_b`` in ``lbfgsb.h``) is largest: no solve
may run out of it (status -1, which no JAX status shares).

What this cannot show: that nvcc accepts the source, or the card's own
arithmetic (nvcc and g++ each contract multiply-adds in their own places;
``chip_smoke.py`` phase 26 holds the card's build without contraction bit
for bit against the host's, and the default builds to tolerances).  The runs go in one subprocess
with a time limit, so a hang fails the test instead of the test run.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from lbfgspp_tpu_torch import LBFGSBParams, LBFGSParams
from lbfgspp_tpu_torch import native
from lbfgspp_tpu_torch.utils import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "lbfgspp_tpu_torch", "csrc", "native")
BATCH, N, SLACK = 37, 10, 8
PARAMS = LBFGSParams(epsilon=1e-8, max_iterations=40, max_linesearch=3)
PARAMS_B = LBFGSBParams(max_iterations=15, max_linesearch=3)
N_WIDE = 64
PARAMS_WIDE = LBFGSBParams(m=12, max_iterations=40)

EMULATED_RUNTIME = r'''
#pragma once
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 blockIdx, threadIdx;
inline dim3 blockDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }

// Blocks in turn; the threads of a block at once.
template <class F>
void emu_launch(long long grid, int threads, int, cudaStream_t, F fn) {
  blockDim.x = threads;
  for (long long b = 0; b < grid; ++b) {
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, b, t] {
        blockIdx.x = static_cast<unsigned>(b);
        threadIdx.x = t;
        fn();
      });
    for (auto& th : ts) th.join();
  }
}
'''


def emulated_source(src: str) -> str:
    """batch.cu with its launches turned into calls of the emulation."""
    src = re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);",
                 r"emu_launch(\2, [&] { \1(\3); });", src, flags=re.S)
    if "<<<" in src:
        raise AssertionError("unconverted launch in batch.cu")
    return src


def cases():
    """The starts and boxes of both kernels' runs: row 0 starts at the
    optimum, row 1 far out (1e7: the first step is below More-Thuente's
    min_step, and the other searches fail or stall), the box's row 2 has
    four pinned coordinates; max_linesearch = 3 makes backtracking and
    bracketing fail on some rows, and the others reach max_iterations."""
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-3, 3, (BATCH, N))
    x0[0], x0[1] = 1.0, 1e7
    lb = rng.uniform(-2, 1, (BATCH, N))
    ub = lb + rng.uniform(0.1, 3, (BATCH, N))
    xb = np.clip(rng.uniform(-2, 2, (BATCH, N)), lb, ub)
    lb[:2], ub[:2] = -np.inf, np.inf
    xb[0], xb[1] = 1.0, 1e7
    lb[2, :4] = ub[2, :4] = xb[2, :4] = 0.5
    return x0, xb, lb, ub


def wide_cases():
    """The wide box run's starts and random boxes [BATCH, N_WIDE]."""
    rng = np.random.default_rng(5)
    lb = rng.uniform(-2, 1, (BATCH, N_WIDE))
    ub = lb + rng.uniform(0.5, 3, (BATCH, N_WIDE))
    return np.clip(rng.uniform(-2, 2, (BATCH, N_WIDE)), lb, ub), lb, ub


def _rows(stride, fill=np.nan):
    """A workspace [BATCH, stride + SLACK] filled with ``fill``."""
    return torch.full((BATCH, stride + SLACK), fill, dtype=torch.float64)


def _main(lib_path):
    """Run both emulated kernels; print one JSON line of their outputs."""
    import ctypes
    lib = ctypes.CDLL(lib_path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lbfgspp_native_lbfgs_batch.argtypes = [
        i, ll, i, p, p, i, p, ll, p, p, p, p, p, p]
    lib.lbfgspp_native_lbfgsb_batch.argtypes = [
        i, ll, i, p, p, p, p, p, ll, p, p, p, p, p, p]
    for fn in (lib.lbfgspp_native_workspace, lib.lbfgspp_native_workspace_b):
        fn.argtypes = [i] * 3
        fn.restype = ll
    x0, xb, lb, ub = cases()
    out = {}

    def run(label, launch, x, stride):
        x = torch.tensor(x)
        ws = _rows(stride)
        outs = native._outputs(BATCH, "cpu")
        err = launch(x.data_ptr(), ws.data_ptr(), stride + SLACK,
                     *(t.data_ptr() for t in outs))
        out[label] = {"err": err, "x": x.tolist(),
                      "canaries": bool(ws[:, stride:].isnan().all()),
                      **{k: v.tolist() for k, v in outs._asdict().items()}}

    stride = -(-lib.lbfgspp_native_workspace(N, PARAMS.m, PARAMS.past) // 8)
    for ls, kind in native.LS_KINDS.items():
        run(ls, lambda x, ws, st, *o, kind=kind:
            lib.lbfgspp_native_lbfgs_batch(
                0, BATCH, N, x, ctypes.addressof(native._cparams(PARAMS)),
                kind, ws, st, *o, None), x0, stride)
    for label, x, lo, hi, n, pb in (("box", xb, lb, ub, N, PARAMS_B),
                                    ("box_wide", *wide_cases(), N_WIDE,
                                     PARAMS_WIDE)):
        stride = -(-lib.lbfgspp_native_workspace_b(n, pb.m, pb.past) // 8)
        lbt, ubt = torch.tensor(lo), torch.tensor(hi)
        run(label, lambda x, ws, st, *o, n=n, pb=pb, lbt=lbt, ubt=ubt:
            lib.lbfgspp_native_lbfgsb_batch(
                0, BATCH, n, x, lbt.data_ptr(), ubt.data_ptr(),
                ctypes.addressof(native._cparams_b(pb)), ws, st, *o, None),
            x, stride)
    print(json.dumps(out))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    build = str(tmp_path_factory.mktemp("native_emulated"))
    with open(os.path.join(NATIVE, "batch.cu")) as f:
        source = emulated_source(f.read())
    for name, text in (("cuda_runtime.h", EMULATED_RUNTIME),
                       ("batch_emulated.cpp", source)):
        with open(os.path.join(build, name), "w") as f:
            f.write(text)
    lib_path = os.path.join(build, "libnative_emulated.so")
    proc = subprocess.run(
        ["g++", *cuda_build.HOST_FLAGS, "-pthread", "-I", build, "-I",
         NATIVE, os.path.join(build, "batch_emulated.cpp"), "-o", lib_path],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    code = (f"import sys; sys.path[:0] = [{os.path.dirname(__file__)!r}, "
            f"{REPO!r}]; import test_torch_native_emulated as t; "
            f"t._main({lib_path!r})")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _host_singles(label):
    """The host build's single solves of the run's instances (x, fx, gnorm,
    niter, nfev, status)."""
    x0, xb, lb, ub = cases()
    rows = []
    for b in range(BATCH):
        if label == "box_wide":
            xw, lw, uw = wide_cases()
            r = native.minimize_b("rosenbrock", xw[b], lw[b], uw[b],
                                  PARAMS_WIDE, device="cpu")
        elif label == "box":
            r = native.minimize_b("rosenbrock", xb[b], lb[b], ub[b],
                                  PARAMS_B, device="cpu")
        else:
            r = native.minimize("rosenbrock", x0[b], PARAMS, label,
                                device="cpu")
        rows.append(r)
    return rows


@pytest.mark.parametrize("label", [*native.LS_KINDS, "box", "box_wide"])
def test_emulated_kernel_equals_host_singles(emulated, label):
    got = emulated[label]
    assert got["err"] == 0 and got["canaries"]
    statuses = set(got["status"])
    assert -1 not in statuses, "a solve ran out of its workspace"
    want = _host_singles(label)
    for b, r in enumerate(want):
        assert np.array_equal(np.asarray(got["x"][b]), r.x.numpy()), b
        for k in ("fx", "gnorm", "niter", "nfev", "status"):
            assert got[k][b] == getattr(r, k).item(), (b, k)
    if label == "box_wide":
        return
    # the mix the run is for: a converged start, the cap, a failure
    assert {1, 3} <= statuses, statuses
    if label != "box":
        assert statuses - {1, 2, 3}, statuses
