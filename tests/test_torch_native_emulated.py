"""The native core's CUDA source, built and run on the CPU.

``lbfgspp_tpu_torch/csrc/native/batch.cu`` is compiled with g++, the host
build's flags (``cuda_build.HOST_FLAGS``) and no multiply-add contraction
against a small emulation of the CUDA features it uses (``__global__``,
``blockIdx``, ``threadIdx``, ``blockDim``, the launch, dynamic shared
memory, the attribute and occupancy calls, ``cudaGetLastError``, the
warp's ``__syncwarp``, ``__shfl_xor_sync``, ``__ballot_sync``, and the probed
kernel's ``__shared__`` state, ``clock64()`` and ``%globaltimer``, both read
from the host's monotonic clock): each warp is
32 lanes, ``threadIdx.x % 32`` the lane, run as contexts (``ucontext``) of
one host thread that hand over to each other at the warp's barrier, so a
lane passes a ``__syncwarp`` only when all 32 have reached it, and shuffles
and ballots exchange values through the barrier; a block's warps run in
turn, the blocks over two host threads, each block on a fresh dynamic
shared-memory buffer filled with NaN.  (Host threads that spin at a
barrier, 32 to a warp, took minutes on a machine whose cores were busy
with other tests; contexts take one core and seconds.)  Both
kernels run B = 37 instances that mix a converged start, instances that
reach ``max_iterations``, a line-search failure and a huge start, through
their C launchers as the port's wrappers call them, and are held bit for bit
against the host build's ``Lanes`` policy (the warp's reductions as 32
strided partials and the same butterfly, on one thread per solve) without
contraction, ``native._lanes_batch``: a workspace offset, stride, size or
lane slip would show as a difference, or in the canaries written into the
slack behind each device-memory row and behind each block's shared memory.
A wider box run (n = 64, m = 12, random boxes) reaches the subspace step's
BOXCQP iterations with many free coordinates, where the workspace's derived
peak (``native_doubles_b`` in ``lbfgsb.h``) is largest: no solve may run
out of it (status -1, which no JAX status shares).  The cases run with the
workspace in device memory (two warps a block) and in shared memory (three
warps a block, the last block ragged), at n = 10 (22 of 32 lanes idle) and
at n = 37 on the builtin quadratic (the last lane group ragged).  Every
run is made again through its kernel's probed build
(``lbfgspp_native_lbfgs_batch_probed``, ``lbfgspp_native_lbfgsb_batch_probed``,
two warps a block, as many as the probe state has rows): the same bits,
and a record per instance whose phases fit inside its slot's time (the
box record's Cauchy points and subspace steps inside its directions).

What this cannot show: that nvcc accepts the source, or the card's own
arithmetic (``chip_smoke.py`` phase 26 and ``tests/test_torch_cuda.py``
hold the card's build without contraction bit for bit against the same
``Lanes`` build).  The runs go in one subprocess with a time limit, so a
hang fails the test instead of the test run.
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
N_RAGGED = 37
GLOBAL_WARPS, SHARED_WARPS = 2, 3
# the probed kernel's block: at most two warps (its probe state's rows)
PROBED_WARPS = 2
# The emulated card: an H100's shared memory (per SM, a block's opt-in
# limit, reserved a block), at most 32 blocks and 2048 threads an SM.
SMEM_SM, SMEM_OPTIN, SMEM_RESERVED = 233472, 232448, 1024
# host threads that take the emulated blocks
HOST_THREADS = 2

EMULATED_RUNTIME = r'''
#pragma once
#include <ucontext.h>
#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
// a block runs on one host thread, its warps in turn: the block's static
// shared memory is the thread's
#define __shared__ thread_local
inline long long emu_now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
      std::chrono::steady_clock::now().time_since_epoch()).count();
}
inline long long clock64() { return emu_now_ns(); }
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 blockIdx, threadIdx;
inline dim3 blockDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
struct cudaFuncAttributes { int maxThreadsPerBlock; };
template <class K>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  a->maxThreadsPerBlock = 1024;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t emu_error = cudaSuccess;
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_error;
  emu_error = cudaSuccess;
  return e;
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = SMEM_OPTIN;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  return bytes <= SMEM_OPTIN ? cudaSuccess : cudaErrorInvalidValue;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, K, int threads, size_t bytes) {
  int b = static_cast<int>(SMEM_SM / (bytes + SMEM_RESERVED));
  if (b > 32) b = 32;
  if (b > 2048 / threads) b = 2048 / threads;
  *blocks = b;
  return cudaSuccess;
}

// A warp's 32 lanes are contexts (ucontext) on one host thread, run in
// turn: a lane runs until it reaches the warp's barrier, then hands over
// to the next lane, so when lane 0 resumes past a barrier every lane has
// arrived at it.  Shuffles and ballots leave a value in the lane's slot
// before the barrier and read the partners' after it, from two banks used
// in turn (a lane writes a bank again only after every lane has passed the
// barrier that follows the reads of it).
struct EmuWarp {
  ucontext_t lane[32];
  ucontext_t back;
  int finished = 0;
  int bank[32] = {};
  double slot[2][32];
  int flag[2][32];
};
inline thread_local EmuWarp* emu_warp;
inline thread_local int emu_lane_id, emu_warp_id;
inline thread_local void* emu_kernel;
inline int emu_lane() { return emu_lane_id; }
inline void emu_switch(int next) {
  const int prev = emu_lane_id;
  emu_lane_id = next;
  threadIdx.x = static_cast<unsigned>(emu_warp_id * 32 + next);
  swapcontext(&emu_warp->lane[prev], &emu_warp->lane[next]);
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_switch((emu_lane_id + 1) % 32);
}
inline double __shfl_xor_sync(unsigned, double v, int off) {
  const int bank = emu_warp->bank[emu_lane_id] ^= 1;
  emu_warp->slot[bank][emu_lane_id] = v;
  __syncwarp();
  return emu_warp->slot[bank][emu_lane_id ^ off];
}
inline unsigned __ballot_sync(unsigned, int p) {
  const int bank = emu_warp->bank[emu_lane_id] ^= 1;
  emu_warp->flag[bank][emu_lane_id] = p != 0;
  __syncwarp();
  unsigned mask = 0;
  for (int l = 0; l < 32; ++l)
    if (emu_warp->flag[bank][l]) mask |= 1u << l;
  return mask;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }

// A lane: the kernel, then the next lane (every lane of a warp leaves the
// kernel at the same barrier), the last back to the launcher.
template <class F>
void emu_lane_main() {
  (*static_cast<F*>(emu_kernel))();
  EmuWarp* w = emu_warp;
  if (++w->finished == 32) {
    swapcontext(&w->lane[emu_lane_id], &w->back);
  } else {
    emu_switch((emu_lane_id + 1) % 32);
  }
}

// The block's dynamic shared memory, NaN-filled, with canaries behind it.
inline thread_local std::vector<double> emu_smem;
inline std::atomic<long long> emu_canary_faults{0};

// The blocks over a few host threads, each block's warps in turn.  A block
// of more than 1024 threads is refused, as the card refuses it.
template <class F>
void emu_launch(long long grid, int threads, long long smem, cudaStream_t,
                F fn) {
  if (threads < 1 || threads > 1024 || threads % 32) {
    emu_error = cudaErrorInvalidConfiguration;
    return;
  }
  blockDim.x = threads;
  const long long words = smem / 8;
  std::atomic<long long> next{0};
  auto work = [&] {
    std::vector<std::vector<char>> stacks(32, std::vector<char>(1 << 19));
    emu_kernel = &fn;
    for (long long b; (b = next++) < grid;) {
      emu_smem.assign(words + SLACK, std::nan(""));
      blockIdx.x = static_cast<unsigned>(b);
      for (int w = 0; w < threads / 32; ++w) {
        EmuWarp warp;
        emu_warp = &warp;
        emu_warp_id = w;
        for (int l = 0; l < 32; ++l) {
          getcontext(&warp.lane[l]);
          warp.lane[l].uc_stack.ss_sp = stacks[l].data();
          warp.lane[l].uc_stack.ss_size = stacks[l].size();
          warp.lane[l].uc_link = nullptr;
          makecontext(&warp.lane[l], &emu_lane_main<F>, 0);
        }
        emu_lane_id = 0;
        threadIdx.x = static_cast<unsigned>(w * 32);
        swapcontext(&warp.back, &warp.lane[0]);
      }
      for (long long i = words; i < words + SLACK; ++i)
        if (!std::isnan(emu_smem[i])) ++emu_canary_faults;
    }
  };
  const long long pool = std::min<long long>(grid, EMU_HOST_THREADS);
  std::vector<std::thread> ts;
  for (long long t = 1; t < pool; ++t) ts.emplace_back(work);
  work();
  for (auto& th : ts) th.join();
}

extern "C" long long emu_canary_fault_count() { return emu_canary_faults; }
'''


# the probed kernel's read of the card's wall clock
GLOBALTIMER = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));'


def emulated_source(src: str) -> str:
    """batch.cu with its launches turned into calls of the emulation, its
    dynamic shared memory into the emulation's buffer and its wall clock
    into the host's."""
    src = re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);",
                 r"emu_launch(\2, [&] { \1(\3); });", src, flags=re.S)
    src, k = re.subn(r"extern __shared__ double (\w+)\[\];",
                     r"double* \1 = emu_smem.data();", src)
    timers = src.count(GLOBALTIMER)
    src = src.replace(GLOBALTIMER, "t = emu_now_ns();")
    if "<<<" in src or k != 1 or timers != 1 or "asm" in src:
        raise AssertionError("unconverted launch, shared memory or inline "
                             "assembly in batch.cu")
    return src


def runtime() -> str:
    consts = (f"constexpr long long SMEM_SM = {SMEM_SM}, SMEM_OPTIN = "
              f"{SMEM_OPTIN}, SMEM_RESERVED = {SMEM_RESERVED}, SLACK = "
              f"{SLACK}, EMU_HOST_THREADS = {HOST_THREADS};\n")
    head, body = EMULATED_RUNTIME.split("#define __global__", 1)
    return head + consts + "#define __global__" + body


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


def ragged_cases():
    """The builtin quadratic at n = 37 (optimum 0, 1, ..., 36): starts and
    boxes that cut the optimum, [BATCH, N_RAGGED]."""
    rng = np.random.default_rng(7)
    x0 = rng.uniform(-5, 40, (BATCH, N_RAGGED))
    lb = rng.uniform(-5, 30, (BATCH, N_RAGGED))
    ub = lb + rng.uniform(0.5, 10, (BATCH, N_RAGGED))
    return x0, np.clip(x0, lb, ub), lb, ub


# label -> (box, objective, placement): the rows of each run come from
# _inputs(label)
RUNS = {
    **{ls: (False, "rosenbrock", "global") for ls in native.LS_KINDS},
    "box": (True, "rosenbrock", "global"),
    "box_wide": (True, "rosenbrock", "global"),
    "shared_morethuente": (False, "rosenbrock", "shared"),
    "shared_box": (True, "rosenbrock", "shared"),
    "ragged_quadratic": (False, "quadratic", "shared"),
    "ragged_box_quadratic": (True, "quadratic", "global"),
}


def _inputs(label):
    """(x0, lb, ub, params, line search) of a run; lb, ub None for L-BFGS."""
    x0, xb, lb, ub = cases()
    if label == "box_wide":
        return (*wide_cases(), PARAMS_WIDE, None)
    if label in ("box", "shared_box"):
        return xb, lb, ub, PARAMS_B, None
    if label == "ragged_quadratic":
        return ragged_cases()[0], None, None, PARAMS, "nocedalwright"
    if label == "ragged_box_quadratic":
        return (*ragged_cases()[1:], PARAMS_B, None)
    ls = label.replace("shared_", "")
    return x0, None, None, PARAMS, ls


def _main(lib_path):
    """Run every emulated launch; print one JSON line of their outputs."""
    import ctypes
    lib = ctypes.CDLL(lib_path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lbfgspp_native_lbfgs_batch.argtypes = [
        i, ll, i, p, p, i, p, ll, i, p, p, p, p, p, p]
    lib.lbfgspp_native_lbfgs_batch_probed.argtypes = [
        i, ll, i, p, p, i, p, ll, i, p, p, p, p, p, p, p]
    lib.lbfgspp_native_lbfgsb_batch.argtypes = [
        i, ll, i, p, p, p, p, p, ll, i, p, p, p, p, p, p]
    lib.lbfgspp_native_lbfgsb_batch_probed.argtypes = [
        i, ll, i, p, p, p, p, p, ll, i, p, p, p, p, p, p, p]
    lib.lbfgspp_native_plan.argtypes = [i, i, i, i, p, p, p]
    lib.emu_canary_fault_count.restype = ll
    for fn in (lib.lbfgspp_native_workspace, lib.lbfgspp_native_workspace_b):
        fn.argtypes = [i] * 3
        fn.restype = ll
    out = {}
    for label, (box, fun, placement) in RUNS.items():
        x0, lb, ub, prm, ls = _inputs(label)
        n = x0.shape[1]
        x = torch.tensor(x0)
        size = (lib.lbfgspp_native_workspace_b if box
                else lib.lbfgspp_native_workspace)(n, prm.m, prm.past)
        stride = -(-size // 8)
        ws = torch.full((BATCH, stride + SLACK), np.nan, dtype=torch.float64)
        wsp, st, warps = ws.data_ptr(), stride + SLACK, GLOBAL_WARPS
        if placement == "shared":
            wsp, st, warps = None, 0, SHARED_WARPS
        outs = native._outputs(BATCH, "cpu")
        faults = lib.emu_canary_fault_count()
        bid = native.BUILTIN_OBJECTIVES[fun]
        if box:
            lbt, ubt = torch.tensor(lb), torch.tensor(ub)
            err = lib.lbfgspp_native_lbfgsb_batch(
                bid, BATCH, n, x.data_ptr(), lbt.data_ptr(), ubt.data_ptr(),
                ctypes.addressof(native._cparams_b(prm)), wsp, st, warps,
                *(t.data_ptr() for t in outs), None)
        else:
            err = lib.lbfgspp_native_lbfgs_batch(
                bid, BATCH, n, x.data_ptr(),
                ctypes.addressof(native._cparams(prm)), native.LS_KINDS[ls],
                wsp, st, warps, *(t.data_ptr() for t in outs), None)
        out[label] = {
            "err": err, "x": x.tolist(),
            "canaries": bool(ws[:, stride:].isnan().all()) and
            lib.emu_canary_fault_count() == faults,
            **{k: v.tolist() for k, v in outs._asdict().items()}}
        # the same launch through the probed kernel, on a fresh workspace
        x = torch.tensor(x0)
        ws.fill_(np.nan)
        outs = native._outputs(BATCH, "cpu")
        probe = torch.full((BATCH, len(native.PROBE_FIELDS_B if box else
                                       native.PROBE_FIELDS)), -1,
                           dtype=torch.int64)
        faults = lib.emu_canary_fault_count()
        if box:
            err = lib.lbfgspp_native_lbfgsb_batch_probed(
                bid, BATCH, n, x.data_ptr(), lbt.data_ptr(), ubt.data_ptr(),
                ctypes.addressof(native._cparams_b(prm)), wsp, st,
                min(warps, PROBED_WARPS), *(t.data_ptr() for t in outs),
                None, probe.data_ptr())
        else:
            err = lib.lbfgspp_native_lbfgs_batch_probed(
                bid, BATCH, n, x.data_ptr(),
                ctypes.addressof(native._cparams(prm)), native.LS_KINDS[ls],
                wsp, st, min(warps, PROBED_WARPS),
                *(t.data_ptr() for t in outs), None, probe.data_ptr())
        out["probed_" + label] = {
            "err": err, "x": x.tolist(), "probe": probe.tolist(),
            "canaries": bool(ws[:, stride:].isnan().all()) and
            lib.emu_canary_fault_count() == faults,
            **{k: v.tolist() for k, v in outs._asdict().items()}}
    # the plan at the multistart's, the box recipe's and a large shape,
    # and a launch whose block does not fit the shared-memory limit
    plans = {}
    for box, n in ((0, 100), (1, 10), (0, 4096), (2, 100), (2, 4096),
                   (3, 10), (3, 4096)):
        vals = (ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong())
        err = lib.lbfgspp_native_plan(box, n, 6, 1,
                                      *(ctypes.byref(v) for v in vals))
        plans[f"{box},{n}"] = [err, *(v.value for v in vals)]
    x = torch.tensor(cases()[0])
    outs = native._outputs(BATCH, "cpu")
    too_big = lib.lbfgspp_native_lbfgs_batch(
        0, BATCH, N, x.data_ptr(), ctypes.addressof(native._cparams(PARAMS)),
        2, None, 0, 64, *(t.data_ptr() for t in outs), None)
    probe = torch.zeros(BATCH, len(native.PROBE_FIELDS), dtype=torch.int64)
    too_big_probed = lib.lbfgspp_native_lbfgs_batch_probed(
        0, BATCH, N, x.data_ptr(), ctypes.addressof(native._cparams(PARAMS)),
        2, None, 0, PROBED_WARPS + 1, *(t.data_ptr() for t in outs), None,
        probe.data_ptr())
    print(json.dumps({"runs": out, "plans": plans, "too_big": too_big,
                      "too_big_probed": too_big_probed,
                      "untouched": bool(x.equal(torch.tensor(cases()[0])) and
                                        not probe.any())}))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    build = str(tmp_path_factory.mktemp("native_emulated"))
    with open(os.path.join(NATIVE, "batch.cu")) as f:
        source = emulated_source(f.read())
    for name, text in (("cuda_runtime.h", runtime()),
                       ("batch_emulated.cpp", source)):
        with open(os.path.join(build, name), "w") as f:
            f.write(text)
    lib_path = os.path.join(build, "libnative_emulated.so")
    proc = subprocess.run(
        ["g++", *cuda_build.HOST_FLAGS, *native._NO_CONTRACT["cpu"],
         "-pthread", "-I", build, "-I", NATIVE,
         os.path.join(build, "batch_emulated.cpp"), "-o", lib_path],
        capture_output=True, text=True, timeout=250)
    assert proc.returncode == 0, proc.stderr[-4000:]
    code = (f"import sys; sys.path[:0] = [{os.path.dirname(__file__)!r}, "
            f"{REPO!r}]; import test_torch_native_emulated as t; "
            f"t._main({lib_path!r})")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=250, cwd=REPO)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _lanes(label):
    """The Lanes host build's batch of the run's instances, without
    contraction (x, then fx, gnorm, niter, nfev, status)."""
    box, fun, _ = RUNS[label]
    x0, lb, ub, prm, ls = _inputs(label)
    x = torch.tensor(x0)
    if box:
        out = native._lanes_b_batch(fun, x, torch.tensor(lb),
                                    torch.tensor(ub), prm)
    else:
        out = native._lanes_batch(fun, x, prm, ls)
    return x, out


@pytest.mark.parametrize("label", list(RUNS))
def test_emulated_kernel_equals_host_singles(emulated, label):
    """Each run against the host's Lanes build of the same instances (every
    instance of its threaded batch equals its single solve)."""
    got = emulated["runs"][label]
    assert got["err"] == 0 and got["canaries"]
    statuses = set(got["status"])
    assert -1 not in statuses, "a solve ran out of its workspace"
    x, want = _lanes(label)
    assert np.array_equal(np.asarray(got["x"]), x.numpy())
    for k in ("fx", "gnorm", "niter", "nfev", "status"):
        assert np.array_equal(np.asarray(got[k]), getattr(want, k).numpy()), k
    if label in ("box_wide",) or label.startswith("ragged"):
        return
    # the mix the run is for: a converged start, the cap, a failure
    assert {1, 3} <= statuses, statuses
    if "box" not in label:
        assert statuses - {1, 2, 3}, statuses


def _expected_plan(box, n):
    """The plan by hand on the emulated card: the warps a block (1-8) that
    keep the most warps on an SM, the fewest on a tie, in shared memory
    when one warp's slice fits the block's limit."""
    host = native._host()
    size = (host.lbfgspp_native_workspace_b if box
            else host.lbfgspp_native_workspace)(n, 6, 1)
    per_warp = 8 * (n + -(-size // 8))
    shared = per_warp <= SMEM_OPTIN
    best = (0, 0, 0)
    for w in range(1, 9):
        nbytes = w * per_warp if shared else 0
        if nbytes > SMEM_OPTIN:
            break
        blocks = min(32, 2048 // (32 * w), SMEM_SM // (nbytes + SMEM_RESERVED))
        if blocks * w > best[0] * best[1]:
            best = (w, blocks, nbytes)
    return [0, *best]


def test_emulated_plan_and_refused_launch(emulated):
    """The plan on the emulated H100's shared memory (registers aside), as
    worked by hand: n = 100, m = 6 in shared memory, one warp a block and
    13 blocks an SM; n = 10's box solve in shared memory; n = 4096 in
    device memory (a warp's workspace passes the block's limit).  A block
    of 64 warps (2048 threads) is refused, leaving x as it was."""
    plans = emulated["plans"]
    for key, want in plans.items():
        box, n = map(int, key.split(","))
        assert want == _expected_plan(box in (1, 3), n), key
    assert plans["0,100"][1:3] == [1, 13] and plans["0,100"][3] > 0
    assert plans["1,10"][3] > 0 and plans["0,4096"][3] == 0
    assert plans["2,100"] == plans["0,100"]
    assert plans["2,4096"] == plans["0,4096"]
    assert plans["3,10"] == plans["1,10"] and plans["3,4096"][3] == 0
    assert emulated["too_big"] != 0 and emulated["untouched"]
    assert emulated["too_big_probed"] != 0


@pytest.mark.parametrize("label", [k for k, v in RUNS.items() if not v[0]])
def test_emulated_probed_kernel_equals_default(emulated, label):
    """The probed kernel gives the default kernel's x and outputs bit for
    bit, and one record per instance: start_ns <= end_ns, every phase's
    cycles >= 0 and together within the slot's."""
    got, want = emulated["runs"]["probed_" + label], emulated["runs"][label]
    assert got["err"] == 0 and got["canaries"]
    for k in ("x", "fx", "gnorm", "niter", "nfev", "status"):
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    rec = dict(zip(native.PROBE_FIELDS, np.asarray(got["probe"]).T))
    assert (rec["start_ns"] > 0).all()
    assert (rec["start_ns"] <= rec["end_ns"]).all()
    phases = np.stack([rec["eval"], rec["search"], rec["direction"]])
    assert (phases >= 0).all() and (rec["eval"] > 0).all()
    assert (phases.sum(0) <= rec["total"]).all()
    # an instance that iterated searched and turned
    moved = np.asarray(want["niter"]) > 1
    assert moved.any() and (rec["search"][moved] > 0).all()
    assert (rec["direction"][moved] > 0).all()


@pytest.mark.parametrize("label", [k for k, v in RUNS.items() if v[0]])
def test_emulated_probed_box_kernel_equals_default(emulated, label):
    """The probed box kernel gives the default box kernel's x and outputs
    bit for bit, and one record per instance: start_ns <= end_ns, every
    phase's cycles >= 0, eval, search and direction together within the
    slot's, the Cauchy points and subspace steps together within the
    directions'."""
    got, want = emulated["runs"]["probed_" + label], emulated["runs"][label]
    assert got["err"] == 0 and got["canaries"]
    for k in ("x", "fx", "gnorm", "niter", "nfev", "status"):
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    rec = dict(zip(native.PROBE_FIELDS_B, np.asarray(got["probe"]).T))
    assert (rec["start_ns"] > 0).all()
    assert (rec["start_ns"] <= rec["end_ns"]).all()
    phases = np.stack([rec[k] for k in native.PROBE_FIELDS_B[3:]])
    assert (phases >= 0).all() and (rec["eval"] > 0).all()
    assert (rec["eval"] + rec["search"] + rec["direction"] <=
            rec["total"]).all()
    assert (rec["cauchy"] + rec["subspace"] <= rec["direction"]).all()
    # an instance that took a second search turned in between: a Cauchy
    # point and a subspace step
    turned = np.asarray(want["niter"]) > 1
    assert turned.any()
    for k in ("search", "direction", "cauchy", "subspace"):
        assert (rec[k][turned] > 0).all(), k
