"""The CUDA two-loop kernels' own source, built and run on the CPU.

``lbfgspp_tpu_torch/csrc/two_loop.cu`` is compiled with the host C++
compiler against an emulation of the few CUDA features it uses: each
block's threads run as host threads (``__syncwarp``, ``__syncthreads`` and
the shuffles on barriers), and ``csrc/hopper_async.cuh``, which holds every
piece of inline PTX, is replaced by a model of it: a bulk copy or a
``cp.async`` is a ``memcpy`` that first checks the alignment the hardware
demands, and an mbarrier counts arrivals and transaction bytes and flips
its phase as the PTX specification says.  The launch plan comes from
``fused.launch_plan``, so the walk, the stage ring, both copy paths, the
unstaged plan and both recursions run as on the card, and their result is
held against ``fused.two_loop_plain`` (tolerances as on the card: 1e-12 in
f64 and 1e-5 in f32, relative to the largest output).  The bf16
instantiations run too: bf16 rows beside f32 operands ("bf16rows", held
to 1e-5 against the plain version on the same rows), and everything in
bf16 ("bfloat16", held to 2^-8 of the largest output against the plain
version computed in f32 from the same bf16 inputs and rounded once).

What this cannot show: that nvcc accepts the source, timing, or the memory
model of the asynchronous proxy; tests/test_torch_cuda.py covers those on
the card.  The cases run in one subprocess with a time limit, so a hang
or an emulated trap fails the tests instead of stopping the test run.
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

from lbfgspp_tpu_torch.ops import fused, history

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "lbfgspp_tpu_torch", "csrc")
RTOL = {"float64": 1e-12, "float32": 1e-5}

# label: (batch, n, m, ncorrs, layout, views at an odd offset, SMs of the
# emulated card).  layout: "plan" takes fused.launch_plan's choice, a
# (warps, stages, staged) tuple a layout it would not choose here, and
# "simple" runs the first design.
CASES = {
    "m=6 mixed": (5, 24, 6, (0, 6, 9, 2, 7), "plan", (), 1),
    "m=1": (3, 40, 1, (0, 1, 3), "plan", (), 1),
    "m=33": (2, 33, 33, (5, 70), "plan", (), 1),
    "m=20": (3, 12, 20, (1, 21, 45), "plan", (), 1),
    "n=101": (3, 101, 16, (3, 20, 40), "plan", (), 1),
    "odd offset": (4, 100, 16, (0, 5, 17, 40), (2, 1, True), ("s", "v"), 1),
    "unstaged": (3, 100, 16, (3, 16, 33), (2, 2, False), (), 1),
    "two-stage ring": (13, 100, 16, tuple(range(0, 39, 3)), (2, 2, True),
                       (), 1),
    "simple kernel": (5, 24, 6, (0, 6, 9, 2, 7), "simple", (), 1),
    # instances 0, 2 and 3 soft-reset after 20 pairs (as
    # on_ls_fail="restart" does), then 3 more pairs for all
    "soft reset": (5, 100, 16, (20,) * 5, "plan", (), 1),
}
SOFT_RESET = (True, False, True, True, False)
BF16 = ("bf16rows", "bfloat16")
MODES = ("sweeps", "rinv")
DTYPES = ("float32", "float64", "bf16rows", "bfloat16")
RTOL.update(bf16rows=1e-5, bfloat16=2.0 ** -8)
# dtype label -> (row dtype, operand dtype, the kernel's entry point)
TYPES = {"float32": (torch.float32, torch.float32, "f32"),
         "float64": (torch.float64, torch.float64, "f64"),
         "bf16rows": (torch.bfloat16, torch.float32, "bf16rows"),
         "bfloat16": (torch.bfloat16, torch.bfloat16, "bf16")}

EMULATED_RUNTIME = r'''
#pragma once
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 blockIdx, threadIdx;
inline dim3 gridDim, blockDim;
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline double2 make_double2(double a, double b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}

// One block at a time; its threads run concurrently.
struct EmuBlock {
  explicit EmuBlock(int threads) : block(threads), slots(threads) {
    for (int w = 0; w < threads / 32; ++w)
      warps.emplace_back(std::make_unique<std::barrier<>>(32));
  }
  std::barrier<> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<uint64_t> slots;
};
inline EmuBlock* g_block;
inline unsigned char* g_smem;
inline size_t g_smem_bytes;
inline std::atomic<long long> g_bulk_copies{0}, g_cp_async_copies{0};

inline unsigned char* emu_smem() { return g_smem; }
inline void __syncwarp() { g_block->warps[threadIdx.x / 32]->arrive_and_wait(); }
inline void __syncthreads() { g_block->block.arrive_and_wait(); }
template <class T> T emu_shfl(T x, int src_lane) {
  const int warp = threadIdx.x / 32;
  __syncwarp();
  std::memcpy(&g_block->slots[threadIdx.x], &x, sizeof(T));
  __syncwarp();
  T r;
  std::memcpy(&r, &g_block->slots[warp * 32 + (src_lane & 31)], sizeof(T));
  return r;
}
template <class T> T __shfl_sync(unsigned, T x, int src) {
  return emu_shfl(x, src);
}
template <class T> T __shfl_xor_sync(unsigned, T x, int off) {
  return emu_shfl(x, (threadIdx.x & 31) ^ off);
}
template <class T> T __shfl_down_sync(unsigned, T x, int off) {
  const int l = threadIdx.x & 31;
  return emu_shfl(x, l + off < 32 ? l + off : l);
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
[[noreturn]] inline void emu_fail(const char* what) {
  std::fprintf(stderr, "emulated kernel fault: %s\n", what);
  std::abort();
}
inline size_t __cvta_generic_to_shared(const void* p) {
  const unsigned char* c = static_cast<const unsigned char*>(p);
  if (c < g_smem || c > g_smem + g_smem_bytes) emu_fail("not shared memory");
  return static_cast<size_t>(c - g_smem);
}
inline long long clock64() { return 0; }
inline void __trap() { emu_fail("trap"); }

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "invalid value" : "no error";
}

template <class F>
void emu_launch(int grid, int threads, size_t smem, cudaStream_t, F fn) {
  gridDim.x = grid;
  blockDim.x = threads;
  std::vector<unsigned char> buf(smem + 16);
  for (int blk = 0; blk < grid; ++blk) {
    std::memset(buf.data(), 0xFF, buf.size());  // NaN where nothing wrote
    g_smem = buf.data();
    g_smem_bytes = smem;
    EmuBlock block(threads);
    g_block = &block;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) {
      ts.emplace_back([&, t] {
        blockIdx.x = blk;
        threadIdx.x = t;
        fn();
      });
    }
    for (auto& th : ts) th.join();
  }
}
'''

EMULATED_HOPPER_ASYNC = r'''
#pragma once
#include <stdint.h>
namespace {

struct EmuBarrier { int32_t tx; uint8_t pending, count, phase, pad; };

inline void emu_in_smem(uint32_t off, size_t bytes) {
  if (off + bytes > g_smem_bytes) emu_fail("shared memory overrun");
}
inline EmuBarrier* emu_barrier(uint32_t bar) {
  emu_in_smem(bar, 8);
  if (bar % 8) emu_fail("misaligned mbarrier");
  return reinterpret_cast<EmuBarrier*>(g_smem + bar);
}
inline void emu_complete_phase(EmuBarrier* b) {
  if (b->pending == 0 && b->tx == 0) {
    b->pending = b->count;
    __atomic_store_n(&b->phase, (uint8_t)(b->phase ^ 1), __ATOMIC_RELEASE);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  EmuBarrier* b = emu_barrier(bar);
  b->tx = 0;
  b->pending = b->count = (uint8_t)count;
  b->phase = 0;
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  EmuBarrier* b = emu_barrier(bar);
  b->tx += (int32_t)bytes;
  b->pending -= 1;
  emu_complete_phase(b);
}
// try_wait.parity succeeds once the phase of that parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  EmuBarrier* b = emu_barrier(bar);
  const auto t0 = std::chrono::steady_clock::now();
  while (__atomic_load_n(&b->phase, __ATOMIC_ACQUIRE) == parity) {
    if (std::chrono::steady_clock::now() - t0 > std::chrono::seconds(20))
      emu_fail("mbarrier phase never completed");
    std::this_thread::yield();
  }
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  if (dst % 16 || reinterpret_cast<uintptr_t>(src) % 16 || bytes % 16)
    emu_fail("bulk copy not 16-byte aligned");
  emu_in_smem(dst, bytes);
  std::memcpy(g_smem + dst, src, bytes);
  g_bulk_copies += 1;
  EmuBarrier* b = emu_barrier(bar);
  b->tx -= (int32_t)bytes;
  emu_complete_phase(b);
}
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int granule) {
  if (dst % granule || reinterpret_cast<uintptr_t>(src) % granule)
    emu_fail("cp.async not aligned to its size");
  emu_in_smem(dst, granule);
  std::memcpy(g_smem + dst, src, granule);
  g_cp_async_copies += 1;
}
__device__ __forceinline__ void cp_async_commit() {}
__device__ __forceinline__ void cp_async_wait(int) {}
__device__ __forceinline__ void fence_mbarrier_init() {}
__device__ __forceinline__ void fence_proxy_async() {}

}  // namespace

extern "C" long long emu_copies(int cp_async) {
  return cp_async ? g_cp_async_copies.load() : g_bulk_copies.load();
}
'''


def emulated_source(src: str) -> str:
    """The kernel source with its launches and shared-memory declarations
    turned into calls of the emulation."""
    src = re.sub(r"(\w+<[^<>;]*>)<<<(.*?)>>>\((.*?)\);",
                 r"emu_launch(\2, [&] { \1(\3); });", src, flags=re.S)
    src = re.sub(r"extern __shared__ __align__\(\d+\) unsigned char (\w+)\[\];",
                 r"unsigned char* \1 = emu_smem();", src)
    if "<<<" in src or "__shared__" in src:
        raise AssertionError("unconverted CUDA syntax in two_loop.cu")
    return src


def _add_pairs(h, rng, ncorrs):
    batch, _, n = h.s.shape
    for t in range(max(ncorrs)):
        s = rng.standard_normal((batch, n))
        y = s * rng.uniform(0.5, 2.0, (batch, 1)) \
            + 0.3 * rng.standard_normal((batch, n))
        y[np.einsum("bn,bn->b", s, y) < 0] *= -1.0
        h, _ = history.update_history(
            h, torch.as_tensor(s), torch.as_tensor(y),
            torch.as_tensor(t < np.asarray(ncorrs)))
    return h


def _history(batch, n, m, ncorrs, seed=0, soft_reset=None):
    """Random accepted pairs, ``ncorrs[b]`` for instance b; then, where
    ``soft_reset`` is given, the restart's soft reset of those instances
    (ncorr = 0, theta = 1, stale rows and R^{-1} entries left in place)
    and three more pairs for every instance."""
    rng = np.random.default_rng(seed)
    h = _add_pairs(history.init_history(batch, n, m, torch.float64,
                                        device="cpu", with_rinv=True),
                   rng, ncorrs)
    if soft_reset is not None:
        reset = torch.as_tensor(soft_reset)
        h = h._replace(ncorr=torch.where(reset, 0, h.ncorr),
                       theta=torch.where(reset, 1.0, h.theta))
        h = _add_pairs(h, rng, (3,) * batch)
    return h


def _at_odd_offset(t):
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _run_case(lib, label, dtype, mode):
    """Relative error of the emulated kernel against the plain version,
    and the copies it issued."""
    batch, n, m, ncorrs, layout, odd, sms = CASES[label]
    h = _history(batch, n, m, ncorrs, seed=m,
                 soft_reset=SOFT_RESET if label == "soft reset" else None)
    row, op, suffix = TYPES[dtype]
    h = type(h)(*(t.to(row if k < 2 else op) if t.is_floating_point()
                  else t for k, t in enumerate(h)))
    v = torch.as_tensor(np.random.default_rng(1).standard_normal((batch, n)),
                        dtype=op)
    if "s" in odd:
        h = h._replace(s=_at_odd_offset(h.s))
    if "v" in odd:
        v = _at_odd_offset(v)
    args = (h.s, h.y, h.ys, h.theta, h.ptr, h.ncorr, h.sy, h.yy, h.rinv, v)
    if op == torch.bfloat16:
        # computed in f32 from the same bf16 inputs, rounded once
        want = fused.two_loop_plain(
            *(t.float() if t is not None and t.is_floating_point() else t
              for t in args), -1.0, mode).to(op).float()
    else:
        want = fused.two_loop_plain(*args, -1.0, mode)
    out = torch.full_like(v, float("nan"))
    pointers = [t.data_ptr() for t in args] + [out.data_ptr(), batch, m, n,
                                               -1.0, fused.MODES[mode]]
    before = (lib.emu_copies(0), lib.emu_copies(1))
    if layout == "simple":
        err = getattr(lib, f"lbfgs_two_loop_simple_{suffix}")(*pointers, None)
    else:
        mat = h.rinv if mode == "rinv" else h.sy
        addresses = {"s": h.s.data_ptr(), "y": h.y.data_ptr(),
                     "mat": mat.data_ptr(), "yy": h.yy.data_ptr(),
                     "v": v.data_ptr(), "ys": h.ys.data_ptr()}
        if layout == "plan":
            plan = fused.launch_plan(batch, m, n, fused.KINDS[row, op], sms,
                                     addresses)
        else:
            plan = fused._layout_plan(batch, m, n, fused.KINDS[row, op], sms,
                                      *layout, addresses)
        err = getattr(lib, f"lbfgs_two_loop_{suffix}")(
            *pointers, plan.warps, plan.stages, plan.grid, int(plan.staged),
            plan.codes, plan.smem_bytes, None)
    if err:
        raise RuntimeError(f"{label}: the host entry refused the launch "
                           f"({err})")
    rel = (out.to(want.dtype) - want).abs().max().item() / \
        want.abs().max().item()
    return {"rel": rel, "bulk": lib.emu_copies(0) - before[0],
            "cp_async": lib.emu_copies(1) - before[1]}


def _main(lib_path):
    """Run every case against the emulated library; print one JSON line."""
    import ctypes
    lib = ctypes.CDLL(lib_path)
    common = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + \
        [ctypes.c_double, ctypes.c_int]
    for t in fused.SIZES:
        getattr(lib, f"lbfgs_two_loop_{t}").argtypes = \
            common + [ctypes.c_int] * 4 + [ctypes.c_uint, ctypes.c_longlong,
                                           ctypes.c_void_p]
    for t in ("f32", "f64"):
        getattr(lib, f"lbfgs_two_loop_simple_{t}").argtypes = \
            common + [ctypes.c_void_p]
    lib.emu_copies.restype = ctypes.c_longlong
    results = {f"{label}|{dtype}|{mode}": _run_case(lib, label, dtype, mode)
               for label in CASES for dtype in DTYPES for mode in MODES
               if not (label == "simple kernel" and dtype in BF16)}
    print(json.dumps(results))


def _probe_compiler(cxx, build):
    probe = os.path.join(build, "probe.cpp")
    with open(probe, "w") as f:
        f.write("#include <barrier>\nint main() { std::barrier b(1); "
                "b.arrive_and_wait(); }\n")
    proc = subprocess.run([cxx, "-std=c++20", "-pthread", probe, "-o",
                           os.path.join(build, "probe")],
                          capture_output=True, text=True, timeout=120)
    return proc.returncode == 0


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the emulated kernel")
    build = str(tmp_path_factory.mktemp("two_loop_emulated"))
    if not _probe_compiler(cxx, build):
        pytest.skip("needs a C++20 compiler with <barrier>")
    with open(os.path.join(CSRC, "two_loop.cu")) as f:
        source = emulated_source(f.read())
    files = {"cuda_runtime.h": EMULATED_RUNTIME,
             "hopper_async.cuh": EMULATED_HOPPER_ASYNC,
             "two_loop_emulated.cpp": source}
    for name, text in files.items():
        with open(os.path.join(build, name), "w") as f:
            f.write(text)
    lib_path = os.path.join(build, "libtwo_loop_emulated.so")
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
         "-I", build, os.path.join(build, "two_loop_emulated.cpp"), "-o",
         lib_path], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    code = (f"import sys; sys.path[:0] = [{os.path.dirname(__file__)!r}, "
            f"{REPO!r}]; import test_torch_two_loop_emulated as t; "
            f"t._main({lib_path!r})")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("label,dtype", [
    pytest.param(label, dtype, id=f"{label}-{dtype}")
    for label in CASES for dtype in DTYPES
    # the first design takes float32 and float64 only
    if not (label == "simple kernel" and dtype in BF16)])
def test_emulated_kernel_matches_plain(emulated, label, dtype, mode):
    assert emulated[f"{label}|{dtype}|{mode}"]["rel"] <= RTOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES[:2])
def test_emulated_copies_follow_the_plan(emulated, dtype):
    """Aligned runs arrive by bulk copies (s, y, mat, yy, v, ys per
    instance) and only the header by cp.async; unstaged, s, y and v are not
    copied at all; rows of n=101 go by cp.async."""
    ring = emulated[f"two-stage ring|{dtype}|rinv"]
    assert (ring["bulk"], ring["cp_async"]) == (6 * 13, 3 * 13)
    unstaged = emulated[f"unstaged|{dtype}|rinv"]
    assert (unstaged["bulk"], unstaged["cp_async"]) == (3 * 3, 3 * 3)
    rows = emulated[f"n=101|{dtype}|rinv"]
    # s, y and v rows one element a piece (no wider granule divides a row
    # of 101), and the header
    assert rows["cp_async"] == 3 * ((2 * 16 + 1) * 101 + 3)


@pytest.mark.parametrize("dtype", DTYPES[2:])
def test_emulated_bf16_copies_follow_the_plan(emulated, dtype):
    """bf16 rows of n=100 (200 bytes) go by 8-byte cp.async; rows of
    n=101 (202 bytes) stay in device memory, so only the [m, m] runs, ys
    and the header are copied; at m=1 the all-bf16 [m, m] runs and ys are
    two bytes each and go by the lanes' own loads (neither bulk copy nor
    cp.async; the rows of n=40 are bulk copies), and its bf16 theta is
    read where it is used (two header copies)."""
    ring = emulated[f"two-stage ring|{dtype}|rinv"]
    # s and y: 16 rows of 25 granules each; v: 25 more in bf16, a bulk
    # copy beside bf16 rows; the header 2 (bf16) or 3
    if dtype == "bfloat16":
        assert ring["cp_async"] == 13 * (2 * 16 * 25 + 25 + 2)
        assert ring["bulk"] == 13 * 3
    else:
        assert ring["cp_async"] == 13 * (2 * 16 * 25 + 3)
        assert ring["bulk"] == 13 * 4
    rows = emulated[f"n=101|{dtype}|rinv"]
    assert rows["bulk"] == 3 * 3
    assert rows["cp_async"] == 3 * (2 if dtype == "bfloat16" else 3)
    if dtype == "bfloat16":
        m1 = emulated[f"m=1|{dtype}|rinv"]
        assert m1["bulk"] == 3 * 3 and m1["cp_async"] == 3 * 2
