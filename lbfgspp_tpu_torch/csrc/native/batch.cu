// The native core on the card: one warp per instance.
//
// Replaces the JAX package's host C++ core (lbfgspp_tpu/native/core.cpp:575,
// the L-BFGS solve, and lbfgsb.cpp:606, the L-BFGS-B solve) where the port
// runs it on its own device: lbfgspp_tpu.native.minimize_batch fans
// independent builtin-objective solves over OS threads (fastcall.cpp,
// fast_minimize_batch); here each instance is one warp running the same
// source (core.h, lbfgsb.h) that the host build compiles, under the Warp
// policy.  No TPU kernel is replaced: the JAX package never ran this solve
// on its device.
//
//   native_lbfgs_batch: L-BFGS on a builtin objective (0 = rosenbrock,
//     1 = quadratic) with any of the four line searches;
//   native_lbfgsb_batch: L-BFGS-B with More-Thuente and per-instance
//     bounds lb, ub [B, n].
//
// native_lbfgs_batch is a template over the policy: Warp, the default, and
// ProbedWarp, the probed kernel, whose lane 0 clocks each solve's phases
// (core.h's X::mark) and writes one record per instance into probe [B, 6]
// (lbfgspp_native_lbfgs_batch_probed).  Every hook of Warp is empty, so the
// default kernel is the code it was without them.
//
// x [B, n] f64 is solved in place; the outputs fx, gnorm (projected for the
// box solve), niter, nfev and status are [B], written by lane 0.  A block
// holds W warps, instance b on warp b % W of block b / W.  Its workspace:
// when W of them fit in the block's shared memory (the plan asks the card,
// lbfgspp_native_plan), the warp's slice of the block's dynamic shared
// memory, with x copied in at the start and out at the end (ws == NULL);
// otherwise row b of ws [B, stride] in device memory.  One code path: only
// the Arena's base pointer differs.
//
// What bounds it: latency, of one instance's serial chain of small vector
// steps.  The first design (one thread per instance, 32 threads a block,
// its workspace in device memory) ran one warp per SM, summed every dot
// over n serially, loaded 32 rows `stride` apart per warp instruction and
// serialized its threads' diverging iterations.  Here lane l owns the
// indices i = l (mod 32): a load is one contiguous row segment, a
// reduction is the lane's few terms and five shuffles (core.h), the
// history never leaves the SM, and 12 instances (n = 100, m = 6) share an
// SM to hide each other's latency.  What remains serial is the scalar
// logic every lane runs (the searches' interpolation, the box core's
// Cauchy break points, sort and LU factorizations, on lane 0), and at
// n = 10 22 of 32 lanes idle; packing instances into one warp would bring
// back the divergence.  The box kernel spills at any register cap.
#include <cuda_runtime.h>

#include "core.h"
#include "lbfgsb.h"

namespace ln = lbfgspp_native;

namespace {

constexpr unsigned kAll = 0xffffffffu;
// The plan's largest block (a kernel's __launch_bounds__ may allow fewer).
constexpr int kMaxWarps = 8;
// Each kernel's __launch_bounds__: blocks of at most kBoundThreads threads
// (two warps of one instance each), k of them an SM, which caps a
// thread's registers at 65536 / (64 k).  An SM allots registers by
// quarters, a warp's in one quarter of 16384, so k = 6 (168 registers)
// keeps 12 warps an SM, 8 (128) 16, 12 (80) 24 and 16 (64) 32.  L-BFGS
// takes 168 with no spill (186 uncapped: 8 warps an SM; its 16.9 KB of
// shared memory a warp at n = 100 allows 12-13); the box kernel spills at
// any cap (32 bytes at 255), and 64 registers, 28 warps an SM at n = 10,
// ran fastest (tools/native_study.py --bounds, on the H100).
constexpr int kBoundThreads = 2 * ln::kWarp;
#ifndef LBFGSPP_LBFGS_MIN_BLOCKS
#define LBFGSPP_LBFGS_MIN_BLOCKS 6
#endif
#ifndef LBFGSPP_LBFGSB_MIN_BLOCKS
#define LBFGSPP_LBFGSB_MIN_BLOCKS 16
#endif

// The card's policy (core.h): lane l of the instance's warp owns the
// indices i = l (mod 32).
struct Warp {
  __device__ static __forceinline__ int lane() {
    return static_cast<int>(threadIdx.x) % ln::kWarp;
  }
  template <class Fn>
  __device__ static __forceinline__ void each(int n, const Fn& fn) {
    for (int i = lane(); i < n; i += ln::kWarp) fn(i);
    __syncwarp();
  }
  // The lane's terms in index order, then the butterfly, each step folding
  // the lower lane's value with the higher lane's.
  template <class Fn, class Op>
  __device__ static __forceinline__ double reduce(int n, double init,
                                                  const Fn& term, Op op) {
    const int l = lane();
    double r = init;
    for (int i = l; i < n; i += ln::kWarp) r = op(r, term(i));
    for (int off = ln::kWarp / 2; off >= 1; off /= 2) {
      const double o = __shfl_xor_sync(kAll, r, off);
      r = (l & off) ? op(o, r) : op(r, o);
    }
    return r;
  }
  template <class P>
  __device__ static __forceinline__ bool any(int n, const P& pred) {
    bool a = false;
    for (int i = lane(); i < n && !a; i += ln::kWarp) a = pred(i);
    const bool r = __ballot_sync(kAll, a) != 0u;
    __syncwarp();
    return r;
  }
  // Each window of 32 indices: a ballot of the predicate, and each lane
  // whose index is in puts it at the count of the lanes below it.
  template <class P, class W>
  __device__ static __forceinline__ int compact(int n, const P& pred,
                                                const W& put) {
    const int l = lane();
    const unsigned below = (1u << l) - 1u;
    int k = 0;
    for (int base = 0; base < n; base += ln::kWarp) {
      const int i = base + l;
      const bool p = i < n && pred(i);
      const unsigned mask = __ballot_sync(kAll, p);
      if (p) put(k + __popc(mask & below), i);
      k += __popc(mask);
    }
    __syncwarp();
    return k;
  }
  template <class T>
  __device__ static __forceinline__ void put(T* p, T v) {
    if (lane() == 0) *p = v;
  }
  __device__ static __forceinline__ void sync() { __syncwarp(); }
  __device__ static __forceinline__ bool leader() { return lane() == 0; }
  // The probe's hooks (ProbedWarp's, below): nothing here.
  __device__ static __forceinline__ void mark(ln::Boundary) {}
  __device__ static __forceinline__ void begin() {}
  __device__ static __forceinline__ void end(long long) {}
  template <class F>
  using Objective = F;
};

// The card's wall clock, in nanoseconds.
__device__ __forceinline__ long long globaltimer_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A probe record, per instance: start_ns, end_ns (%globaltimer at the
// warp's entry into its slot and after its outputs are written), then the
// SM cycles (clock64) of the whole slot, of the objective's evaluations,
// of the line searches without their evaluations, and of the new
// directions.
constexpr int kProbeFields = 6;
// Lane 0's running state, a row per warp of the block (as many as the
// launch bounds allow; a probed launch of more warps is refused): [0]
// clock64 at the last search's or direction's begin (kNever before the
// first), [1] at the last evaluation's begin, [2] clock64 and [3]
// %globaltimer at the entry, [4, 5, 6] the cycles of eval, search and
// direction so far.
constexpr int kProbeWarps = kBoundThreads / ln::kWarp;
constexpr long long kNever = 0x7fffffffffffffffLL;
__shared__ long long probe_state[kProbeWarps][7];

// The probed kernel's policy: Warp, with lane 0 clocking the phases (the
// warp runs the solve's scalar chain in lockstep, so lane 0's clock is the
// warp's).  Each mark is static (its boundary is a constant where it is
// inlined) and taken by lane 0 alone: a clock read, at most one round of
// independent shared-memory loads, and its stores.  Branching the other
// lanes around it cost less than predicating their stores off (0.6-1.0%
// of the kernel's time against 1.6-2.4%, on the H100 at the multistart's
// shape), and the state lives in shared memory, not in registers, so the
// solve keeps its registers.
struct ProbedWarp : Warp {
  __device__ static __forceinline__ long long* state() {
    return probe_state[threadIdx.x / ln::kWarp];
  }
  __device__ static __forceinline__ void begin() {
    if (lane() != 0) return;
    long long* s = state();
    s[2] = clock64();
    s[3] = globaltimer_ns();
    s[0] = kNever;
    s[4] = s[5] = s[6] = 0;
  }
  __device__ static __forceinline__ void mark(ln::Boundary m) {
    if (lane() != 0) return;
    long long* s = state();
    const long long now = clock64();
    switch (m) {
      case ln::kSearchBegin:
      case ln::kDirectionBegin: s[0] = now; break;
      case ln::kEvalBegin: s[1] = now; break;
      case ln::kSearchEnd: s[5] += now - s[0]; break;
      case ln::kDirectionEnd: s[6] += now - s[0]; break;
      case ln::kEvalEnd: {
        const long long d = now - s[1];
        s[4] += d;
        // An evaluation that began after the last search's begin is that
        // search's (the first evaluation precedes every search, and none
        // falls in a direction): the search's cycles leave it out.
        if (s[1] > s[0]) s[5] -= d;
        break;
      }
    }
  }
  __device__ static __forceinline__ void end(long long b, long long* probe) {
    if (lane() != 0) return;
    const long long* s = state();
    long long* r = probe + b * kProbeFields;
    const long long now = clock64();
    r[1] = globaltimer_ns();
    r[0] = s[3];
    r[2] = now - s[2];
    r[3] = s[4];
    r[4] = s[5];
    r[5] = s[6];
  }
  // The objective, each call marked as an evaluation.
  template <class F>
  struct Objective {
    F f;
    template <class X>
    __device__ double operator()(X, const double* x, double* grad,
                                 int n) const {
      mark(ln::kEvalBegin);
      const double fx = f(X{}, x, grad, n);
      mark(ln::kEvalEnd);
      return fx;
    }
  };
};

// A warp's doubles in shared memory: x [n], then its workspace.
__host__ __device__ long long shared_stride(long long ws_bytes, int n) {
  return n + (ws_bytes + 7) / 8;
}

// Instance b's warp, its x and its workspace; x copied into shared memory.
struct Slot {
  long long b;
  double* x;
  double* ws;
};

__device__ Slot slot(long long batch, int n, double* xs, double* ws,
                     long long stride) {
  extern __shared__ double native_smem[];
  const int warp = static_cast<int>(threadIdx.x) / ln::kWarp;
  const long long b =
      static_cast<long long>(blockIdx.x) * (blockDim.x / ln::kWarp) + warp;
  if (b >= batch) return {b, nullptr, nullptr};
  double* x = xs + b * n;
  if (ws != nullptr) return {b, x, ws + b * stride};
  double* mine = native_smem + warp * stride;
  Warp::each(n, [&](int i) { mine[i] = x[i]; });
  return {b, mine, mine + n};
}

__device__ void finish(const Slot& s, int n, double* xs, bool shared,
                       int st, int* status) {
  if (shared) {
    double* x = xs + s.b * n;
    Warp::each(n, [&](int i) { x[i] = s.x[i]; });
  }
  if (Warp::leader()) status[s.b] = st;
}

// W = Warp, or ProbedWarp with Probe = long long* (the records).
template <class W, class... Probe>
__global__ void __launch_bounds__(kBoundThreads, LBFGSPP_LBFGS_MIN_BLOCKS)
    native_lbfgs_batch(int builtin_id, long long batch, int n, double* xs,
                       ln::Params p, int ls_kind, double* ws,
                       long long stride, double* fx, double* gnorm,
                       int* niter, int* nfev, int* status, Probe... probe) {
  W::begin();
  const Slot s = slot(batch, n, xs, ws, stride);
  if (s.x == nullptr) return;
  const long long b = s.b;
  const int st =
      builtin_id == 0
          ? ln::minimize<W>(typename W::template Objective<ln::Rosenbrock>{},
                            n, s.x, p, ls_kind, s.ws, fx + b, gnorm + b,
                            niter + b, nfev + b)
          : ln::minimize<W>(typename W::template Objective<ln::Quadratic>{},
                            n, s.x, p, ls_kind, s.ws, fx + b, gnorm + b,
                            niter + b, nfev + b);
  finish(s, n, xs, ws == nullptr, st, status);
  W::end(b, probe...);
}

__global__ void __launch_bounds__(kBoundThreads, LBFGSPP_LBFGSB_MIN_BLOCKS)
    native_lbfgsb_batch(int builtin_id, long long batch, int n, double* xs,
                        const double* lb, const double* ub, ln::ParamsB p,
                        double* ws, long long stride, double* fx,
                        double* pgnorm, int* niter, int* nfev, int* status) {
  const Slot s = slot(batch, n, xs, ws, stride);
  if (s.x == nullptr) return;
  const long long b = s.b;
  const int st =
      builtin_id == 0
          ? ln::minimize_b<Warp>(ln::Rosenbrock{}, n, s.x, lb + b * n,
                                 ub + b * n, p, s.ws, fx + b, pgnorm + b,
                                 niter + b, nfev + b)
          : ln::minimize_b<Warp>(ln::Quadratic{}, n, s.x, lb + b * n,
                                 ub + b * n, p, s.ws, fx + b, pgnorm + b,
                                 niter + b, nfev + b);
  finish(s, n, xs, ws == nullptr, st, status);
}

// Allow the kernel `bytes` of dynamic shared memory a block (refused past
// the card's opt-in limit).
template <class K>
cudaError_t allow_shared(K kernel, long long bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The plan of a kernel whose warps take `ws_bytes` of workspace each: the
// warps W per block (1 to kMaxWarps, as its launch bounds allow) that keep
// the most warps resident on an SM (the fewest of them on a tie: a block
// holds its shared memory until its slowest instance ends), with the
// workspace in shared memory when one warp's fits the card's opt-in limit,
// else in device memory.
template <class K>
cudaError_t plan(K kernel, long long ws_bytes, int n, int* warps,
                 int* blocks_per_sm, long long* shared_bytes) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const long long per_warp = 8 * shared_stride(ws_bytes, n);
  const bool shared = per_warp <= optin;
  const int max_w = attr.maxThreadsPerBlock / ln::kWarp;
  int best_w = 0, best_blocks = 0;
  for (int w = 1; w <= kMaxWarps && w <= max_w; ++w) {
    const long long bytes = shared ? w * per_warp : 0;
    if (bytes > optin) break;
    if (shared) {
      err = allow_shared(kernel, bytes);
      if (err != cudaSuccess) return err;
    }
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, w * ln::kWarp, static_cast<size_t>(bytes));
    if (err != cudaSuccess) return err;
    if (blocks * w > best_blocks * best_w) {
      best_w = w;
      best_blocks = blocks;
    }
  }
  if (best_w == 0) return cudaErrorInvalidConfiguration;
  *warps = best_w;
  *blocks_per_sm = best_blocks;
  *shared_bytes = shared ? best_w * per_warp : 0;
  return cudaSuccess;
}

// Shared placement (ws == NULL): the block's bytes, allowed for the kernel.
template <class K>
cudaError_t shared_launch_bytes(K kernel, long long ws_bytes, int n,
                                int warps, long long* bytes,
                                long long* stride) {
  *stride = shared_stride(ws_bytes, n);
  *bytes = 8LL * warps * *stride;
  return allow_shared(kernel, *bytes);
}

// Launch native_lbfgs_batch<W, Probe...> (lbfgspp_native_lbfgs_batch).
template <class W, class... Probe>
int launch_lbfgs(int builtin_id, long long batch, int n, double* xs,
                 const ln::Params* p, int ls_kind, double* ws,
                 long long stride, int warps, double* fx, double* gnorm,
                 int* niter, int* nfev, int* status, cudaStream_t stream,
                 Probe... probe) {
  if (batch <= 0) return 0;
  if (warps < 1 || (sizeof...(Probe) > 0 && warps > kProbeWarps))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = native_lbfgs_batch<W, Probe...>;
  long long bytes = 0;
  if (ws == nullptr) {
    const cudaError_t err = shared_launch_bytes(
        kernel, ln::native_workspace(n, p->m, p->past), n, warps, &bytes,
        &stride);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long grid = (batch + warps - 1) / warps;
  kernel<<<static_cast<unsigned>(grid), warps * ln::kWarp, static_cast<size_t>(bytes), stream>>>(builtin_id, batch, n, xs, *p, ls_kind, ws, stride, fx, gnorm, niter, nfev, status, probe...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

long long lbfgspp_native_workspace(int n, int m, int past) {
  return ln::native_workspace(n, m, past);
}

long long lbfgspp_native_workspace_b(int n, int m, int past) {
  return ln::native_workspace_b(n, m, past);
}

const char* lbfgspp_native_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan of native_lbfgs_batch (kernel = 0), native_lbfgsb_batch
// (1) or the probed native_lbfgs_batch (2) at (n, m, past) on the current
// device: warps per block, blocks resident per SM, and the block's dynamic
// shared memory (0: the workspace is a row of device memory).  Returns a
// cudaError_t.
int lbfgspp_native_plan(int kernel, int n, int m, int past, int* warps,
                        int* blocks_per_sm, long long* shared_bytes) {
  const long long ws = ln::native_workspace(n, m, past);
  switch (kernel) {
    case 0: return static_cast<int>(plan(native_lbfgs_batch<Warp>, ws, n,
                                         warps, blocks_per_sm, shared_bytes));
    case 1: return static_cast<int>(
        plan(native_lbfgsb_batch, ln::native_workspace_b(n, m, past), n,
             warps, blocks_per_sm, shared_bytes));
    case 2: return static_cast<int>(
        plan(native_lbfgs_batch<ProbedWarp, long long*>, ws, n, warps,
             blocks_per_sm, shared_bytes));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch native_lbfgs_batch on `stream`, `warps` instances a block, the
// workspace in shared memory (ws == NULL) or in ws [batch, stride];
// returns the first CUDA error (the shared-memory limit, the launch).
int lbfgspp_native_lbfgs_batch(int builtin_id, long long batch, int n,
                               double* xs, const ln::Params* p, int ls_kind,
                               double* ws, long long stride, int warps,
                               double* fx, double* gnorm, int* niter,
                               int* nfev, int* status, cudaStream_t stream) {
  return launch_lbfgs<Warp>(builtin_id, batch, n, xs, p, ls_kind, ws, stride,
                            warps, fx, gnorm, niter, nfev, status, stream);
}

// The same launch of the probed kernel (plan 2), which writes instance b's
// record to probe[6 b .. 6 b + 5] (kProbeFields).
int lbfgspp_native_lbfgs_batch_probed(int builtin_id, long long batch, int n,
                                      double* xs, const ln::Params* p,
                                      int ls_kind, double* ws,
                                      long long stride, int warps, double* fx,
                                      double* gnorm, int* niter, int* nfev,
                                      int* status, cudaStream_t stream,
                                      long long* probe) {
  return launch_lbfgs<ProbedWarp>(builtin_id, batch, n, xs, p, ls_kind, ws,
                                  stride, warps, fx, gnorm, niter, nfev,
                                  status, stream, probe);
}

// Launch native_lbfgsb_batch likewise.
int lbfgspp_native_lbfgsb_batch(int builtin_id, long long batch, int n,
                                double* xs, const double* lb,
                                const double* ub, const ln::ParamsB* p,
                                double* ws, long long stride, int warps,
                                double* fx, double* pgnorm, int* niter,
                                int* nfev, int* status, cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  long long bytes = 0;
  if (ws == nullptr) {
    const cudaError_t err = shared_launch_bytes(
        native_lbfgsb_batch, ln::native_workspace_b(n, p->m, p->past), n,
        warps, &bytes, &stride);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long grid = (batch + warps - 1) / warps;
  native_lbfgsb_batch<<<static_cast<unsigned>(grid), warps * ln::kWarp, static_cast<size_t>(bytes), stream>>>(builtin_id, batch, n, xs, lb, ub, *p, ws, stride, fx, pgnorm, niter, nfev, status);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
