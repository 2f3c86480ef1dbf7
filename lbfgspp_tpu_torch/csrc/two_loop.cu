// Batched L-BFGS two-loop direction `out = a * H * v` for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels `_batched_fused` and
// `_batched_fused_mmajor` (lbfgspp_tpu/ops/fused.py:111-151, :265-307), and
// also serves the incremental-R^{-1} schedule of
// lbfgspp_tpu/ops/history.py:358-372, which the batched main phase runs.
//
// What it computes, per instance b (slot order, ring distance
// dist_i = (ptr - 1 - i) mod m, valid_i = dist_i < ncorr):
//   sv = S v, yv = Y v                                  (pass 1, 2m dots)
//   sweeps: m masked Jacobi sweeps
//             alpha = vmask * (a sv - msy alpha) / ys_safe
//           base = (a yv - yy alpha) / theta
//           m sweeps  beta = vmask * (base + msyT (alpha - beta)) / ys_safe
//   rinv:   alpha = R^{-1} (a sv),  base = (a yv - yy alpha) / theta,
//           beta  = vmask * (alpha - R^{-T} (ys * alpha - base))
//   out = (a / theta) v + S^T w_s + Y^T w_y,            (pass 2)
//         w_s = valid ? alpha - beta : 0,  w_y = valid ? -alpha / theta : 0
// msy[i][j] = sy[i][j] where slot j is newer than slot i (both valid),
// msyT[i][j] = sy[j][i] where slot j is older; both are built here from the
// integer ring state instead of being read as three [B, m, m] mask tensors.
//
// What bounds it: memory.  At the main phase's shape (B=4096, m=16, n=100,
// f32) one call reads s and y (52.4 MB), two [m, m] matrices (8.4 MB), v,
// and writes out: ~64 MB, ~19 us at 3.35 TB/s.  The flops (8 m n + O(m^3)
// per instance) are ~1 per byte, so there is nothing for the tensor cores
// (wgmma) to do: the work is matvecs and [m, m] scalar recursions.  What
// stands between a simple kernel and that bound is latency: each instance
// is a short dependent chain (load -> 2m dots -> recursion -> combine) on
// ~15 KB, so the card reaches its memory rate only if many instances' bytes
// are in flight while others compute.
//
// Design of `two_loop_kernel` (the main kernel):
// - A warp per instance, several warps per block, a persistent grid.  Block
//   k owns an even, contiguous share of the batch; its warps take instances
//   one at a time from a shared-memory counter, so the SMs finish together
//   (a fixed stride over all warps left some SMs 35 instances and others
//   28 at B=4096).  No block-wide barrier lies on an instance's path: a
//   warp waits only for its own copies (mbarrier / cp.async groups) and its
//   own lanes (__syncwarp).
// - Each warp owns a ring of `stages` shared-memory stages.  A stage holds
//   one instance's s and y rows, its two [m, m] operands (sy or rinv, and
//   yy), v, ys and a 16-byte header (theta, ptr, ncorr).  While instance k
//   runs its dots, recursion and combine from stage k % stages, the copies
//   of the next stages - 1 instances are in flight, so every byte is read
//   from device memory once and loads overlap the serial recursion.
// - Copies.  A run whose address and size are multiples of 16 bytes (s[b]
//   and y[b] at n * sizeof(T) % 16 == 0, the [m, m] runs, v[b], ys[b])
//   goes by Hopper's bulk asynchronous copy (the 1-D form of TMA), issued
//   by lane 0 and completing on the stage's mbarrier.  Any other run (n=101,
//   a view at an odd storage offset, m=1) goes by 4-, 8- or 16-byte
//   `cp.async` from all 32 lanes, as the largest granule the address and
//   row size allow; the header is always three small `cp.async`s.  The
//   launch plan (ops/fused.py: launch_plan) picks the path per operand and
//   the host entry below checks the addresses against it.
// - Shared rows have a stride `ld` = n rounded up to a 16-byte multiple,
//   zero-padded once at kernel start, so both passes read 16-byte vectors
//   (float4 / double2) whatever n is.
// - Pass 1 maps rows to lanes: at m=16 each of the 32 lanes owns one of the
//   2m rows and walks it in 16-byte vectors (v is a broadcast read); with
//   fewer rows, 2^k lanes share a row and reduce with xor shuffles.
// - The recursion gives each row of an [m, m] matvec 2^k lanes (two at
//   m=16), each summing a strided half of the columns, then one xor
//   shuffle per matvec.  The column order is staggered by row, which keeps
//   the shared reads of sy / rinv / yy at most 2-way bank-conflicted.
//   `sweeps` keeps its m + m masked Jacobi sweeps; at compile-time m each
//   lane keeps its masked coefficients in registers and the row values
//   travel by shuffles, otherwise they ping-pong through shared memory.
// - Pass 2 puts lanes along n, one 16-byte vector each (25 of 32 lanes at
//   n=100 in f32), and sums the 2m weighted rows from shared memory; the
//   output is stored as vectors when its rows are 16-byte aligned.
// - Compile-time m for 6 (the reference's default) and 16 (the main
//   path's); any other m takes the same code with m at run time.
// - Where no staged layout fits, or where the rows go by cp.async and
//   staging them would leave fewer than four warps on an SM (at m=16: odd
//   n beyond 416 in f32, 198 in f64), the plan leaves s, y and v in device
//   memory ("unstaged"): the stages hold the [m, m] runs, ys and the
//   header, and both passes walk the rows along n with the lanes, as the
//   first design did; the combine's second read mostly hits L2.  Rows
//   that go by bulk copy are staged down to one warp per SM: one copy
//   keeps a whole run in flight, and one read beats two.
// - The plan fills each SM with as many stage buffers as its shared memory
//   and registers allow (launch bounds: 128 registers a thread in f32, so
//   16 warps fit, 255 in f64), preferring the deeper ring on a tie: at the
//   main shape 7 warps x 2 stages in f32 and 7 warps x 1 stage in f64,
//   where a second stage would cost four of the seven warps.  Past one
//   unstaged stage of one warp (large m) the wrapper raises.
// A copy that never lands would leave a warp spinning on its mbarrier; the
// wait traps after ~2 s of cycles instead, so a fault ends the launch with
// an error rather than hanging the card.
//
// `two_loop_simple_kernel` is the first design (one 128-thread block per
// instance, the recursion on one warp, rows re-read through L1).  Nothing
// on the solver's path launches it: it is kept as a yardstick that the
// card tests and chip_smoke.py time in turns with the main kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

constexpr int kModeSweeps = 0;
constexpr int kModeRinv = 1;
constexpr int kMaxWarps = 8;
constexpr int kMaxStages = 2;

// Operand order of the packed copy codes (2 bits each): 0 = bulk copy,
// 1 / 2 / 3 = cp.async of 4 / 8 / 16 bytes.
enum Operand { kS = 0, kY, kMat, kYy, kV, kYs, kNumOperands };

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

// ---------------------------------------------------------------------
// The first design, kept as a yardstick.

// Shared memory: two [m, m] matrices (sy or rinv, then yy), eight [m]
// vectors, then the [m] int ring distances.
template <typename T>
__host__ __device__ size_t simple_smem_bytes(int m) {
  return (2 * (size_t)m * m + 8 * (size_t)m) * sizeof(T) + (size_t)m * sizeof(int);
}

constexpr int kSimpleThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kSimpleThreads) two_loop_simple_kernel(
    const T* __restrict__ s, const T* __restrict__ y, const T* __restrict__ ys,
    const T* __restrict__ theta, const int* __restrict__ ptr,
    const int* __restrict__ ncorr, const T* __restrict__ sy,
    const T* __restrict__ yy, const T* __restrict__ rinv,
    const T* __restrict__ v, T* __restrict__ out, int m, int n, T a,
    int mode) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t mm = (size_t)m * m;
  T* mat = reinterpret_cast<T*>(smem_raw);  // sy (sweeps) or rinv (rinv)
  T* yys = mat + mm;
  T* sv = yys + mm;
  T* yv = sv + m;
  T* ysv = yv + m;
  T* alpha = ysv + m;
  T* beta = alpha + m;
  T* tmp = beta + m;
  T* ws = tmp + m;
  T* wy = ws + m;
  int* dist = reinterpret_cast<int*>(wy + m);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const T* sb = s + (size_t)b * m * n;
  const T* yb = y + (size_t)b * m * n;
  const T* vb = v + (size_t)b * n;
  T* ob = out + (size_t)b * n;
  const int p = ptr[b];
  const int nc = ncorr[b];
  const T th = theta[b];

  // Stage the [m, m] operands and the ring state.
  const T* mat_src = (mode == kModeRinv ? rinv : sy) + (size_t)b * mm;
  const T* yy_src = yy + (size_t)b * mm;
  for (size_t i = tid; i < mm; i += blockDim.x) {
    mat[i] = mat_src[i];
    yys[i] = yy_src[i];
  }
  for (int i = tid; i < m; i += blockDim.x) {
    ysv[i] = ys[(size_t)b * m + i];
    // floor remainder: C++ % truncates toward zero
    dist[i] = (((p - 1 - i) % m) + m) % m;
  }

  // Pass 1: the 2m dots, one warp per row, lanes strided along n.
  for (int r = warp; r < 2 * m; r += nwarps) {
    const T* row = r < m ? sb + (size_t)r * n : yb + (size_t)(r - m) * n;
    T acc = T(0);
    for (int k = lane; k < n; k += 32) acc += row[k] * vb[k];
    acc = warp_sum(acc);
    if (lane == 0) {
      if (r < m) sv[r] = acc; else yv[r - m] = acc;
    }
  }
  __syncthreads();

  // The O(m^2)-per-sweep recursion, on one warp; lanes own rows.
  if (warp == 0) {
    if (mode == kModeSweeps) {
      for (int i = lane; i < m; i += 32) alpha[i] = T(0);
      __syncwarp();
      for (int sweep = 0; sweep < m; ++sweep) {
        for (int i = lane; i < m; i += 32) {
          const bool vi = dist[i] < nc;
          T acc = T(0);
          for (int j = 0; j < m; ++j) {
            const bool newer = vi && dist[j] < nc && dist[j] < dist[i];
            acc += newer ? mat[(size_t)i * m + j] * alpha[j] : T(0);
          }
          const T vm = vi ? T(1) : T(0);
          const T ysafe = vi ? ysv[i] : T(1);
          tmp[i] = vm * (a * sv[i] - acc) / ysafe;
        }
        __syncwarp();
        for (int i = lane; i < m; i += 32) alpha[i] = tmp[i];
        __syncwarp();
      }
      // tmp <- base
      for (int i = lane; i < m; i += 32) {
        T acc = T(0);
        for (int j = 0; j < m; ++j) acc += yys[(size_t)i * m + j] * alpha[j];
        tmp[i] = (a * yv[i] - acc) / th;
        beta[i] = T(0);
      }
      __syncwarp();
      for (int sweep = 0; sweep < m; ++sweep) {
        for (int i = lane; i < m; i += 32) {
          const bool vi = dist[i] < nc;
          T acc = T(0);
          for (int j = 0; j < m; ++j) {
            const bool older = vi && dist[j] < nc && dist[j] > dist[i];
            acc += older ? mat[(size_t)j * m + i] * (alpha[j] - beta[j]) : T(0);
          }
          const T vm = vi ? T(1) : T(0);
          const T ysafe = vi ? ysv[i] : T(1);
          ws[i] = vm * (tmp[i] + acc) / ysafe;  // ws doubles as the buffer
        }
        __syncwarp();
        for (int i = lane; i < m; i += 32) beta[i] = ws[i];
        __syncwarp();
      }
    } else {
      for (int i = lane; i < m; i += 32) {
        T acc = T(0);
        for (int j = 0; j < m; ++j) acc += mat[(size_t)i * m + j] * (a * sv[j]);
        alpha[i] = acc;
      }
      __syncwarp();
      // tmp <- ys * alpha - base
      for (int i = lane; i < m; i += 32) {
        T acc = T(0);
        for (int j = 0; j < m; ++j) acc += yys[(size_t)i * m + j] * alpha[j];
        const T base = (a * yv[i] - acc) / th;
        tmp[i] = ysv[i] * alpha[i] - base;
      }
      __syncwarp();
      for (int i = lane; i < m; i += 32) {
        T acc = T(0);
        for (int j = 0; j < m; ++j) acc += mat[(size_t)j * m + i] * tmp[j];
        const T vm = dist[i] < nc ? T(1) : T(0);
        beta[i] = vm * (alpha[i] - acc);
      }
      __syncwarp();
    }
    for (int i = lane; i < m; i += 32) {
      const bool vi = dist[i] < nc;
      ws[i] = vi ? alpha[i] - beta[i] : T(0);
      wy[i] = vi ? -alpha[i] / th : T(0);
    }
  }
  __syncthreads();

  // Pass 2: the combine, threads along n; the rows are L1-resident.
  const T scale = a / th;
  for (int k = tid; k < n; k += blockDim.x) {
    T acc_s = T(0);
    T acc_y = T(0);
    for (int j = 0; j < m; ++j) {
      acc_s += ws[j] * sb[(size_t)j * n + k];
      acc_y += wy[j] * yb[(size_t)j * n + k];
    }
    ob[k] = (scale * vb[k] + acc_s) + acc_y;
  }
}

// ---------------------------------------------------------------------
// The main kernel: a warp per instance, staged by asynchronous copies.

// 16-byte vectors of T.
template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int N = 4;
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void fma(float4& acc, float w, float4 x) {
    acc.x = fmaf(w, x.x, acc.x);
    acc.y = fmaf(w, x.y, acc.y);
    acc.z = fmaf(w, x.z, acc.z);
    acc.w = fmaf(w, x.w, acc.w);
  }
  static __device__ __forceinline__ void fma(float4& acc, float4 w, float4 x) {
    acc.x = fmaf(w.x, x.x, acc.x);
    acc.y = fmaf(w.y, x.y, acc.y);
    acc.z = fmaf(w.z, x.z, acc.z);
    acc.w = fmaf(w.w, x.w, acc.w);
  }
  static __device__ __forceinline__ float sum(float4 x) {
    return (x.x + x.y) + (x.z + x.w);
  }
  // (a + b) + c elementwise
  static __device__ __forceinline__ float4 add3(float4 a, float4 b, float4 c) {
    return make_float4((a.x + b.x) + c.x, (a.y + b.y) + c.y,
                       (a.z + b.z) + c.z, (a.w + b.w) + c.w);
  }
  static __device__ __forceinline__ float get(float4 x, int e) {
    return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
  }
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int N = 2;
  static __device__ __forceinline__ double2 zero() {
    return make_double2(0.0, 0.0);
  }
  static __device__ __forceinline__ void fma(double2& acc, double w, double2 x) {
    acc.x = ::fma(w, x.x, acc.x);
    acc.y = ::fma(w, x.y, acc.y);
  }
  static __device__ __forceinline__ void fma(double2& acc, double2 w, double2 x) {
    acc.x = ::fma(w.x, x.x, acc.x);
    acc.y = ::fma(w.y, x.y, acc.y);
  }
  static __device__ __forceinline__ double sum(double2 x) { return x.x + x.y; }
  static __device__ __forceinline__ double2 add3(double2 a, double2 b,
                                                 double2 c) {
    return make_double2((a.x + b.x) + c.x, (a.y + b.y) + c.y);
  }
  static __device__ __forceinline__ double get(double2 x, int e) {
    return e == 0 ? x.x : x.y;
  }
};

__host__ __device__ constexpr int pow2_floor(int x) {
  int p = 1;
  while (p * 2 <= x) p *= 2;
  return p;
}

// Lanes per row of an [m, m] matvec, and the columns each lane sums.
__host__ __device__ constexpr int lanes_per_row(int m) {
  return m <= 16 ? pow2_floor(32 / m) : 1;
}

__host__ __device__ constexpr int cols_per_lane(int m) {
  return (m + lanes_per_row(m) - 1) / lanes_per_row(m);
}

__host__ __device__ constexpr int round16(long long x) {
  return (int)((x + 15) / 16 * 16);
}

// Byte offsets of one warp's shared memory.  ops/fused.py: _layout
// computes the same numbers for the launch plan; the host entry checks
// that the plan's total agrees.
struct Layout {
  int ld;                   // shared row stride of s / y / v, in elements
  int staged;               // 0: s, y and v stay in device memory
  int off_s, off_y, off_mat, off_yy, off_v, off_ys, off_hdr;
  int stage_bytes;          // one stage, 16-byte multiple
  int scratch_bytes;        // the warp's recursion vectors
  int bar_bytes;            // the block's counter and all mbarriers
  int warp_bytes;           // stages * stage_bytes + scratch_bytes
  long long smem_bytes;     // the block's total
};

template <typename T>
Layout make_layout(int m, int n, int warps, int stages, int staged) {
  Layout L;
  const int vn = 16 / (int)sizeof(T);
  L.ld = (n + vn - 1) / vn * vn;
  L.staged = staged;
  const long long row = staged ? (long long)L.ld * sizeof(T) : 0;
  long long o = 0;
  L.off_s = (int)o;   o += round16((long long)m * row);
  L.off_y = (int)o;   o += round16((long long)m * row);
  L.off_mat = (int)o; o += round16((long long)m * m * sizeof(T));
  L.off_yy = (int)o;  o += round16((long long)m * m * sizeof(T));
  L.off_v = (int)o;   o += round16(row);
  L.off_ys = (int)o;  o += round16((long long)m * sizeof(T));
  L.off_hdr = (int)o; o += 16;  // theta at 0, ptr at 8, ncorr at 12
  L.stage_bytes = (int)o;
  L.scratch_bytes = round16(9LL * m * sizeof(T) + 4LL * m);
  L.bar_bytes = 16 + round16(8LL * warps * stages);  // counter, mbarriers
  L.warp_bytes = stages * L.stage_bytes + L.scratch_bytes;
  L.smem_bytes = (long long)L.bar_bytes + (long long)warps * L.warp_bytes;
  return L;
}

template <typename T>
struct Args {
  const T* s;
  const T* y;
  const T* ys;
  const T* theta;
  const int* ptr;
  const int* ncorr;
  const T* mat;   // sy (sweeps) or rinv (rinv)
  const T* yy;
  const T* v;
  T* out;
  int batch, m, n, mode, warps, stages;
  unsigned codes;
  T a;
  Layout L;
};

__device__ __forceinline__ int granule_of(unsigned codes, int op) {
  const int c = (codes >> (2 * op)) & 3;
  return c == 0 ? 0 : (2 << c);  // 1 -> 4, 2 -> 8, 3 -> 16
}

// Copy instance b into `stage`.  Lane 0 arms the stage's mbarrier with the
// bulk bytes and issues the bulk copies; every lane issues its share of the
// cp.async copies and commits one group (empty or not, so that the group
// count per instance stays one).
template <typename T>
__device__ __forceinline__ void issue_copies(const Args<T>& A, int b,
                                             unsigned char* stage,
                                             uint32_t bar, int lane) {
  const Layout& L = A.L;
  const int m = A.m, n = A.n;
  const long long rowb = (long long)n * sizeof(T);     // one s / y / v row
  const long long mmb = (long long)m * m * sizeof(T);  // one [m, m] run
  struct Run {
    const unsigned char* src;
    int off, rows, dst_stride;
    long long row_bytes;
  };
  const Run runs[kNumOperands] = {
      {reinterpret_cast<const unsigned char*>(A.s) + (size_t)b * m * rowb,
       L.off_s, m, L.ld * (int)sizeof(T), rowb},
      {reinterpret_cast<const unsigned char*>(A.y) + (size_t)b * m * rowb,
       L.off_y, m, L.ld * (int)sizeof(T), rowb},
      {reinterpret_cast<const unsigned char*>(A.mat) + (size_t)b * mmb,
       L.off_mat, 1, 0, mmb},
      {reinterpret_cast<const unsigned char*>(A.yy) + (size_t)b * mmb,
       L.off_yy, 1, 0, mmb},
      {reinterpret_cast<const unsigned char*>(A.v) + (size_t)b * rowb,
       L.off_v, 1, 0, rowb},
      {reinterpret_cast<const unsigned char*>(A.ys) +
           (size_t)b * m * sizeof(T),
       L.off_ys, 1, 0, (long long)(m * sizeof(T))},
  };
  const uint32_t base = smem_addr(stage);
  // Unstaged, s, y and v are read from device memory where they are used.
  auto copied = [&](int op) {
    return L.staged || (op != kS && op != kY && op != kV);
  };
  if (lane == 0) {
    uint32_t bulk = 0;
#pragma unroll
    for (int op = 0; op < kNumOperands; ++op) {
      if (copied(op) && granule_of(A.codes, op) == 0) {
        bulk += (uint32_t)(runs[op].row_bytes * runs[op].rows);
      }
    }
    // Armed before any copy is issued; with no bulk operand this arrival
    // completes the phase at once.
    mbar_arrive_expect_tx(bar, bulk);
#pragma unroll
    for (int op = 0; op < kNumOperands; ++op) {
      if (copied(op) && granule_of(A.codes, op) == 0) {
        // A bulk run is contiguous in shared memory too (ld == n).
        bulk_copy(base + runs[op].off, runs[op].src,
                  (uint32_t)(runs[op].row_bytes * runs[op].rows), bar);
      }
    }
  }
#pragma unroll
  for (int op = 0; op < kNumOperands; ++op) {
    const int g = granule_of(A.codes, op);
    if (g == 0 || !copied(op)) continue;
    const Run& r = runs[op];
    const int per_row = (int)(r.row_bytes / g);
    const int units = per_row * r.rows;
    for (int u = lane; u < units; u += 32) {
      const int row = u / per_row;
      const int off = (u - row * per_row) * g;
      cp_async(base + r.off + row * r.dst_stride + off,
               r.src + (long long)row * r.row_bytes + off, g);
    }
  }
  if (lane == 0) {
    cp_async(base + L.off_hdr, A.theta + b, (int)sizeof(T));
  } else if (lane == 1) {
    cp_async(base + L.off_hdr + 8, A.ptr + b, 4);
  } else if (lane == 2) {
    cp_async(base + L.off_hdr + 12, A.ncorr + b, 4);
  }
  cp_async_commit();
}

// Row geometry of an [m, m] matvec on one warp: `lpr` lanes per row (a
// power of two), each summing the columns j = h + lpr * t of its row.
template <int M>
struct Geo {
  int m, lpr, rpp, jpl;
  __device__ __forceinline__ explicit Geo(int m_rt) {
    m = M > 0 ? M : m_rt;
    lpr = lanes_per_row(m);
    rpp = 32 / lpr;
    jpl = cols_per_lane(m);
  }
};

template <typename T>
__device__ __forceinline__ T group_sum(T x, int lpr) {
  for (int off = lpr >> 1; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Column j of this lane's t-th term, staggered by row so that the lanes of
// one warp spread over the shared-memory banks.
__device__ __forceinline__ int col_of(int t, int start, int jpl, int lpr,
                                      int h) {
  int tt = t + start;
  if (tt >= jpl) tt -= jpl;
  return h + lpr * tt;
}

// The unstaged passes (rows in device memory), kept out of line so that
// they do not add to the staged path's registers.
template <typename T>
__device__ __noinline__ void dots_from_memory(const T* sg, const T* yg,
                                              const T* vg, T* dots, int m,
                                              int n, int lane) {
  for (int r = 0; r < 2 * m; ++r) {
    const T* row = r < m ? sg + (size_t)r * n : yg + (size_t)(r - m) * n;
    T acc = T(0);
    for (int k = lane; k < n; k += 32) acc += row[k] * vg[k];
    acc = warp_sum(acc);
    if (lane == 0) dots[r] = acc;
  }
}

template <typename T>
__device__ __noinline__ void combine_from_memory(
    const T* sg, const T* yg, const T* vg, const T* ws, const T* wy, T* ob,
    T scale, int m, int n, int lane) {
  for (int k = lane; k < n; k += 32) {
    T acc_s = T(0);
    T acc_y = T(0);
    for (int j = 0; j < m; ++j) {
      acc_s += ws[j] * sg[(size_t)j * n + k];
      acc_y += wy[j] * yg[(size_t)j * n + k];
    }
    ob[k] = (scale * vg[k] + acc_s) + acc_y;
  }
}

template <typename T, int M>
__device__ __forceinline__ void run_instance(const Args<T>& A, int b,
                                             const unsigned char* stage,
                                             T* scratch, int lane) {
  using V = Vec<T>;
  using VT = typename V::type;
  const Geo<M> g(A.m);
  const int m = g.m;
  const int n = A.n;
  const int ld = A.L.ld;
  const int nvec = ld / V::N;
  const T a = A.a;

  const T* S = reinterpret_cast<const T*>(stage + A.L.off_s);
  const T* Y = reinterpret_cast<const T*>(stage + A.L.off_y);
  const T* MAT = reinterpret_cast<const T*>(stage + A.L.off_mat);
  const T* YY = reinterpret_cast<const T*>(stage + A.L.off_yy);
  const T* VV = reinterpret_cast<const T*>(stage + A.L.off_v);
  const T* YS = reinterpret_cast<const T*>(stage + A.L.off_ys);
  const T th = *reinterpret_cast<const T*>(stage + A.L.off_hdr);
  const int p = *reinterpret_cast<const int*>(stage + A.L.off_hdr + 8);
  const int nc = *reinterpret_cast<const int*>(stage + A.L.off_hdr + 12);

  T* dots = scratch;          // sv = dots[0, m), yv = dots[m, 2m)
  T* a0 = dots + 2 * m;       // alpha (ping)
  T* a1 = a0 + m;             // alpha (pong)
  T* tmp = a1 + m;            // ys * alpha - base (rinv), base (sweeps)
  T* b0 = tmp + m;            // beta (ping)
  T* b1 = b0 + m;             // beta (pong)
  T* ws = b1 + m;
  T* wy = ws + m;
  int* dist = reinterpret_cast<int*>(wy + m);

  for (int j = lane; j < m; j += 32) {
    // floor remainder: C++ % truncates toward zero
    dist[j] = (((p - 1 - j) % m) + m) % m;
  }

  // Pass 1: the 2m dots.  Staged: dl lanes per row (one at m=16), 16-byte
  // shared loads.  Unstaged: the warp walks each row along n.
  const T* sg = A.s + (size_t)b * m * n;
  const T* yg = A.y + (size_t)b * m * n;
  const T* vg = A.v + (size_t)b * n;
  if (!A.L.staged) {
    dots_from_memory(sg, yg, vg, dots, m, n, lane);
  } else {
    const int rows = 2 * m;
    const int dl = rows <= 32 ? pow2_floor(32 / rows) : 1;
    const int rpp = 32 / dl;
    const int part = lane % dl;
    const VT* v4 = reinterpret_cast<const VT*>(VV);
    for (int r0 = 0; r0 < rows; r0 += rpp) {
      const int r = r0 + lane / dl;
      VT acc = V::zero();
      if (r < rows) {
        const T* row = r < m ? S + (size_t)r * ld : Y + (size_t)(r - m) * ld;
        const VT* row4 = reinterpret_cast<const VT*>(row);
#pragma unroll 5
        for (int c = part; c < nvec; c += dl) V::fma(acc, row4[c], v4[c]);
      }
      const T d = group_sum(V::sum(acc), dl);
      if (part == 0 && r < rows) dots[r] = d;
    }
  }
  __syncwarp();

  const int h = lane % g.lpr;
  const T* sv = dots;
  const T* yv = dots + m;

  if (A.mode == kModeRinv) {
    // alpha = R^{-1} (a sv)
    for (int i0 = 0; i0 < m; i0 += g.rpp) {
      const int i = i0 + lane / g.lpr;
      const int start = i < m ? i % g.jpl : 0;
      T acc = T(0);
      if (i < m) {
#pragma unroll
        for (int t = 0; t < g.jpl; ++t) {
          const int j = col_of(t, start, g.jpl, g.lpr, h);
          if (j < m) acc += MAT[i * m + j] * (a * sv[j]);
        }
      }
      acc = group_sum(acc, g.lpr);
      if (h == 0 && i < m) a0[i] = acc;
    }
    __syncwarp();
    // tmp = ys * alpha - base, base = (a yv - yy alpha) / theta
    for (int i0 = 0; i0 < m; i0 += g.rpp) {
      const int i = i0 + lane / g.lpr;
      const int start = i < m ? i % g.jpl : 0;
      T acc = T(0);
      if (i < m) {
#pragma unroll
        for (int t = 0; t < g.jpl; ++t) {
          const int j = col_of(t, start, g.jpl, g.lpr, h);
          if (j < m) acc += YY[i * m + j] * a0[j];
        }
      }
      acc = group_sum(acc, g.lpr);
      if (h == 0 && i < m) {
        const T base = (a * yv[i] - acc) / th;
        tmp[i] = YS[i] * a0[i] - base;
      }
    }
    __syncwarp();
    // beta = vmask (alpha - R^{-T} tmp); the combine's weights
    for (int i0 = 0; i0 < m; i0 += g.rpp) {
      const int i = i0 + lane / g.lpr;
      const int start = i < m ? i % g.jpl : 0;
      T acc = T(0);
      if (i < m) {
#pragma unroll
        for (int t = 0; t < g.jpl; ++t) {
          const int j = col_of(t, start, g.jpl, g.lpr, h);
          if (j < m) acc += MAT[j * m + i] * tmp[j];
        }
      }
      acc = group_sum(acc, g.lpr);
      if (h == 0 && i < m) {
        const bool vi = dist[i] < nc;
        const T alpha = a0[i];
        const T beta = (vi ? T(1) : T(0)) * (alpha - acc);
        ws[i] = vi ? alpha - beta : T(0);
        wy[i] = vi ? -alpha / th : T(0);
      }
    }
  } else if constexpr (M > 0) {
    // m masked Jacobi sweeps for alpha, then base, then m for beta.  At
    // compile-time m the sweeps live in registers: lpr lanes per row, each
    // keeping its masked coefficients; the row values travel by shuffles
    // (x_j sits in the lpr lanes of row j); two partial sums halve the
    // chain.
    const int i = lane / g.lpr;
    const bool live = i < m;
    const int start = live ? i % g.jpl : 0;
    const int di = live ? dist[i] : 0;
    const bool vi = live && di < nc;
    const T ysafe = vi ? YS[i] : T(1);
    const T vm = vi ? T(1) : T(0);
    const T rhs = live ? a * sv[i] : T(0);
    constexpr int kJ = cols_per_lane(M);
    T cA[kJ], cB[kJ];
    int src[kJ];
#pragma unroll
    for (int t = 0; t < kJ; ++t) {
      const int j = col_of(t, start, g.jpl, g.lpr, h);
      const bool in = live && j < m;
      const int dj = in ? dist[j] : 0;
      src[t] = (in ? j : 0) * g.lpr;
      // msy[i][j] = sy[i][j] where slot j is newer; msyT[i][j] = sy[j][i]
      // where it is older (both valid)
      cA[t] = (in && vi && dj < nc && dj < di) ? MAT[i * m + j] : T(0);
      cB[t] = (in && vi && dj < nc && dj > di) ? MAT[j * m + i] : T(0);
    }
    T alpha = T(0);
    for (int sweep = 0; sweep < m; ++sweep) {
      T acc0 = T(0), acc1 = T(0);
#pragma unroll
      for (int t = 0; t < kJ; ++t) {
        const T xj = __shfl_sync(0xffffffffu, alpha, src[t]);
        if (t % 2 == 0) acc0 += cA[t] * xj; else acc1 += cA[t] * xj;
      }
      const T acc = group_sum(acc0 + acc1, g.lpr);
      alpha = vm * (rhs - acc) / ysafe;
    }
    // base = (a yv - yy alpha) / theta; alpha at this lane's columns
    T aj[kJ];
    T acc = T(0);
#pragma unroll
    for (int t = 0; t < kJ; ++t) {
      aj[t] = __shfl_sync(0xffffffffu, alpha, src[t]);
      const int j = col_of(t, start, g.jpl, g.lpr, h);
      if (live && j < m) acc += YY[i * m + j] * aj[t];
    }
    acc = group_sum(acc, g.lpr);
    const T base = live ? (a * yv[i] - acc) / th : T(0);
    T beta = T(0);
    for (int sweep = 0; sweep < m; ++sweep) {
      T acc0 = T(0), acc1 = T(0);
#pragma unroll
      for (int t = 0; t < kJ; ++t) {
        const T bj = __shfl_sync(0xffffffffu, beta, src[t]);
        if (t % 2 == 0) acc0 += cB[t] * (aj[t] - bj);
        else acc1 += cB[t] * (aj[t] - bj);
      }
      const T acc2 = group_sum(acc0 + acc1, g.lpr);
      beta = vm * (base + acc2) / ysafe;
    }
    if (h == 0 && live) {
      ws[i] = vi ? alpha - beta : T(0);
      wy[i] = vi ? -alpha / th : T(0);
    }
  } else {
    // m at run time: the same sweeps, lanes strided over rows, the vectors
    // ping-pong through shared memory.
    T* x = a0;
    T* xn = a1;
    for (int i = lane; i < m; i += 32) a0[i] = T(0);
    __syncwarp();
    for (int sweep = 0; sweep < m; ++sweep) {
      for (int i = lane; i < m; i += 32) {
        const int di = dist[i];
        const bool vi = di < nc;
        T acc = T(0);
        for (int j = 0; j < m; ++j) {
          const int dj = dist[j];
          acc += (vi && dj < nc && dj < di) ? MAT[i * m + j] * x[j] : T(0);
        }
        xn[i] = (vi ? T(1) : T(0)) * (a * sv[i] - acc) / (vi ? YS[i] : T(1));
      }
      __syncwarp();
      T* t2 = x; x = xn; xn = t2;
    }
    const T* alpha = x;
    for (int i = lane; i < m; i += 32) {
      T acc = T(0);
      for (int j = 0; j < m; ++j) acc += YY[i * m + j] * alpha[j];
      tmp[i] = (a * yv[i] - acc) / th;
      b0[i] = T(0);
    }
    __syncwarp();
    x = b0;
    xn = b1;
    for (int sweep = 0; sweep < m; ++sweep) {
      for (int i = lane; i < m; i += 32) {
        const int di = dist[i];
        const bool vi = di < nc;
        T acc = T(0);
        for (int j = 0; j < m; ++j) {
          const int dj = dist[j];
          acc += (vi && dj < nc && dj > di)
                     ? MAT[j * m + i] * (alpha[j] - x[j]) : T(0);
        }
        xn[i] = (vi ? T(1) : T(0)) * (tmp[i] + acc) / (vi ? YS[i] : T(1));
      }
      __syncwarp();
      T* t2 = x; x = xn; xn = t2;
    }
    for (int i = lane; i < m; i += 32) {
      const bool vi = dist[i] < nc;
      ws[i] = vi ? alpha[i] - x[i] : T(0);
      wy[i] = vi ? -alpha[i] / th : T(0);
    }
  }
  __syncwarp();

  // Pass 2: out = (a / theta) v + S^T ws + Y^T wy, lanes along n.
  const T scale = a / th;
  T* ob = A.out + (size_t)b * n;
  if (!A.L.staged) {
    combine_from_memory(sg, yg, vg, ws, wy, ob, scale, m, n, lane);
    return;
  }
  const bool out_vec =
      (n * (int)sizeof(T)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(A.out) & 15) == 0;
  for (int c = lane; c < nvec; c += 32) {
    VT acc_s = V::zero();
    VT acc_y = V::zero();
    const VT* s4 = reinterpret_cast<const VT*>(S) + c;
    const VT* y4 = reinterpret_cast<const VT*>(Y) + c;
    const int stride = ld / V::N;
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      V::fma(acc_s, ws[j], s4[j * stride]);
      V::fma(acc_y, wy[j], y4[j * stride]);
    }
    const VT vv = reinterpret_cast<const VT*>(VV)[c];
    VT o = V::zero();
    V::fma(o, scale, vv);
    const VT r = V::add3(o, acc_s, acc_y);
    if (out_vec) {
      reinterpret_cast<VT*>(ob)[c] = r;
    } else {
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        const int k = c * V::N + e;
        if (k < n) ob[k] = V::get(r, e);
      }
    }
  }
}

// Registers: in f32 two blocks of 8 warps must fit (128 a thread, 16 warps
// an SM); in f64 one (255 a thread, so the recursion does not spill).
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 2 : 1;

template <typename T, int M>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks<T>)
    two_loop_kernel(Args<T> A) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Layout& L = A.L;
  const int stages = A.stages;
  const uint32_t bars = smem_addr(smem) + 16u + 8u * (uint32_t)(warp * stages);
  unsigned char* wbase = smem + L.bar_bytes + (size_t)warp * L.warp_bytes;
  T* scratch = reinterpret_cast<T*>(wbase + (size_t)stages * L.stage_bytes);

  if (lane == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(bars + 8u * st, 1);
    fence_mbarrier_init();
  }
  // Zero the padding columns [n, ld) of every stage's s / y / v rows once:
  // no copy writes them, and the 16-byte vector reads cover them.
  const int pad = L.staged ? L.ld - A.n : 0;
  if (pad > 0) {
    const int rows = 2 * A.m + 1;
    for (int st = 0; st < stages; ++st) {
      unsigned char* stage = wbase + (size_t)st * L.stage_bytes;
      for (int u = lane; u < rows * pad; u += 32) {
        const int r = u / pad;
        const int k = A.n + (u - r * pad);
        T* row = r < A.m ? reinterpret_cast<T*>(stage + L.off_s) + (size_t)r * L.ld
                 : r < 2 * A.m
                     ? reinterpret_cast<T*>(stage + L.off_y) + (size_t)(r - A.m) * L.ld
                     : reinterpret_cast<T*>(stage + L.off_v);
        row[k] = T(0);
      }
    }
  }
  __syncwarp();

  // Block k owns the instances [k B / grid, (k + 1) B / grid); its warps
  // take them one at a time from a shared counter, so a warp that
  // finishes early takes more and the block's share ends together.
  int* counter = reinterpret_cast<int*>(smem);
  if (threadIdx.x == 0) *counter = 0;
  __syncthreads();  // once, before any instance
  const long long begin = (long long)blockIdx.x * A.batch / gridDim.x;
  const long long end = ((long long)blockIdx.x + 1) * A.batch / gridDim.x;
  auto take = [&]() -> int {
    int k = 0;
    if (lane == 0) k = atomicAdd(counter, 1);
    k = __shfl_sync(0xffffffffu, k, 0);
    return begin + k < end ? (int)(begin + k) : -1;
  };

  // Prologue: fill the ring.  held0 and held1 are the instances the two
  // stages hold, in the order the warp runs them (-1: none).
  int held0 = -1, held1 = -1;
  for (int st = 0; st < stages; ++st) {
    const int b = take();
    if (st == 0) held0 = b; else held1 = b;
    if (b >= 0) {
      issue_copies(A, b, wbase + (size_t)st * L.stage_bytes, bars + 8u * st,
                   lane);
    } else {
      cp_async_commit();
    }
  }
  for (int k = 0; held0 >= 0; ++k) {
    const int b = held0;
    const int st = k % stages;
    unsigned char* stage = wbase + (size_t)st * L.stage_bytes;
    cp_async_wait(stages - 1);
    mbar_wait(bars + 8u * st, (uint32_t)((k / stages) & 1));
    __syncwarp();
    run_instance<T, M>(A, b, stage, scratch, lane);
    // Every lane is done reading the stage before it is refilled; order
    // those generic-proxy reads before the async-proxy writes.
    fence_proxy_async();
    __syncwarp();
    const int next = take();
    if (next >= 0) {
      issue_copies(A, next, stage, bars + 8u * st, lane);
    } else {
      cp_async_commit();
    }
    if (stages == 1) {
      held0 = next;
    } else {
      held0 = held1;
      held1 = next;
    }
  }
}

// A bulk copy (granule 0) needs 16-byte addresses and sizes; a cp.async
// of g bytes needs both to be multiples of g.
int check_alignment(const void* p, long long row_bytes, int granule) {
  const int align = granule == 0 ? 16 : granule;
  if ((reinterpret_cast<uintptr_t>(p) % align) != 0 || row_bytes % align != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaSuccess;
}

template <typename T, int M>
int launch_main(const Args<T>& A, int grid, cudaStream_t stream) {
  const size_t smem = (size_t)A.L.smem_bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        two_loop_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  two_loop_kernel<T, M><<<grid, 32 * A.warps, smem, stream>>>(A);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* s, const void* y, const void* ys, const void* theta,
           const void* ptr, const void* ncorr, const void* sy, const void* yy,
           const void* rinv, const void* v, void* out, int batch, int m,
           int n, double a, int mode, int warps, int stages, int grid,
           int staged, unsigned codes, long long smem_bytes, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaSuccess;
  if (m <= 0 || warps < 1 || warps > kMaxWarps || stages < 1 ||
      stages > kMaxStages || grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args<T> A;
  A.s = (const T*)s;
  A.y = (const T*)y;
  A.ys = (const T*)ys;
  A.theta = (const T*)theta;
  A.ptr = (const int*)ptr;
  A.ncorr = (const int*)ncorr;
  A.mat = (const T*)(mode == kModeRinv ? rinv : sy);
  A.yy = (const T*)yy;
  A.v = (const T*)v;
  A.out = (T*)out;
  A.batch = batch;
  A.m = m;
  A.n = n;
  A.mode = mode;
  A.warps = warps;
  A.stages = stages;
  A.codes = codes;
  A.a = (T)a;
  A.L = make_layout<T>(m, n, warps, stages, staged);
  // The plan was computed in Python from the same layout: a disagreement
  // means the two copies of the layout drifted apart.
  if (A.L.smem_bytes != smem_bytes) return (int)cudaErrorInvalidValue;
  const long long rowb = (long long)n * sizeof(T);
  const long long mmb = (long long)m * m * sizeof(T);
  const void* ptrs[kNumOperands] = {A.s, A.y, A.mat, A.yy, A.v, A.ys};
  const long long rows[kNumOperands] = {rowb, rowb, mmb, mmb, rowb,
                                        (long long)(m * sizeof(T))};
  for (int op = 0; op < kNumOperands; ++op) {
    if (!staged && (op == kS || op == kY || op == kV)) continue;
    const int c = (codes >> (2 * op)) & 3;
    const int err = check_alignment(ptrs[op], rows[op], c == 0 ? 0 : (2 << c));
    if (err) return err;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (m == 16) return launch_main<T, 16>(A, grid, st);
  if (m == 6) return launch_main<T, 6>(A, grid, st);
  return launch_main<T, 0>(A, grid, st);
}

template <typename T>
int launch_simple(const void* s, const void* y, const void* ys,
                  const void* theta, const void* ptr, const void* ncorr,
                  const void* sy, const void* yy, const void* rinv,
                  const void* v, void* out, int batch, int m, int n, double a,
                  int mode, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaSuccess;
  const size_t smem = simple_smem_bytes<T>(m);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        two_loop_simple_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  two_loop_simple_kernel<T><<<batch, kSimpleThreads, smem, (cudaStream_t)stream>>>(
      (const T*)s, (const T*)y, (const T*)ys, (const T*)theta,
      (const int*)ptr, (const int*)ncorr, (const T*)sy, (const T*)yy,
      (const T*)rinv, (const T*)v, (T*)out, m, n, (T)a, mode);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lbfgs_two_loop_f32(const void* s, const void* y, const void* ys,
                       const void* theta, const void* ptr, const void* ncorr,
                       const void* sy, const void* yy, const void* rinv,
                       const void* v, void* out, int batch, int m, int n,
                       double a, int mode, int warps, int stages, int grid,
                       int staged, unsigned codes, long long smem_bytes,
                       void* stream) {
  return launch<float>(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, out,
                       batch, m, n, a, mode, warps, stages, grid, staged,
                       codes, smem_bytes, stream);
}

int lbfgs_two_loop_f64(const void* s, const void* y, const void* ys,
                       const void* theta, const void* ptr, const void* ncorr,
                       const void* sy, const void* yy, const void* rinv,
                       const void* v, void* out, int batch, int m, int n,
                       double a, int mode, int warps, int stages, int grid,
                       int staged, unsigned codes, long long smem_bytes,
                       void* stream) {
  return launch<double>(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, out,
                        batch, m, n, a, mode, warps, stages, grid, staged,
                        codes, smem_bytes, stream);
}

int lbfgs_two_loop_simple_f32(const void* s, const void* y, const void* ys,
                              const void* theta, const void* ptr,
                              const void* ncorr, const void* sy,
                              const void* yy, const void* rinv, const void* v,
                              void* out, int batch, int m, int n, double a,
                              int mode, void* stream) {
  return launch_simple<float>(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v,
                              out, batch, m, n, a, mode, stream);
}

int lbfgs_two_loop_simple_f64(const void* s, const void* y, const void* ys,
                              const void* theta, const void* ptr,
                              const void* ncorr, const void* sy,
                              const void* yy, const void* rinv, const void* v,
                              void* out, int batch, int m, int n, double a,
                              int mode, void* stream) {
  return launch_simple<double>(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v,
                               out, batch, m, n, a, mode, stream);
}

// Bytes of dynamic shared memory the simple kernel's block needs.
long long lbfgs_two_loop_simple_smem_bytes(int m, int is_f64) {
  return (long long)(is_f64 ? simple_smem_bytes<double>(m)
                            : simple_smem_bytes<float>(m));
}

// The main kernel's shared memory for a plan (the wrapper's plan computes
// the same number; the card tests compare the two).
long long lbfgs_two_loop_smem_bytes(int m, int n, int is_f64, int warps,
                                    int stages, int staged) {
  return is_f64 ? make_layout<double>(m, n, warps, stages, staged).smem_bytes
                : make_layout<float>(m, n, warps, stages, staged).smem_bytes;
}

const char* lbfgs_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
