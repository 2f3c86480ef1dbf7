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
// per instance) are negligible.  The design therefore reads every input
// once from device memory: one block per instance streams its s/y rows for
// the dots, keeps the [m, m] matrices and the recursion in shared memory
// (one warp runs it; it is O(m^3) scalar work), and re-reads the same rows
// for the combine while they are still resident in L1 (12.8 KB per block at
// the main shape).  Loads are coalesced along n.  No tensor-core work
// exists here: this is a batched matvec family.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kModeSweeps = 0;
constexpr int kModeRinv = 1;

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

// Shared memory: two [m, m] matrices (sy or rinv, then yy), eight [m]
// vectors, then the [m] int ring distances.
template <typename T>
__host__ __device__ size_t smem_bytes(int m) {
  return (2 * (size_t)m * m + 8 * (size_t)m) * sizeof(T) + (size_t)m * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) two_loop_kernel(
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

template <typename T>
int launch(const void* s, const void* y, const void* ys, const void* theta,
           const void* ptr, const void* ncorr, const void* sy, const void* yy,
           const void* rinv, const void* v, void* out, int batch, int m,
           int n, double a, int mode, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes<T>(m);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        two_loop_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  two_loop_kernel<T><<<batch, kThreads, smem, (cudaStream_t)stream>>>(
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
                       double a, int mode, void* stream) {
  return launch<float>(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, out,
                       batch, m, n, a, mode, stream);
}

int lbfgs_two_loop_f64(const void* s, const void* y, const void* ys,
                       const void* theta, const void* ptr, const void* ncorr,
                       const void* sy, const void* yy, const void* rinv,
                       const void* v, void* out, int batch, int m, int n,
                       double a, int mode, void* stream) {
  return launch<double>(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, out,
                        batch, m, n, a, mode, stream);
}

// Bytes of dynamic shared memory one block needs (the wrapper checks it
// against the card's per-block limit before launching).
long long lbfgs_two_loop_smem_bytes(int m, int is_f64) {
  return (long long)(is_f64 ? smem_bytes<double>(m) : smem_bytes<float>(m));
}

const char* lbfgs_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
