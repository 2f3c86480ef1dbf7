// The native core on the card: one GPU thread per instance.
//
// Replaces the JAX package's host C++ core (lbfgspp_tpu/native/core.cpp:575,
// the L-BFGS solve, and lbfgsb.cpp:606, the L-BFGS-B solve) where the port
// runs it on its own device: lbfgspp_tpu.native.minimize_batch fans
// independent builtin-objective solves over OS threads (fastcall.cpp,
// fast_minimize_batch); here each instance is one thread running the same
// source (core.h, lbfgsb.h) that the host build compiles.  No TPU kernel is
// replaced: the JAX package never ran this solve on its device.
//
//   native_lbfgs_batch: L-BFGS on a builtin objective (0 = rosenbrock,
//     1 = quadratic) with any of the four line searches;
//   native_lbfgsb_batch: L-BFGS-B with More-Thuente and per-instance
//     bounds lb, ub [B, n].
//
// x [B, n] f64 is solved in place; the outputs fx, gnorm (projected for the
// box solve), niter, nfev and status are [B]; instance b's workspace is row
// b of ws [B, stride] (stride >= native_workspace(_b) / 8 doubles), in
// device memory: nothing of a solve but its scalars lives on the stack.
//
// What bounds it: latency.  A thread runs its instance's whole solve
// serially (each evaluation, dot and history update a loop over n), the
// threads of a warp diverge as their instances take different iterations
// and searches, and their workspace rows lie `stride` apart, so a warp's
// loads are uncoalesced.  The card's bound (its f64 peak over the flops the
// solves count) is far below the time; an interleaved [W, B] layout, or a
// warp per instance, is later work.  A simple kernel that is right first.
#include <cuda_runtime.h>

#include "core.h"
#include "lbfgsb.h"

namespace ln = lbfgspp_native;

namespace {

// 32 threads a block spreads a batch of 4096 over 128 of the 132 SMs.
constexpr int kThreads = 32;

__global__ void native_lbfgs_batch(int builtin_id, long long batch, int n,
                                   double* xs, ln::Params p, int ls_kind,
                                   double* ws, long long stride, double* fx,
                                   double* gnorm, int* niter, int* nfev,
                                   int* status) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= batch) return;
  double* x = xs + b * n;
  double* w = ws + b * stride;
  if (builtin_id == 0)
    status[b] = ln::minimize(ln::Rosenbrock{}, n, x, p, ls_kind, w, fx + b,
                             gnorm + b, niter + b, nfev + b);
  else
    status[b] = ln::minimize(ln::Quadratic{}, n, x, p, ls_kind, w, fx + b,
                             gnorm + b, niter + b, nfev + b);
}

__global__ void native_lbfgsb_batch(int builtin_id, long long batch, int n,
                                    double* xs, const double* lb,
                                    const double* ub, ln::ParamsB p,
                                    double* ws, long long stride, double* fx,
                                    double* pgnorm, int* niter, int* nfev,
                                    int* status) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= batch) return;
  double* x = xs + b * n;
  double* w = ws + b * stride;
  if (builtin_id == 0)
    status[b] = ln::minimize_b(ln::Rosenbrock{}, n, x, lb + b * n,
                               ub + b * n, p, w, fx + b, pgnorm + b,
                               niter + b, nfev + b);
  else
    status[b] = ln::minimize_b(ln::Quadratic{}, n, x, lb + b * n,
                               ub + b * n, p, w, fx + b, pgnorm + b,
                               niter + b, nfev + b);
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

// Launch native_lbfgs_batch on `stream`; returns cudaGetLastError().
int lbfgspp_native_lbfgs_batch(int builtin_id, long long batch, int n,
                               double* xs, const ln::Params* p, int ls_kind,
                               double* ws, long long stride, double* fx,
                               double* gnorm, int* niter, int* nfev,
                               int* status, cudaStream_t stream) {
  if (batch <= 0) return 0;
  const int grid = static_cast<int>((batch + kThreads - 1) / kThreads);
  native_lbfgs_batch<<<grid, kThreads, 0, stream>>>(builtin_id, batch, n, xs, *p, ls_kind, ws, stride, fx, gnorm, niter, nfev, status);
  return static_cast<int>(cudaGetLastError());
}

// Launch native_lbfgsb_batch on `stream`; returns cudaGetLastError().
int lbfgspp_native_lbfgsb_batch(int builtin_id, long long batch, int n,
                                double* xs, const double* lb,
                                const double* ub, const ln::ParamsB* p,
                                double* ws, long long stride, double* fx,
                                double* pgnorm, int* niter, int* nfev,
                                int* status, cudaStream_t stream) {
  if (batch <= 0) return 0;
  const int grid = static_cast<int>((batch + kThreads - 1) / kThreads);
  native_lbfgsb_batch<<<grid, kThreads, 0, stream>>>(builtin_id, batch, n, xs, lb, ub, *p, ws, stride, fx, pgnorm, niter, nfev, status);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
