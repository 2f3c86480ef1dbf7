// The host build of the native core (core.h, lbfgsb.h): the C ABI of the
// JAX package's libnative.so, loaded with ctypes, and the threaded batches
// (ctypes releases the interpreter lock while they run), all under the
// Serial policy.
//
// Built by lbfgspp_tpu_torch.utils.cuda_build.load_host with the JAX
// module's flags (g++ -O3 -march=native -std=c++17 -shared -fPIC), so that
// a solve here is bit-identical to lbfgspp_tpu.native's.  Each solve takes
// its workspace from one std::vector sized by native_workspace(_b).
//
// Beside them, the threaded batches under the Lanes policy (the card's
// Warp arithmetic on one thread per solve), for the tests and
// chip_smoke.py only: built without multiply-add contraction, they equal
// the card's build without contraction bit for bit.

#include <atomic>
#include <thread>
#include <vector>

#include "core.h"
#include "lbfgsb.h"

using namespace lbfgspp_native;

namespace {

using Obj = double (*)(const double* x, double* grad, int n, void* user);

// A C callback (a Python callable through ctypes) as an objective functor.
struct Callback {
  Obj f;
  void* user;
  template <class X>
  double operator()(X, const double* x, double* grad, int n) const {
    return f(x, grad, n, user);
  }
};

std::vector<double> workspace(long long bytes) {
  return std::vector<double>(static_cast<size_t>((bytes + 7) / 8));
}

template <class X = Serial>
int solve(Obj f, void* user, int builtin_id, int n, double* x,
          const Params& p, int ls_kind, double* ws, double* out_fx,
          double* out_gnorm, int* out_niter, int* out_nfev) {
  if (builtin_id == 0)
    return minimize<X>(Rosenbrock{}, n, x, p, ls_kind, ws, out_fx, out_gnorm,
                       out_niter, out_nfev);
  if (builtin_id == 1)
    return minimize<X>(Quadratic{}, n, x, p, ls_kind, ws, out_fx, out_gnorm,
                       out_niter, out_nfev);
  return minimize<X>(Callback{f, user}, n, x, p, ls_kind, ws, out_fx,
                     out_gnorm, out_niter, out_nfev);
}

template <class X = Serial>
int solve_b(Obj f, void* user, int builtin_id, int n, double* x,
            const double* lb, const double* ub, const ParamsB& p, double* ws,
            double* out_fx, double* out_pgnorm, int* out_niter,
            int* out_nfev) {
  if (builtin_id == 0)
    return minimize_b<X>(Rosenbrock{}, n, x, lb, ub, p, ws, out_fx,
                         out_pgnorm, out_niter, out_nfev);
  if (builtin_id > 0)
    return minimize_b<X>(Quadratic{}, n, x, lb, ub, p, ws, out_fx,
                         out_pgnorm, out_niter, out_nfev);
  return minimize_b<X>(Callback{f, user}, n, x, lb, ub, p, ws, out_fx,
                       out_pgnorm, out_niter, out_nfev);
}

// solve(i, workspace) for i in [0, batch) over `threads` OS threads (<= 0:
// one per hardware thread), each with its own workspace of `bytes`.
template <class Solve>
void parallel_for(long long batch, int threads, long long bytes,
                  const Solve& solve_one) {
  if (batch <= 0) return;
  std::atomic<long long> next(0);
  auto work = [&]() {
    std::vector<double> ws = workspace(bytes);
    for (;;) {
      const long long i = next.fetch_add(1);
      if (i >= batch) break;
      solve_one(i, ws.data());
    }
  };
  int t = threads > 0 ? threads
                      : static_cast<int>(std::thread::hardware_concurrency());
  if (t < 1) t = 1;
  if (static_cast<long long>(t) > batch) t = static_cast<int>(batch);
  std::vector<std::thread> pool;
  for (int k = 0; k < t - 1; k++) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
}

// The threaded batches over a builtin objective (0 = rosenbrock,
// 1 = quadratic): xs [batch, n] solved in place, instance i by whichever of
// `threads` OS threads takes index i next (threads <= 0: one per hardware
// thread).  Each thread reuses one workspace, and every instance's result
// equals its single solve.  X = Lanes: the card's arithmetic.
template <class X = Serial>
void minimize_batch(int builtin_id, int n, long long batch, double* xs,
                    const Params* pp, int ls_kind, double* fx, double* gnorm,
                    int* niter, int* nfev, int* status, int threads) {
  parallel_for(batch, threads, native_workspace(n, pp->m, pp->past),
               [&](long long i, double* ws) {
                 status[i] = solve<X>(nullptr, nullptr, builtin_id, n,
                                      xs + i * n, *pp, ls_kind, ws, &fx[i],
                                      &gnorm[i], &niter[i], &nfev[i]);
               });
}

// The same for L-BFGS-B, with per-instance bounds lb, ub [batch, n].
template <class X = Serial>
void minimize_b_batch(int builtin_id, int n, long long batch, double* xs,
                      const double* lb, const double* ub, const ParamsB* pp,
                      double* fx, double* pgnorm, int* niter, int* nfev,
                      int* status, int threads) {
  parallel_for(batch, threads, native_workspace_b(n, pp->m, pp->past),
               [&](long long i, double* ws) {
                 status[i] = solve_b<X>(nullptr, nullptr, builtin_id, n,
                                        xs + i * n, lb + i * n, ub + i * n,
                                        *pp, ws, &fx[i], &pgnorm[i],
                                        &niter[i], &nfev[i]);
               });
}

}  // namespace

extern "C" {

long long lbfgspp_native_workspace(int n, int m, int past) {
  return native_workspace(n, m, past);
}

long long lbfgspp_native_workspace_b(int n, int m, int past) {
  return native_workspace_b(n, m, past);
}

// Builtin objectives: 0 = rosenbrock, anything else = quadratic.
double lbfgspp_builtin_objective(int id, const double* x, double* grad,
                                 int n) {
  if (id == 0) return Rosenbrock{}(Serial{}, x, grad, n);
  return Quadratic{}(Serial{}, x, grad, n);
}

// The More-Thuente search with C linkage.  Returns the status;
// step/fx/dg/nfev through out-params; x/grad updated in place.
int lbfgspp_native_morethuente_c(Obj f, void* user, int max_linesearch,
                                 double min_step, double ftol, double wolfe,
                                 const double* xp, const double* drt,
                                 double step_max, double step_in,
                                 double fx_in, double* x, double* grad,
                                 double dg_in, int n, double* out_step,
                                 double* out_fx, double* out_dg,
                                 int* out_nfev) {
  std::vector<double> ws(2 * static_cast<size_t>(n));
  Arena ar(ws.data(), 2LL * n, 0);
  const LsResult r = morethuente_b<Serial>(
      Callback{f, user}, ar, max_linesearch, min_step, ftol, wolfe, xp, drt,
      step_max, step_in, fx_in, x, grad, dg_in, n);
  *out_step = r.step;
  *out_fx = r.fx;
  *out_dg = r.dg;
  *out_nfev = r.nfev;
  return r.status;
}

// Full L-BFGS solve (LBFGS.h:79-173 semantics).
//   f/user: objective callback (ignored if builtin_id is 0 or 1)
//   builtin_id: -1 = use callback, 0 = rosenbrock, 1 = quadratic
//   ls_kind: 0 backtracking, 1 bracketing, 2 nocedalwright, 3 morethuente
//   x: in/out iterate [n]; out_fx/out_gnorm/out_niter/out_nfev: outputs
// Returns a Status code.
int lbfgspp_native_minimize(Obj f, void* user, int builtin_id, int n,
                            double* x, const Params* pp, int ls_kind,
                            double* out_fx, double* out_gnorm,
                            int* out_niter, int* out_nfev) {
  std::vector<double> ws = workspace(native_workspace(n, pp->m, pp->past));
  return solve(f, user, builtin_id, n, x, *pp, ls_kind, ws.data(), out_fx,
               out_gnorm, out_niter, out_nfev);
}

// Full L-BFGS-B solve (LBFGSB.h:117-262 semantics): builtin_id >= 0 picks
// a builtin (0 = rosenbrock, else quadratic), -1 the callback.
int lbfgspp_native_minimize_b(Obj f, void* user, int builtin_id, int n,
                              double* x, const double* lb, const double* ub,
                              const ParamsB* pp, double* out_fx,
                              double* out_pgnorm, int* out_niter,
                              int* out_nfev) {
  std::vector<double> ws =
      workspace(native_workspace_b(n, pp->m, pp->past));
  return solve_b(f, user, builtin_id, n, x, lb, ub, *pp, ws.data(), out_fx,
                 out_pgnorm, out_niter, out_nfev);
}

void lbfgspp_native_minimize_batch(int builtin_id, int n, long long batch,
                                   double* xs, const Params* pp, int ls_kind,
                                   double* fx, double* gnorm, int* niter,
                                   int* nfev, int* status, int threads) {
  minimize_batch(builtin_id, n, batch, xs, pp, ls_kind, fx, gnorm, niter,
                 nfev, status, threads);
}

void lbfgspp_native_minimize_b_batch(int builtin_id, int n, long long batch,
                                     double* xs, const double* lb,
                                     const double* ub, const ParamsB* pp,
                                     double* fx, double* pgnorm, int* niter,
                                     int* nfev, int* status, int threads) {
  minimize_b_batch(builtin_id, n, batch, xs, lb, ub, pp, fx, pgnorm, niter,
                   nfev, status, threads);
}

// A Lanes L-BFGS-B solve of a builtin or a callback (the reference box
// example's chained objective is a callback).
int lbfgspp_native_lanes_minimize_b(Obj f, void* user, int builtin_id,
                                    int n, double* x, const double* lb,
                                    const double* ub, const ParamsB* pp,
                                    double* out_fx, double* out_pgnorm,
                                    int* out_niter, int* out_nfev) {
  std::vector<double> ws =
      workspace(native_workspace_b(n, pp->m, pp->past));
  return solve_b<Lanes>(f, user, builtin_id, n, x, lb, ub, *pp, ws.data(),
                        out_fx, out_pgnorm, out_niter, out_nfev);
}

void lbfgspp_native_lanes_batch(int builtin_id, int n, long long batch,
                                double* xs, const Params* pp, int ls_kind,
                                double* fx, double* gnorm, int* niter,
                                int* nfev, int* status, int threads) {
  minimize_batch<Lanes>(builtin_id, n, batch, xs, pp, ls_kind, fx, gnorm,
                        niter, nfev, status, threads);
}

void lbfgspp_native_lanes_b_batch(int builtin_id, int n, long long batch,
                                  double* xs, const double* lb,
                                  const double* ub, const ParamsB* pp,
                                  double* fx, double* pgnorm, int* niter,
                                  int* nfev, int* status, int threads) {
  minimize_b_batch<Lanes>(builtin_id, n, batch, xs, lb, ub, pp, fx, pgnorm,
                          niter, nfev, status, threads);
}

}  // extern "C"
