// The native L-BFGS core, one source for the host and the card.
//
// The port's own copy of the JAX package's host core (lbfgspp_tpu/native/
// core.cpp: the reference semantics of LBFGS.h, its four line searches and
// the two builtin objectives), written once and run under one of three
// execution policies (below):
//
// * Serial, with g++ into the host library (host.cpp, fastcall.cpp), under
//   the JAX module's flags, where every arithmetic expression is the one
//   core.cpp writes, so that the host build is bit-identical to
//   lbfgspp_tpu.native;
// * Warp, with nvcc into batch.cu, one warp per instance, where it replaces
//   the JAX package's threaded batch (fastcall.cpp, fast_minimize_batch);
// * Lanes, with g++ into the host library beside Serial: the Warp policy's
//   arithmetic without threads, the witness that the card's build without
//   multiply-add contraction is bit for bit a host build's.
//
// What changes against core.cpp, and why:
// * every function is LBFGSPP_HD (__host__ __device__ under nvcc) and
//   templated on the policy X;
// * every std::vector becomes a slice of one caller-provided workspace
//   (native_workspace(n, m, past) bytes; on the card a warp's slice of the
//   block's shared memory, or one row of a [B, W] buffer in device memory
//   when the block's warps do not fit), so nothing is allocated inside a
//   solve and nothing large lives in a thread's registers;
// * the objective is a functor type the solve and the searches are
//   templated on (a device function pointer defeats inlining): the builtins
//   are the functors Rosenbrock and Quadratic, and the host wraps a C
//   callback in another;
// * std::abs/sqrt/isnan/isinf/isfinite/min/max/memcpy are spelled with
//   helpers that mean the same on both compilers.
//
// The policies.  A policy X spreads a solve's vector work and sums its
// reductions:
//   X::each(n, fn)            fn(i) for every i in [0, n), each i on one
//                             lane; afterwards every lane may read what any
//                             lane wrote;
//   X::reduce(n, init, t, op) op-fold of t(i) over [0, n) from init, the
//                             same bits on every lane (sum<X>: op = +);
//                             t may not write memory that another lane
//                             reads before the next X::sync();
//   X::any(n, pred)           whether pred(i) holds for some i;
//   X::compact(n, pred, put)  put(k, i) for the k-th i in index order with
//                             pred(i); returns their count;
//   X::put(p, v)              a store of scalar code: lane 0 writes;
//   X::sync()                 every lane then sees every store before it;
//   X::leader()               whether this lane runs a section that only
//                             one lane may run (an in-place sort or LU);
//   X::mark(m)                the solve passes the phase boundary m
//                             (Boundary, below): a hook for a policy that
//                             times the phases (batch.cu's ProbedWarp);
//                             empty in the others, so their code is as
//                             without it.
// Serial is a loop: each and reduce in index order (the reference's sums),
// put a store.  Warp gives lane l the indices i = l (mod 32): a reduction
// folds the lane's terms in index order, then a xor butterfly over offsets
// 16, 8, 4, 2, 1 that folds the lower lane's value with the higher's, so
// every lane computes the same tree and holds the same bits, and all
// control flow that depends on a reduction is warp-uniform without a
// broadcast.  Lanes folds the same 32 strided partials and the same tree in
// one thread.  Scalar logic (the searches' interpolation and bracketing,
// the Arena's bump pointer, the index bookkeeping) runs redundantly on
// every lane on identical values; memory that only scalar code writes (the
// history's ys, alpha and order, the past ring, the box core's middle
// matrix, break points, index sets and BOXCQP scalars) is written by lane 0
// alone (X::put, or an X::leader() section), followed by X::sync() before
// another lane reads it.  Short vectors (the 2m-long middle-matrix
// vectors) are summed serially, by every lane alike or by the lane that
// owns the output, in the reference's order.
#pragma once

#include <cmath>
#include <limits>

#if defined(__CUDACC__)
#define LBFGSPP_HD __host__ __device__
#define LBFGSPP_INLINE __forceinline__
#else
#define LBFGSPP_HD
#define LBFGSPP_INLINE inline
#endif

namespace lbfgspp_native {

struct Params {
  int m;
  double epsilon;
  double epsilon_rel;
  int past;
  double delta;
  int max_iterations;
  int linesearch;  // 1 = Armijo, 2 = Wolfe, 3 = strong Wolfe
  int max_linesearch;
  double min_step;
  double max_step;
  double ftol;
  double wolfe;
};

// Status codes mirror lbfgspp_tpu_torch.types.Status.
enum Status {
  kRunning = 0,
  kConvergedGrad = 1,
  kConvergedDelta = 2,
  kMaxIterations = 3,
  kLsInvalidStep = 10,
  kLsNotDescent = 11,
  kLsMaxLinesearch = 12,
  kLsStepTooSmall = 13,
  kLsStepTooLarge = 14,
  kLsBracketInverted = 15,
  kLsNumerical = 16,
  // The workspace was smaller than the solve needed (never, when it is
  // sized by native_workspace / native_workspace_b).
  kWorkspaceExhausted = -1,
};

constexpr double kInf = std::numeric_limits<double>::infinity();
constexpr double kEps = std::numeric_limits<double>::epsilon();

LBFGSPP_HD inline double dabs(double x) { return fabs(x); }
LBFGSPP_HD inline double dsqrt(double x) { return sqrt(x); }
LBFGSPP_HD inline bool is_nan(double x) { return x != x; }
LBFGSPP_HD inline bool is_inf(double x) { return x == kInf || x == -kInf; }
LBFGSPP_HD inline bool is_finite(double x) {
  return !is_nan(x) && !is_inf(x);
}
// std::min / std::max, as libstdc++ defines them.
template <class T>
LBFGSPP_HD inline T dmin(T a, T b) { return (b < a) ? b : a; }
template <class T>
LBFGSPP_HD inline T dmax(T a, T b) { return (a < b) ? b : a; }

// The phase boundaries of a solve that X::mark names: the line search's,
// the new direction's (the s/y pair, the curvature test, the history's
// update and its two-loop product; minimize_b marks none: its direction
// runs from a search's end to the next search's begin), an objective
// evaluation's, which the solves do not mark themselves (a policy that
// times them wraps the functor), and, inside minimize_b's direction, the
// generalized Cauchy point's begin, the subspace step's begin (the Cauchy
// point's end) and the subspace step's end.
enum Boundary { kSearchBegin, kSearchEnd, kDirectionBegin, kDirectionEnd,
                kEvalBegin, kEvalEnd, kCauchyBegin, kSubspaceBegin,
                kSubspaceEnd };

// The host policies (the card's, Warp, is in batch.cu).
struct Serial {
  template <class Fn>
  LBFGSPP_HD static LBFGSPP_INLINE void each(int n, const Fn& fn) {
    for (int i = 0; i < n; ++i) fn(i);
  }
  template <class Fn, class Op>
  LBFGSPP_HD static LBFGSPP_INLINE double reduce(int n, double init,
                                                 const Fn& term, Op op) {
    double r = init;
    for (int i = 0; i < n; ++i) r = op(r, term(i));
    return r;
  }
  template <class P>
  LBFGSPP_HD static LBFGSPP_INLINE bool any(int n, const P& pred) {
    for (int i = 0; i < n; ++i)
      if (pred(i)) return true;
    return false;
  }
  template <class P, class W>
  LBFGSPP_HD static LBFGSPP_INLINE int compact(int n, const P& pred,
                                               const W& put) {
    int k = 0;
    for (int i = 0; i < n; ++i)
      if (pred(i)) put(k++, i);
    return k;
  }
  template <class T>
  LBFGSPP_HD static LBFGSPP_INLINE void put(T* p, T v) { *p = v; }
  LBFGSPP_HD static LBFGSPP_INLINE void sync() {}
  LBFGSPP_HD static LBFGSPP_INLINE bool leader() { return true; }
  LBFGSPP_HD static LBFGSPP_INLINE void mark(Boundary) {}
};

struct Add {
  LBFGSPP_HD LBFGSPP_INLINE double operator()(double a, double b) const {
    return a + b;
  }
};
struct Min {
  LBFGSPP_HD LBFGSPP_INLINE double operator()(double a, double b) const {
    return dmin(a, b);
  }
};
struct Max {
  LBFGSPP_HD LBFGSPP_INLINE double operator()(double a, double b) const {
    return dmax(a, b);
  }
};

// The warp's width, and its arithmetic on one host thread: each, any,
// compact, put and sync as Serial; a reduction folds the terms of each
// residue i mod 32 in index order, then the butterfly's tree.
constexpr int kWarp = 32;

struct Lanes : Serial {
  template <class Fn, class Op>
  LBFGSPP_HD static LBFGSPP_INLINE double reduce(int n, double init,
                                                 const Fn& term, Op op) {
    double part[kWarp];
    for (int l = 0; l < kWarp; ++l) part[l] = init;
    for (int i = 0; i < n; ++i) part[i % kWarp] = op(part[i % kWarp], term(i));
    for (int off = kWarp / 2; off >= 1; off /= 2)
      for (int l = 0; l < off; ++l) part[l] = op(part[l], part[l + off]);
    return part[0];
  }
};

// The policy's sum of term(i) over [0, n) (Serial: s += term(i)).
template <class X, class Fn>
LBFGSPP_HD LBFGSPP_INLINE double sum(int n, const Fn& term) {
  return X::reduce(n, 0.0, term, Add{});
}

// A bump allocator over the caller's workspace: doubles from the front,
// ints from a region behind them.  A Mark gives back what was taken in its
// scope.  Running out sets `exhausted` and hands out the front again (the
// solve then returns kWorkspaceExhausted); a workspace sized by
// native_workspace never runs out.
struct Arena {
  double* d;
  long long dcap, dtop;
  int* i;
  long long icap, itop;
  bool exhausted;

  LBFGSPP_HD Arena(void* ws, long long doubles, long long ints)
      : d(static_cast<double*>(ws)), dcap(doubles), dtop(0),
        i(reinterpret_cast<int*>(static_cast<double*>(ws) + doubles)),
        icap(ints), itop(0), exhausted(false) {}

  LBFGSPP_HD double* doubles(long long k) {
    if (dtop + k > dcap) {
      exhausted = true;
      return d;
    }
    double* p = d + dtop;
    dtop += k;
    return p;
  }
  LBFGSPP_HD int* ints(long long k) {
    if (itop + k > icap) {
      exhausted = true;
      return i;
    }
    int* p = i + itop;
    itop += k;
    return p;
  }
};

struct Mark {
  Arena& a;
  long long d, i;
  LBFGSPP_HD explicit Mark(Arena& a_) : a(a_), d(a_.dtop), i(a_.itop) {}
  LBFGSPP_HD ~Mark() {
    a.dtop = d;
    a.itop = i;
  }
};

// Bytes of a workspace of `doubles` doubles and `ints` ints, 8-aligned.
LBFGSPP_HD inline long long workspace_bytes(long long doubles,
                                            long long ints) {
  return 8 * doubles + 8 * ((ints + 1) / 2);
}

// The L-BFGS solve's doubles: the history's s, y [m, n] and ys, alpha
// [m]; grad, xp, gradp, drt, vs, vy [n]; the past ring; a search's best
// point x_lo, grad_lo [n].  Its ints: the two-loop's order [m].
LBFGSPP_HD inline long long native_doubles(int n, int m, int past) {
  return 2LL * m * n + 2LL * m + 8LL * n + dmax(past, 1);
}
LBFGSPP_HD inline long long native_workspace(int n, int m, int past) {
  return workspace_bytes(native_doubles(n, m, past), m);
}

template <class X>
LBFGSPP_HD inline double dot(const double* a, const double* b, int n) {
  return sum<X>(n, [&](int i) { return a[i] * b[i]; });
}

template <class X>
LBFGSPP_HD inline double nrm2(const double* a, int n) {
  return dsqrt(dot<X>(a, a, n));
}

template <class X>
LBFGSPP_HD inline void axpy(double* y, double alpha, const double* x,
                            int n) {
  X::each(n, [&](int i) { y[i] += alpha * x[i]; });
}

// Two vector copies in one pass.
template <class X>
LBFGSPP_HD inline void copy2(double* d1, const double* s1, double* d2,
                             const double* s2, int n) {
  X::each(n, [&](int i) {
    d1[i] = s1[i];
    d2[i] = s2[i];
  });
}

// Ring-buffer correction history with the two-loop recursion
// (BFGSMat.h:35-302 semantics).
template <class X>
struct History {
  int n, m, ncorr, ptr;
  double theta;
  double *s, *y, *ys, *alpha;
  int* order;

  LBFGSPP_HD History(int n_, int m_, Arena& ar)
      : n(n_), m(m_), ncorr(0), ptr(m_), theta(1.0),
        s(ar.doubles(static_cast<long long>(n_) * m_)),
        y(ar.doubles(static_cast<long long>(n_) * m_)),
        ys(ar.doubles(m_)), alpha(ar.doubles(m_)), order(ar.ints(m_)) {}

  LBFGSPP_HD double* srow(int j) { return s + static_cast<long long>(j) * n; }
  LBFGSPP_HD double* yrow(int j) { return y + static_cast<long long>(j) * n; }

  LBFGSPP_HD void add(const double* sv, const double* yv) {
    int loc = ptr % m;
    copy2<X>(srow(loc), sv, yrow(loc), yv, n);
    double d = dot<X>(sv, yv, n);
    X::put(ys + loc, d);
    theta = dot<X>(yv, yv, n) / d;
    if (ncorr < m) ++ncorr;
    ptr = loc + 1;
  }

  // res = a * H * v (two-loop recursion, newest -> oldest -> newest).
  // (ys, alpha and order are put by lane 0; each is read after the
  // X::sync() that ends the next vector op.)
  LBFGSPP_HD void apply_hv(const double* v, double a, double* res) {
    X::each(n, [&](int i) { res[i] = a * v[i]; });
    int j = ptr % m;
    for (int i = 0; i < ncorr; ++i) {
      j = (j + m - 1) % m;
      const double aj = dot<X>(srow(j), res, n) / ys[j];
      X::put(alpha + j, aj);
      axpy<X>(res, -aj, yrow(j), n);
      X::put(order + i, j);
    }
    X::each(n, [&](int i) { res[i] /= theta; });
    for (int i = ncorr - 1; i >= 0; --i) {
      int jj = order[i];
      double beta = dot<X>(yrow(jj), res, n) / ys[jj];
      axpy<X>(res, alpha[jj] - beta, srow(jj), n);
    }
  }
};

struct LsResult {
  double step, fx, dg;
  int status;
  int nfev;
};

// ---------------------------------------------------------------------------
// Line searches.  All update x/grad in place and return the accepted state.
// ---------------------------------------------------------------------------

template <class X, class F>
LBFGSPP_HD LsResult ls_backtracking(const F& f, Arena& ar, const Params& p,
                                    const double* xp, const double* drt,
                                    double step_max, double step, double fx,
                                    double* x, double* grad, double dg,
                                    int n) {
  const double dec = 0.5, inc = 2.1;
  (void)ar;
  (void)step_max;
  if (step <= 0.0) return {step, fx, dg, kLsInvalidStep, 0};
  const double fx_init = fx, dg_init = dg;
  if (dg_init > 0.0) return {step, fx, dg, kLsNotDescent, 0};
  const double test_decr = p.ftol * dg_init;
  double width = 0.0;
  int nfev = 0;
  for (int it = 0; it < p.max_linesearch; ++it) {
    X::each(n, [&](int i) { x[i] = xp[i] + step * drt[i]; });
    fx = f(X{}, x, grad, n);
    ++nfev;
    if (is_nan(fx) || fx > fx_init + step * test_decr) {
      width = dec;
    } else {
      dg = dot<X>(grad, drt, n);
      if (p.linesearch == 1) return {step, fx, dg, kRunning, nfev};
      if (dg < p.wolfe * dg_init) {
        width = inc;
      } else {
        if (p.linesearch == 2) return {step, fx, dg, kRunning, nfev};
        if (dg > -p.wolfe * dg_init) {
          width = dec;
        } else {
          return {step, fx, dg, kRunning, nfev};
        }
      }
    }
    if (step < p.min_step) return {step, fx, dg, kLsStepTooSmall, nfev};
    if (step > p.max_step) return {step, fx, dg, kLsStepTooLarge, nfev};
    step *= width;
  }
  return {step, fx, dg, kLsMaxLinesearch, nfev};
}

template <class X, class F>
LBFGSPP_HD LsResult ls_bracketing(const F& f, Arena& ar, const Params& p,
                                  const double* xp, const double* drt,
                                  double step_max, double step, double fx,
                                  double* x, double* grad, double dg,
                                  int n) {
  (void)ar;
  (void)step_max;
  if (step <= 0.0) return {step, fx, dg, kLsInvalidStep, 0};
  const double fx_init = fx, dg_init = dg;
  if (dg_init > 0.0) return {step, fx, dg, kLsNotDescent, 0};
  const double test_decr = p.ftol * dg_init;
  double step_lo = 0.0;
  double step_hi = kInf;
  int nfev = 0;
  for (int it = 0; it < p.max_linesearch; ++it) {
    X::each(n, [&](int i) { x[i] = xp[i] + step * drt[i]; });
    fx = f(X{}, x, grad, n);
    ++nfev;
    if (!is_finite(fx) || fx > fx_init + step * test_decr) {
      step_hi = step;
    } else {
      dg = dot<X>(grad, drt, n);
      if (p.linesearch == 1) return {step, fx, dg, kRunning, nfev};
      if (dg < p.wolfe * dg_init) {
        step_lo = step;
      } else {
        if (p.linesearch == 2) return {step, fx, dg, kRunning, nfev};
        if (dg > -p.wolfe * dg_init) {
          step_hi = step;
        } else {
          return {step, fx, dg, kRunning, nfev};
        }
      }
    }
    if (step_lo > step_hi) return {step, fx, dg, kLsBracketInverted, nfev};
    if (step < p.min_step) return {step, fx, dg, kLsStepTooSmall, nfev};
    if (step > p.max_step) return {step, fx, dg, kLsStepTooLarge, nfev};
    step = is_inf(step_hi) ? 2.0 * step : step_lo / 2.0 + step_hi / 2.0;
  }
  return {step, fx, dg, kLsMaxLinesearch, nfev};
}

// Safeguarded quadratic interpolation for the Nocedal-Wright zoom
// (LineSearchNocedalWright.h:30-60 semantics; falls back to bisection near
// the ends / on NaN / outside the bracket).
LBFGSPP_HD inline double nw_quad_interp(double step_lo, double step_hi,
                                        double fx_lo, double fx_hi,
                                        double dg_lo) {
  const double fdiff = fx_hi - fx_lo;
  const double sdiff = step_hi - step_lo;
  const double smid = (step_hi + step_lo) / 2.0;
  double cand = fdiff * step_lo - smid * sdiff * dg_lo;
  cand = cand / (fdiff - sdiff * dg_lo);
  const bool nan = !is_finite(cand);
  const double end_dist =
      dmin(dabs(cand - step_lo), dabs(cand - step_hi));
  const bool near_end = end_dist < 0.01 * dabs(sdiff);
  const bool bisect = nan || cand <= dmin(step_lo, step_hi) ||
                      cand >= dmax(step_lo, step_hi) || near_end;
  return bisect ? smid : cand;
}

template <class X, class F>
LBFGSPP_HD LsResult ls_nocedalwright(const F& f, Arena& ar, const Params& p,
                                     const double* xp, const double* drt,
                                     double step_max, double step, double fx,
                                     double* x, double* grad, double dg,
                                     int n) {
  (void)step_max;
  if (step <= 0.0) return {step, fx, dg, kLsInvalidStep, 0};
  const double expansion = 2.0;
  const double fx_init = fx, dg_init = dg;
  if (dg_init > 0.0) return {step, fx, dg, kLsNotDescent, 0};
  const double test_decr = p.ftol * dg_init;
  const double test_curv = -p.wolfe * dg_init;

  double step_hi = 0.0, fx_hi = 0.0;
  double step_lo = 0.0, fx_lo = fx_init, dg_lo = dg_init;
  Mark mark(ar);
  double* x_lo = ar.doubles(n);
  double* grad_lo = ar.doubles(n);
  copy2<X>(x_lo, xp, grad_lo, grad, n);
  int nfev = 0;
  int it = 0;

  // Bracketing phase.
  for (;;) {
    X::each(n, [&](int i) { x[i] = xp[i] + step * drt[i]; });
    fx = f(X{}, x, grad, n);
    dg = dot<X>(grad, drt, n);
    ++nfev;
    if (fx - fx_init > step * test_decr ||
        (0.0 < step_lo && fx >= fx_lo)) {
      step_hi = step;
      fx_hi = fx;
      break;
    }
    if (dabs(dg) <= test_curv) return {step, fx, dg, kRunning, nfev};
    step_hi = step_lo;
    fx_hi = fx_lo;
    step_lo = step;
    fx_lo = fx;
    dg_lo = dg;
    copy2<X>(x_lo, x, grad_lo, grad, n);
    if (dg >= 0.0) break;
    ++it;
    if (it >= p.max_linesearch) return {step, fx, dg, kRunning, nfev};
    step *= expansion;
  }

  // Zoom phase.
  for (;;) {
    step = nw_quad_interp(step_lo, step_hi, fx_lo, fx_hi, dg_lo);
    X::each(n, [&](int i) { x[i] = xp[i] + step * drt[i]; });
    fx = f(X{}, x, grad, n);
    dg = dot<X>(grad, drt, n);
    ++nfev;
    if (fx - fx_init > step * test_decr || fx >= fx_lo) {
      if (step == step_hi) return {step, fx, dg, kLsNumerical, nfev};
      step_hi = step;
      fx_hi = fx;
    } else {
      if (dabs(dg) <= test_curv) return {step, fx, dg, kRunning, nfev};
      if (dg * (step_hi - step_lo) >= 0.0) {
        step_hi = step_lo;
        fx_hi = fx_lo;
      }
      if (step == step_lo) return {step, fx, dg, kLsNumerical, nfev};
      step_lo = step;
      fx_lo = fx;
      dg_lo = dg;
      copy2<X>(x_lo, x, grad_lo, grad, n);
    }
    ++it;
    if (it >= p.max_linesearch) {
      // Exhausted: restore the best-so-far (lo) state.
      if (step_lo <= 0.0) return {step, fx, dg, kLsNumerical, nfev};
      copy2<X>(x, x_lo, grad, grad_lo, n);
      return {step_lo, fx_lo, dg_lo, kRunning, nfev};
    }
  }
}

// More-Thuente step selection helpers (LineSearchMoreThuente.h:34-189
// semantics; single-stage psi formulation).
LBFGSPP_HD inline double mt_quad_fga(double a, double b, double fa,
                                     double ga, double fb) {
  const double ba = b - a;
  const double w = 0.5 * ba * ga / (fa - fb + ba * ga);
  return a + w * ba;
}

LBFGSPP_HD inline double mt_quad_gg(double a, double b, double ga,
                                    double gb) {
  return a + ga / (ga - gb) * (b - a);
}

LBFGSPP_HD inline bool mt_cubic(double a, double b, double fa, double fb,
                                double ga, double gb, double* out) {
  *out = b;  // default when no minimizer exists (oracle returns b)
  const double eps = kEps;
  const double apb = a + b, ba = b - a, ba2 = ba * ba;
  const double fba = fb - fa, gba = gb - ga;
  const double z3 = (ga + gb) * ba - 2.0 * fba;
  const double z2 = 0.5 * (gba * ba2 - 3.0 * apb * z3);
  const double z1 = fba * ba2 - apb * z2 - (a * apb + b * b) * z3;
  if (dabs(z3) < eps * dabs(z2) || dabs(z3) < eps * dabs(z1)) {
    if (z2 * ba > 0.0) {
      *out = -0.5 * z1 / z2;
      return true;
    }
    return false;
  }
  const double u = z2 / (3.0 * z3), v = z1 / z2;
  const double vu = v / u;
  if (vu > 1.0 || is_nan(vu)) return false;
  double r1, r2;
  if (dabs(u) >= dabs(v)) {
    const double w = 1.0 + dsqrt(1.0 - vu);
    r1 = -u * w;
    r2 = -v / w;
  } else {
    const double sqrtd =
        dsqrt(dabs(u)) * dsqrt(dabs(v)) * dsqrt(1.0 - u / v);
    r1 = -u - sqrtd;
    r2 = -u + sqrtd;
  }
  *out = (z3 * ba > 0.0) ? dmax(r1, r2) : dmin(r1, r2);
  return true;
}

LBFGSPP_HD inline double mt_step_selection(double al, double au, double at,
                                           double fl, double fu, double ft,
                                           double gl, double gu, double gt) {
  if (al == au) return al;
  if (is_inf(ft) || is_inf(gt)) return (al + at) / 2.0;
  const double deltal = 1.1, deltau = 0.66;
  double ac;
  const bool ac_exists = mt_cubic(al, at, fl, ft, gl, gt, &ac);
  if (ft > fl) {
    const double aq = mt_quad_fga(al, at, fl, gl, ft);
    if (!ac_exists) return aq;
    return (dabs(ac - al) < dabs(aq - al)) ? ac : (aq + ac) / 2.0;
  }
  const double as = mt_quad_gg(al, at, gl, gt);
  if (gt * gl < 0.0) return (dabs(ac - at) >= dabs(as - at)) ? ac : as;
  if (dabs(gt) < dabs(gl)) {
    double res = (ac_exists && (ac - at) * (at - al) > 0.0 &&
                  dabs(ac - at) < dabs(as - at))
                     ? ac
                     : as;
    return (at > al) ? dmin(at + deltau * (au - at), res)
                     : dmax(at + deltau * (au - at), res);
  }
  if (is_inf(au) || is_inf(fu) || is_inf(gu))
    return at + deltal * (at - al);
  double ae;
  mt_cubic(at, au, ft, fu, gt, gu, &ae);
  return (at > al) ? dmin(at + deltau * (au - at), ae)
                   : dmax(at + deltau * (au - at), ae);
}

template <class X, class F>
LBFGSPP_HD LsResult ls_morethuente(const F& f, Arena& ar, const Params& p,
                                   const double* xp, const double* drt,
                                   double step_max, double step, double fx,
                                   double* x, double* grad, double dg,
                                   int n) {
  if (step <= 0.0 || step < p.min_step || step > step_max)
    return {step, fx, dg, kLsInvalidStep, 0};
  const double fx_init = fx, dg_init = dg;
  if (dg_init >= 0.0) return {step, fx, dg, kLsNotDescent, 0};
  const double test_decr = p.ftol * dg_init;
  const double test_curv = -p.wolfe * dg_init;

  double I_lo = 0.0, I_hi = kInf;
  double fI_lo = 0.0, fI_hi = kInf;
  double gI_lo = (1.0 - p.ftol) * dg_init;
  double gI_hi = kInf;
  double psiI_lo = 0.0;
  Mark mark(ar);
  double* x_lo = ar.doubles(n);
  double* grad_lo = ar.doubles(n);
  copy2<X>(x_lo, xp, grad_lo, grad, n);
  double fx_lo = fx_init, dg_lo = dg_init;
  bool bracketed = false;
  bool use_sg = p.min_step > 0.0;
  double I_width = kInf;
  double I_width_prev = I_width;
  int shrink_fail = 0;
  const double delta_max = 1.1, delta_min = 7.0 / 12.0, shrink = 0.66;
  int nfev = 0;

  for (int it = 0; it < p.max_linesearch; ++it) {
    X::each(n, [&](int i) { x[i] = xp[i] + step * drt[i]; });
    fx = f(X{}, x, grad, n);
    ++nfev;
    dg = dot<X>(grad, drt, n);
    const double psit = fx - fx_init - step * test_decr;
    const double dpsit = dg - test_decr;
    if (psit <= 0.0 && dabs(dg) <= test_curv)
      return {step, fx, dg, kRunning, nfev};
    if (step <= p.min_step && (psit > 0.0 || dpsit >= 0.0))
      return {step, fx, dg, kRunning, nfev};
    if (step >= step_max && psit <= 0.0 && dpsit < 0.0)
      return {step, fx, dg, kRunning, nfev};

    const double ft = psit, gt = dpsit;
    if (use_sg && psit <= 0.0 && dpsit < 0.0) use_sg = false;

    double new_step;
    const bool in_case_2 = (psit <= psiI_lo) && (dpsit * (I_lo - step) > 0.0);
    if (in_case_2) {
      new_step = dmin(step_max, step + delta_max * (step - I_lo));
    } else {
      double sel = mt_step_selection(I_lo, I_hi, step, fI_lo, fI_hi, ft,
                                     gI_lo, gI_hi, gt);
      if (sel < p.min_step) sel = p.min_step;
      if (sel > step_max) sel = step_max;
      if (use_sg) {
        const double sg_upper = dmax(p.min_step, delta_min * step);
        sel = dmin(dmax(sel, p.min_step), sg_upper);
      }
      new_step = sel;
    }

    const bool case1 = psit > psiI_lo;
    const bool case3 = !case1 && !in_case_2;
    if (case1) {
      I_hi = step;
      fI_hi = ft;
      gI_hi = gt;
    } else if (case3) {
      I_hi = I_lo;
      fI_hi = fI_lo;
      gI_hi = gI_lo;
    }
    if (!case1) {
      I_lo = step;
      fI_lo = ft;
      gI_lo = gt;
      psiI_lo = psit;
      copy2<X>(x_lo, x, grad_lo, grad, n);
      fx_lo = fx;
      dg_lo = dg;
    }

    const double i_left = dmin(I_lo, I_hi);
    const double i_right = dmax(I_lo, I_hi);
    if (!bracketed && !in_case_2 && i_left >= p.min_step &&
        i_right <= step_max)
      bracketed = true;
    if (bracketed) {
      I_width_prev = I_width;
      I_width = dabs(I_hi - I_lo);
      if (is_finite(I_width_prev) && I_width > shrink * I_width_prev)
        ++shrink_fail;
      else
        shrink_fail = 0;
      if (shrink_fail >= 2) {
        new_step = (I_lo + I_hi) / 2.0;
        shrink_fail = 0;
      }
    }
    step = new_step;
  }
  // Exhausted: restore the best-so-far (lo) state.
  copy2<X>(x, x_lo, grad, grad_lo, n);
  return {I_lo, fx_lo, dg_lo, kRunning, nfev};
}

template <class X, class F>
LBFGSPP_HD LsResult run_linesearch(int which, const F& f, Arena& ar,
                                   const Params& p, const double* xp,
                                   const double* drt, double step_max,
                                   double step, double fx, double* x,
                                   double* grad, double dg, int n) {
  switch (which) {
    case 0: return ls_backtracking<X>(f, ar, p, xp, drt, step_max, step, fx, x,
                                   grad, dg, n);
    case 1: return ls_bracketing<X>(f, ar, p, xp, drt, step_max, step, fx, x,
                                 grad, dg, n);
    case 3: return ls_morethuente<X>(f, ar, p, xp, drt, step_max, step, fx, x,
                                  grad, dg, n);
    case 2:
    default: return ls_nocedalwright<X>(f, ar, p, xp, drt, step_max, step, fx,
                                     x, grad, dg, n);
  }
}

// ---------------------------------------------------------------------------
// Built-in objectives (callback-free; ids match native/__init__.py).
// ---------------------------------------------------------------------------

// Rosenbrock sums its n / 2 terms over the pairs (2j, 2j + 1): under Warp,
// lane l takes the pairs j = l (mod 32), so a pair never straddles lanes.
struct Rosenbrock {
  template <class X>
  LBFGSPP_HD double operator()(X, const double* x, double* grad,
                               int n) const {
    const double fx = sum<X>((n + 1) / 2, [&](int j) {
      const int i = 2 * j;
      const double t1 = 1.0 - x[i];
      const double t2 = 10.0 * (x[i + 1] - x[i] * x[i]);
      grad[i + 1] = 20.0 * t2;
      grad[i] = -2.0 * (x[i] * grad[i + 1] + t1);
      return t1 * t1 + t2 * t2;
    });
    X::sync();
    return fx;
  }
};

struct Quadratic {
  template <class X>
  LBFGSPP_HD double operator()(X, const double* x, double* grad,
                               int n) const {
    const double fx = sum<X>(n, [&](int i) {
      const double r = x[i] - i;
      grad[i] = 2.0 * r;
      return r * r;
    });
    X::sync();
    return fx;
  }
};

// Full L-BFGS solve (LBFGS.h:79-173 semantics) on a workspace of
// native_workspace(n, p.m, p.past) bytes.
//   ls_kind: 0 backtracking, 1 bracketing, 2 nocedalwright, 3 morethuente
//   x: in/out iterate [n]; out_fx/out_gnorm/out_niter/out_nfev: outputs
// Returns a Status code (on every lane; lane 0 writes the outputs).
template <class X, class F>
LBFGSPP_HD int minimize(const F& f, int n, double* x, const Params& p,
                        int ls_kind, void* ws, double* out_fx,
                        double* out_gnorm, int* out_niter, int* out_nfev) {
  Arena ar(ws, native_doubles(n, p.m, p.past), p.m);
  History<X> hist(n, p.m, ar);
  double* grad = ar.doubles(n);
  double* xp = ar.doubles(n);
  double* gradp = ar.doubles(n);
  double* drt = ar.doubles(n);
  double* vs = ar.doubles(n);
  double* vy = ar.doubles(n);
  const int nring = dmax(p.past, 1);
  double* fx_ring = ar.doubles(nring);
  X::each(nring, [&](int i) { fx_ring[i] = 0.0; });
  const double eps_machine = kEps;

  double fx = f(X{}, x, grad, n);
  int nfev = 1;
  double gnorm = nrm2<X>(grad, n);
  if (p.past > 0) X::put(fx_ring, fx);

  int k = 1;
  int status = kRunning;
  if (gnorm <= p.epsilon || gnorm <= p.epsilon_rel * nrm2<X>(x, n)) {
    status = kConvergedGrad;
  } else {
    X::each(n, [&](int i) { drt[i] = -grad[i]; });
    double step = 1.0 / nrm2<X>(drt, n);

    for (;;) {
      copy2<X>(xp, x, gradp, grad, n);
      double dg = dot<X>(grad, drt, n);

      X::mark(kSearchBegin);
      LsResult ls = run_linesearch<X>(ls_kind, f, ar, p, xp, drt,
                                      p.max_step, step, fx, x, grad, dg, n);
      X::mark(kSearchEnd);
      nfev += ls.nfev;
      fx = ls.fx;
      gnorm = nrm2<X>(grad, n);
      if (ls.status != kRunning) {
        status = ls.status;
        break;
      }
      if (gnorm <= p.epsilon || gnorm <= p.epsilon_rel * nrm2<X>(x, n)) {
        status = kConvergedGrad;
        break;
      }
      if (p.past > 0) {
        const double fxd = fx_ring[k % p.past];
        if (k >= p.past &&
            dabs(fxd - fx) <=
                p.delta * dmax(dmax(dabs(fx), dabs(fxd)), 1.0)) {
          status = kConvergedDelta;
          break;
        }
        X::sync();  // every lane has read fxd before lane 0 overwrites it
        X::put(fx_ring + k % p.past, fx);
      }
      if (p.max_iterations != 0 && k >= p.max_iterations) {
        status = kMaxIterations;
        break;
      }

      X::mark(kDirectionBegin);
      X::each(n, [&](int i) {
        vs[i] = x[i] - xp[i];
        vy[i] = grad[i] - gradp[i];
      });
      if (dot<X>(vs, vy, n) > eps_machine * dot<X>(vy, vy, n))
        hist.add(vs, vy);

      hist.apply_hv(grad, -1.0, drt);
      X::mark(kDirectionEnd);
      step = 1.0;
      ++k;
    }
  }

  X::put(out_fx, fx);
  X::put(out_gnorm, gnorm);
  X::put(out_niter, k);
  X::put(out_nfev, nfev);
  return ar.exhausted ? kWorkspaceExhausted : status;
}

}  // namespace lbfgspp_native
