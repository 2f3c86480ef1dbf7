// The native L-BFGS-B core (box constraints), one source for the host and
// the card.
//
// The port's own copy of lbfgspp_tpu/native/lbfgsb.cpp (the B-mode middle
// matrix, the generalized Cauchy point, BOXCQP subspace minimization and
// the solve loop; reference semantics LBFGSB.h, BFGSMat.h, Cauchy.h,
// SubspaceMin.h) under the treatment of core.h: LBFGSPP_HD functions
// templated on the execution policy X, the objective a functor, and every
// std::vector a slice of the caller's workspace.  The temporaries come from
// core.h's bump allocator (Arena), which each function gives back on return
// (Mark); their peak, derived at native_doubles_b, is bounded by n (index
// sets and their values) and 2m (the middle-matrix vectors), so
// native_workspace_b(n, m, past) bytes always suffice.  std::stable_sort of
// the Cauchy break points becomes a stable merge sort, which orders them as
// any stable sort does.
//
// Under the Warp policy: the break points' sort and each LU factorization
// of a middle matrix run on lane 0; the index sets are built by
// X::compact, in index order as the reference's push_backs; a product
// over the history gives each of its outputs to one lane.
#pragma once

#include "core.h"

namespace lbfgspp_native {

struct ParamsB {
  int m;
  double epsilon;
  double epsilon_rel;
  int past;
  double delta;
  int max_iterations;
  int max_submin;
  int max_linesearch;
  double min_step;
  double max_step;
  double ftol;
  double wolfe;
};

// The solve's doubles and ints, the peak of the bump allocator (Arena),
// with d = 2m (the padded middle matrix's order; nf free coordinates and
// nact newly active ones, nf + nact <= n).  Held for the whole solve: the
// history's s, y [m, n], ys [m], minv and mdense [d, d]; grad, xp, gradp,
// drt, xcp, vs, vy [n]; vecc [d]; the past ring; the ints newact and
// fv [n].  On top, one call's temporaries at a time, each given back on
// return (Mark):
//   BHist::refactor             scaled [d, d]                       d^2
//                               ints: the swaps and the end [d + 1]
//   the line search             x_lo, grad_lo                       2n
//   cauchy_point                brk, vecd [n], vecp, cache, wact [d],
//                               apply_mv's pad [d]              2n + 4d
//                               ints: ord [n], the sort's merge [n]  2n
//   subspace_minimize           vecc, vecl, vecu, negc, vecy, yfb, lam,
//                               mu [nf]; per BOXCQP iteration rhs, tmp
//                               [|yp|], ll [|yl|], uu [|yu|] (<= 2nf in
//                               all, their index sets partition the free
//                               set) under solve_ptbp's mid [dd, dd], wpv
//                               [dd], lu_solve's copy [dd, dd] (dd = 2c
//                               <= d) or apply_ptbqv's rhs, mv [d] over
//                               apply_mv's d; after them fy [d] and
//                               res [<= nf] over apply_ptwmv's 2d;
//                               before them compute_ftbab's ad [nact],
//                               rhs [d] over apply_ptwmv's 2d, beside
//                               vecc [nf]:  at most 10n + 2d^2 + d
//                               ints: lset, uset, pset, yl, yu, yp [nf]
//                               and lu_solve's swaps [dd]      6n + d
// The largest are the subspace step's (10n + 2d^2 + d >= 2n + 4d, as
// 2d^2 >= 3d for d >= 2; 6n + d ints beside the held 2n), so this is exact
// for a solve that reaches it, and a workspace of native_workspace_b bytes
// never runs out.
LBFGSPP_HD inline long long native_doubles_b(int n, int m, int past) {
  const long long d = 2LL * m, nn = n;
  return d * nn + m + 2 * d * d + 7 * nn + d + dmax(past, 1) +
         10 * nn + 2 * d * d + d;
}
LBFGSPP_HD inline long long native_ints_b(int n, int m) {
  return 2LL * n + 6LL * n + 2LL * m;
}
LBFGSPP_HD inline long long native_workspace_b(int n, int m, int past) {
  return workspace_bytes(native_doubles_b(n, m, past), native_ints_b(n, m));
}

// A vector of at most the capacity it was taken with.
struct DVec {
  double* p;
  int n;
  LBFGSPP_HD DVec(Arena& ar, int cap) : p(ar.doubles(cap)), n(0) {}
  LBFGSPP_HD int size() const { return n; }
  LBFGSPP_HD double* data() { return p; }
  LBFGSPP_HD const double* data() const { return p; }
  LBFGSPP_HD double& operator[](int i) { return p[i]; }
  LBFGSPP_HD const double& operator[](int i) const { return p[i]; }
  template <class X>
  LBFGSPP_HD void assign(int k, double v) {
    n = k;
    X::each(k, [&](int i) { p[i] = v; });
  }
};

struct IVec {
  int* p;
  int n;
  LBFGSPP_HD IVec(Arena& ar, int cap) : p(ar.ints(cap)), n(0) {}
  LBFGSPP_HD int size() const { return n; }
  LBFGSPP_HD bool empty() const { return n == 0; }
  LBFGSPP_HD int& operator[](int i) { return p[i]; }
  LBFGSPP_HD const int& operator[](int i) const { return p[i]; }
  LBFGSPP_HD void clear() { n = 0; }
  template <class X>
  LBFGSPP_HD void push_back(int v) {
    X::put(p + n, v);
    ++n;
  }
};

// std::inner_product(a, a + n, b, 0.0): the serial sum of a short vector
// or of one lane's own output.
LBFGSPP_HD inline double inner(const double* a, const double* b, int n) {
  double init = 0.0;
  for (int i = 0; i < n; ++i) init = init + a[i] * b[i];
  return init;
}

// Dense LU with partial pivoting (lbfgsb.cpp's lu_solve, split in two so
// that one factorization serves many right-hand sides with the same
// operations on each).  lu_factor factors a [n, n] in place (multipliers
// below the diagonal, swapped with their rows as lu_solve swaps whole rows)
// with the row swaps in piv, and returns the step whose pivot is zero, or
// n.  lu_apply puts b (stride apart) through the first kend steps: their
// swaps first, which carry each entry to the row whose multipliers it
// met, then their updates; and, when kend == n, the back substitution.
// Each entry of b so takes lu_solve's operations in its order, and a
// singular matrix leaves b as lu_solve leaves it.  One lane's code.
LBFGSPP_HD inline int lu_factor(double* a, int* piv, int n) {
  for (int k = 0; k < n; ++k) {
    int p = k;
    for (int i = k + 1; i < n; ++i)
      if (dabs(a[i * n + k]) > dabs(a[p * n + k])) p = i;
    if (a[p * n + k] == 0.0) return k;
    piv[k] = p;
    if (p != k) {
      for (int j = 0; j < n; ++j) {
        const double t = a[k * n + j];
        a[k * n + j] = a[p * n + j];
        a[p * n + j] = t;
      }
    }
    for (int i = k + 1; i < n; ++i) {
      const double f = a[i * n + k] / a[k * n + k];
      a[i * n + k] = f;
      for (int j = k + 1; j < n; ++j) a[i * n + j] -= f * a[k * n + j];
    }
  }
  return n;
}

LBFGSPP_HD inline void lu_apply(const double* a, const int* piv, int kend,
                                double* b, int stride, int n) {
  for (int k = 0; k < kend; ++k) {
    const int p = piv[k];
    if (p != k) {
      const double t = b[k * stride];
      b[k * stride] = b[p * stride];
      b[p * stride] = t;
    }
  }
  for (int k = 0; k < kend; ++k)
    for (int i = k + 1; i < n; ++i)
      b[i * stride] -= a[i * n + k] * b[k * stride];
  if (kend < n) return;
  for (int i = n - 1; i >= 0; --i) {
    for (int j = i + 1; j < n; ++j) b[i * stride] -= a[i * n + j] * b[j * stride];
    b[i * stride] /= a[i * n + i];
  }
}

// Dense LU solve of the small middle systems (2m x 2m); `a_in` is copied
// (lbfgsb.cpp takes it by value) and b solved in place.  One lane's code.
LBFGSPP_HD inline void lu_solve(const double* a_in, double* b, int n,
                                Arena& ar) {
  Mark mark(ar);
  double* a = ar.doubles(static_cast<long long>(n) * n);
  int* piv = ar.ints(n);
  for (int i = 0; i < n * n; ++i) a[i] = a_in[i];
  lu_apply(a, piv, lu_factor(a, piv, n), b, 1, n);
}

// B-mode history: ring buffer + 2m x 2m middle matrix (BFGSMat.h:99-146),
// slot-indexed with identity padding exactly like the JAX design.  Its
// products over the history (W'v, S'S and L rows, the P'BP Gram entries)
// give each output to one lane, which sums it serially in the reference's
// order; the products over n-vectors use the policy's reductions.
template <class X>
struct BHist {
  int n, m, ncorr, ptr;
  double theta;
  double *s, *y, *ys;  // [m, n], [m, n], [m]
  double* minv;        // [2m, 2m], S'S block unscaled
  double* mdense;      // [2m, 2m] inverse of scaled minv
  Arena* ar;           // the temporaries

  LBFGSPP_HD BHist(int n_, int m_, Arena& ar_)
      : n(n_), m(m_),
        s(ar_.doubles(static_cast<long long>(n_) * m_)),
        y(ar_.doubles(static_cast<long long>(n_) * m_)),
        ys(ar_.doubles(m_)),
        minv(ar_.doubles(4LL * m_ * m_)),
        mdense(ar_.doubles(4LL * m_ * m_)), ar(&ar_) {
    reset(n_, m_);
  }

  LBFGSPP_HD void reset(int n_, int m_) {
    n = n_;
    m = m_;
    ncorr = 0;
    ptr = m_;
    theta = 1.0;
    X::each(n, [&](int i) {
      for (int j = 0; j < m; ++j) {
        s[static_cast<long long>(j) * n + i] = 0.0;
        y[static_cast<long long>(j) * n + i] = 0.0;
      }
    });
    const int d = 2 * m;
    X::each(d * d, [&](int t) {
      minv[t] = (t % (d + 1) == 0) ? 1.0 : 0.0;
      if (t < m) ys[t] = 0.0;
    });
    refactor();
  }

  LBFGSPP_HD double* srow(int j) {
    return s + static_cast<long long>(j) * n;
  }
  LBFGSPP_HD double* yrow(int j) {
    return y + static_cast<long long>(j) * n;
  }
  LBFGSPP_HD const double* srow(int j) const {
    return s + static_cast<long long>(j) * n;
  }
  LBFGSPP_HD const double* yrow(int j) const {
    return y + static_cast<long long>(j) * n;
  }

  // mdense = inv(minv with its SS block scaled by theta): one
  // factorization on lane 0, then each column on its own lane (the
  // reference solves column by column, refactoring each time; the
  // factorization is the same every time, so each column's bits are too).
  LBFGSPP_HD void refactor() {
    const int d = 2 * m;
    Mark mark(*ar);
    double* scaled = ar->doubles(static_cast<long long>(d) * d);
    int* piv = ar->ints(d + 1);  // the swaps, then the step lu_factor ended
    X::each(d * d, [&](int t) {
      const bool ss = t / d >= m && t % d >= m;
      scaled[t] = ss ? minv[t] * theta : minv[t];
    });
    if (X::leader()) piv[d] = lu_factor(scaled, piv, d);
    X::sync();
    const int kend = piv[d];
    X::each(d, [&](int c) {
      for (int r = 0; r < d; ++r) mdense[r * d + c] = (r == c) ? 1.0 : 0.0;
      lu_apply(scaled, piv, kend, mdense + c, d, d);
    });
  }

  LBFGSPP_HD void add(const double* sv, const double* yv) {
    const int loc = ptr % m;
    copy2<X>(srow(loc), sv, yrow(loc), yv, n);
    const double d = dot<X>(sv, yv, n);
    X::put(ys + loc, d);
    theta = dot<X>(yv, yv, n) / d;
    if (ncorr < m) ++ncorr;
    ptr = loc + 1;

    const int dd = 2 * m;
    X::put(minv + loc * dd + loc, -d);
    // S'S row/col (valid slots)
    X::each(ncorr, [&](int j) {
      const double v = inner(srow(j), sv, n);
      minv[(m + loc) * dd + (m + j)] = v;
      minv[(m + j) * dd + (m + loc)] = v;
    });
    // Stale y column when the buffer is full
    if (ncorr >= m) {
      X::each(m, [&](int i) {
        minv[(m + i) * dd + loc] = 0.0;
        minv[loc * dd + (m + i)] = 0.0;
      });
    }
    // L row for the new s: ring distance 1..ncorr-1
    X::each(ncorr - 1, [&](int t) {
      const int yloc = (loc + m - 1 - t) % m;
      const double v = inner(sv, yrow(yloc), n);
      minv[(m + loc) * dd + yloc] = v;
      minv[yloc * dd + (m + loc)] = v;
    });
    refactor();
  }

  // W'v with W = [Y, theta*S]; compact [2*ncorr] (slot order; slots fill
  // sequentially so compact == slot prefix).
  LBFGSPP_HD void apply_wtv(const double* v, DVec& res) const {
    res.n = 2 * ncorr;
    X::each(2 * ncorr, [&](int t) {
      res[t] = t < ncorr ? inner(yrow(t), v, n)
                         : theta * inner(srow(t - ncorr), v, n);
    });
  }

  // M v on a compact [2*ncorr] vector via the padded dense inverse.
  LBFGSPP_HD void apply_mv(const DVec& v, DVec& res) const {
    const int d = 2 * m;
    Mark mark(*ar);
    DVec pad(*ar, d);
    pad.n = d;
    X::each(d, [&](int r) {
      pad[r] = r < ncorr ? v[r]
               : (r >= m && r < m + ncorr) ? v[ncorr + r - m] : 0.0;
    });
    res.n = 2 * ncorr;
    X::each(2 * ncorr, [&](int t) {
      const int r = t < ncorr ? t : m + t - ncorr;
      res[t] = inner(pad.data(), mdense + static_cast<long long>(r) * d, d);
    });
  }

  // Row b of W (compact)
  LBFGSPP_HD void wb(int b, DVec& res) const {
    res.n = 2 * ncorr;
    X::each(ncorr, [&](int j) {
      res[j] = yrow(j)[b];
      res[ncorr + j] = theta * srow(j)[b];
    });
  }

  LBFGSPP_HD void apply_wtpv(const IVec& pset, const double* v,
                             DVec& res) const {
    res.n = 2 * ncorr;
    X::each(2 * ncorr, [&](int t) {
      const double* row = t < ncorr ? yrow(t) : srow(t - ncorr);
      double r = 0.0;
      for (int i = 0; i < pset.size(); ++i) r += row[pset[i]] * v[i];
      res[t] = t < ncorr ? r : theta * r;
    });
  }

  LBFGSPP_HD void apply_ptwmv(const IVec& pset, const DVec& v, double scale,
                              DVec& res) const {
    if (ncorr < 1 || pset.empty()) {
      res.assign<X>(pset.size(), 0.0);
      return;
    }
    Mark mark(*ar);
    DVec mv(*ar, 2 * m);
    apply_mv(v, mv);
    res.n = pset.size();
    X::each(pset.size(), [&](int i) {
      double r = 0.0;
      for (int j = 0; j < ncorr; ++j)
        r += mv[j] * yrow(j)[pset[i]] +
             (mv[ncorr + j] * theta) * srow(j)[pset[i]];
      res[i] = r * scale;
    });
  }

  LBFGSPP_HD void compute_ftbab(const IVec& fv, const IVec& act,
                                const double* drt, DVec& res) const {
    if (ncorr < 1 || act.empty() || fv.empty()) {
      res.assign<X>(fv.size(), 0.0);
      return;
    }
    Mark mark(*ar);
    DVec ad(*ar, act.size());
    ad.n = act.size();
    X::each(act.size(), [&](int i) { ad[i] = drt[act[i]]; });
    DVec rhs(*ar, 2 * m);
    apply_wtpv(act, ad.data(), rhs);
    apply_ptwmv(fv, rhs, -1.0, res);
  }

  // sum_i a[p_i] b[p_i] over the rows ay/by (y or s) j and k.
  LBFGSPP_HD double gram(const IVec& pset, bool ay, int j, bool by,
                         int k) const {
    const double* a = ay ? yrow(j) : srow(j);
    const double* b = by ? yrow(k) : srow(k);
    double s2 = 0.0;
    for (int i = 0; i < pset.size(); ++i) s2 += a[pset[i]] * b[pset[i]];
    return s2;
  }

  // inv(P'BP) v (BFGSMat::solve_PtBP semantics)
  LBFGSPP_HD void solve_ptbp(const IVec& pset, const DVec& v,
                             DVec& res) const {
    const int np = pset.size();
    res.n = np;
    if (np == 0) return;
    if (ncorr < 1) {
      X::each(np, [&](int i) { res[i] = v[i] / theta; });
      return;
    }
    const int c = ncorr, dd = 2 * c, mm = m;
    Mark mark(*ar);
    // WP rows: wy[j][i] = y_j[p_i], ws[j][i] = s_j[p_i] (raw, no theta);
    // the lower-left block, then the upper-right as its transpose
    DVec mid(*ar, dd * dd);
    mid.n = dd * dd;
    X::each(3 * c * c, [&](int t) {
      const int blk = t / (c * c), j = (t % (c * c)) / c, k = t % c;
      if (blk == 0)
        mid[j * dd + k] = minv[j * 2 * mm + k] -
            gram(pset, true, j, true, k) / theta;
      else if (blk == 1)
        mid[(c + j) * dd + k] =
            minv[(mm + j) * 2 * mm + k] - gram(pset, false, j, true, k);
      else
        mid[(c + j) * dd + (c + k)] = theta *
            (minv[(mm + j) * 2 * mm + (mm + k)] -
             gram(pset, false, j, false, k));
    });
    X::each(c * c, [&](int t) {
      const int j = t / c, k = t % c;
      mid[j * dd + (c + k)] = mid[(c + k) * dd + j];
    });

    DVec wpv(*ar, dd);
    wpv.n = dd;
    X::each(dd, [&](int t) {
      const double* row = t < c ? yrow(t) : srow(t - c);
      double r = 0.0;
      for (int i = 0; i < np; ++i) r += row[pset[i]] * v[i];
      wpv[t] = t < c ? r : theta * r;
    });
    if (X::leader()) lu_solve(mid.data(), wpv.data(), dd, *ar);
    X::sync();
    X::each(np, [&](int i) {
      double acc = v[i] / theta;
      for (int j = 0; j < c; ++j)
        acc += (yrow(j)[pset[i]] * wpv[j] +
                srow(j)[pset[i]] * (wpv[c + j] * theta)) /
            (theta * theta);
      res[i] = acc;
    });
  }

  LBFGSPP_HD void apply_ptbqv(const IVec& pset, const IVec& qset,
                              const DVec& v, DVec& res) const {
    if (ncorr < 1 || pset.empty() || qset.empty()) {
      res.assign<X>(pset.size(), 0.0);
      return;
    }
    Mark mark(*ar);
    DVec rhs(*ar, 2 * m);
    apply_wtpv(qset, v.data(), rhs);
    DVec mv(*ar, 2 * m);
    apply_mv(rhs, mv);
    res.n = pset.size();
    X::each(pset.size(), [&](int i) {
      double r = 0.0;
      for (int j = 0; j < ncorr; ++j)
        r -= mv[j] * yrow(j)[pset[i]] +
             (mv[ncorr + j] * theta) * srow(j)[pset[i]];
      res[i] = r;
    });
  }
};

// Stable ascending sort of ord[0, k) by key[ord[i]]: a bottom-up merge
// that takes from the left run on ties, so it orders as std::stable_sort.
// One lane's code.
LBFGSPP_HD inline void stable_sort_by(int* ord, int k, const double* key,
                                      Arena& ar) {
  Mark mark(ar);
  int* tmp = ar.ints(k);
  int* src = ord;
  int* dst = tmp;
  for (int width = 1; width < k; width *= 2) {
    for (int lo = 0; lo < k; lo += 2 * width) {
      const int mid = dmin(lo + width, k), hi = dmin(lo + 2 * width, k);
      int a = lo, b = mid, o = lo;
      while (a < mid && b < hi)
        dst[o++] = (key[src[b]] < key[src[a]]) ? src[b++] : src[a++];
      while (a < mid) dst[o++] = src[a++];
      while (b < hi) dst[o++] = src[b++];
    }
    int* t = src;
    src = dst;
    dst = t;
  }
  if (src != ord)
    for (int i = 0; i < k; ++i) ord[i] = src[i];
}

// Generalized Cauchy point (Cauchy.h:86-284 semantics).
template <class X>
LBFGSPP_HD inline void cauchy_point(const BHist<X>& bfgs, const double* x0,
                                    const double* g, const double* lb,
                                    const double* ub, double* xcp,
                                    DVec& vecc, IVec& newact, IVec& fv) {
  const int n = bfgs.n;
  const double inf = kInf;
  Arena& ar = *bfgs.ar;
  vecc.assign<X>(2 * bfgs.ncorr, 0.0);
  newact.clear();

  Mark mark(ar);
  double* brk = ar.doubles(n);
  double* vecd = ar.doubles(n);
  IVec ord(ar, n);
  X::each(n, [&](int i) {
    xcp[i] = x0[i];
    double bi;
    if (lb[i] == ub[i])
      bi = 0.0;
    else if (g[i] < 0.0)
      bi = (x0[i] - ub[i]) / g[i];
    else if (g[i] > 0.0)
      bi = (x0[i] - lb[i]) / g[i];
    else
      bi = inf;
    brk[i] = bi;
    vecd[i] = (bi == 0.0) ? 0.0 : -g[i];
  });
  fv.n = X::compact(n, [&](int i) { return brk[i] == inf; },
                    [&](int k, int i) { fv[k] = i; });
  ord.n = X::compact(n, [&](int i) { return brk[i] != inf && brk[i] != 0.0; },
                     [&](int k, int i) { ord[k] = i; });
  if (X::leader()) stable_sort_by(ord.p, ord.size(), brk, ar);
  X::sync();

  const int nord = ord.size();
  const int nfree = fv.size();
  if (nfree < 1 && nord < 1) return;

  const int m2 = 2 * bfgs.m;
  DVec vecp(ar, m2), cache(ar, m2), wact(ar, m2);
  bfgs.apply_wtv(vecd, vecp);
  double fp = -dot<X>(vecd, vecd, n);
  double fpp;
  if (bfgs.ncorr >= 1) {
    bfgs.apply_mv(vecp, cache);
    fpp = -bfgs.theta * fp - inner(vecp.data(), cache.data(), vecp.size());
  } else {
    fpp = -bfgs.theta * fp;
  }
  double deltatmin = -fp / fpp;
  double il = 0.0;
  int b = 0;
  double iu = (nord < 1) ? inf : brk[ord[b]];
  double deltat = iu - il;

  bool crossed_all = false;
  while (deltatmin >= deltat) {
    X::each(vecc.size(), [&](int j) { vecc[j] += deltat * vecp[j]; });
    const int act_begin = b;
    int i = b;
    while (i < nord && brk[ord[i]] <= iu) ++i;
    const int act_end = i - 1;
    if (nfree == 0 && act_end == nord - 1) {
      X::each(act_end - act_begin + 1, [&](int t) {
        const int act = ord[act_begin + t];
        xcp[act] = (vecd[act] > 0.0) ? ub[act] : lb[act];
        newact[newact.n + t] = act;
      });
      newact.n += act_end - act_begin + 1;
      crossed_all = true;
      break;
    }
    fp += deltat * fpp;
    for (int k = act_begin; k <= act_end; ++k) {
      const int act = ord[k];
      const double xact = (vecd[act] > 0.0) ? ub[act] : lb[act];
      X::put(xcp + act, xact);
      const double zact = xact - x0[act];
      const double gact = g[act];
      const double ggact = gact * gact;
      bfgs.wb(act, wact);
      bfgs.apply_mv(wact, cache);
      const double cd_c = inner(cache.data(), vecc.data(), cache.size());
      const double cd_p = inner(cache.data(), vecp.data(), cache.size());
      const double cd_w = inner(cache.data(), wact.data(), cache.size());
      fp += ggact + bfgs.theta * gact * zact - gact * cd_c;
      fpp -= bfgs.theta * ggact + 2.0 * gact * cd_p + ggact * cd_w;
      X::sync();  // every lane has read vecp before it changes
      X::each(vecp.size(), [&](int j) { vecp[j] += gact * wact[j]; });
      X::put(vecd + act, 0.0);
      newact.push_back<X>(act);
    }
    deltatmin = -fp / fpp;
    il = iu;
    b = act_end + 1;
    if (b >= nord) break;
    iu = brk[ord[b]];
    deltat = iu - il;
  }

  const double eps = kEps;
  if (fpp < eps) deltatmin = -fp / eps;
  if (!crossed_all) {
    deltatmin = dmax(deltatmin, 0.0);
    X::each(vecc.size(), [&](int j) { vecc[j] += deltatmin * vecp[j]; });
    const double tfinal = il + deltatmin;
    X::each(nord - b + nfree, [&](int t) {
      const int coord = t < nfree ? fv[t] : ord[b + t - nfree];
      xcp[coord] = x0[coord] + tfinal * vecd[coord];
      if (t >= nfree) fv[t] = coord;
    });
    fv.n = nfree + nord - b;
  }
}

// BOXCQP subspace minimization (SubspaceMin.h:122-302 semantics).
template <class X>
LBFGSPP_HD inline void subspace_minimize(const BHist<X>& bfgs,
                                         const double* x0, const double* xcp,
                                         const double* g, const double* lb,
                                         const double* ub, const IVec& newact,
                                         const IVec& fv, int maxit,
                                         double* drt) {
  const int n = bfgs.n;
  const double eps = kEps;
  Arena& ar = *bfgs.ar;
  X::each(n, [&](int i) { drt[i] = xcp[i] - x0[i]; });
  const int nfree = fv.size();
  if (nfree < 1) return;

  Mark mark(ar);
  DVec vecc(ar, nfree);
  bfgs.compute_ftbab(fv, newact, drt, vecc);
  DVec vecl(ar, nfree), vecu(ar, nfree), negc(ar, nfree);
  vecl.n = vecu.n = negc.n = nfree;
  X::each(nfree, [&](int i) {
    const int coord = fv[i];
    vecl[i] = lb[coord] - x0[coord];
    vecu[i] = ub[coord] - x0[coord];
    vecc[i] += g[coord];
    negc[i] = -vecc[i];
  });
  DVec vecy(ar, nfree);
  bfgs.solve_ptbp(fv, negc, vecy);

  const bool feasible = !X::any(nfree, [&](int i) {
    return vecy[i] < vecl[i] || vecy[i] > vecu[i];
  });
  if (feasible) {
    X::each(nfree, [&](int i) { drt[fv[i]] = vecy[i]; });
    return;
  }

  DVec yfb(ar, nfree), lam(ar, nfree), mu(ar, nfree);
  yfb.n = lam.n = mu.n = nfree;
  X::each(nfree, [&](int i) {
    yfb[i] = vecy[i];
    lam[i] = 0.0;
    mu[i] = 0.0;
  });
  const auto in_l = [&](int i) {
    return vecy[i] < vecl[i] || (vecy[i] == vecl[i] && lam[i] >= 0.0);
  };
  const auto in_u = [&](int i) {
    return !in_l(i) &&
           (vecy[i] > vecu[i] || (vecy[i] == vecu[i] && mu[i] >= 0.0));
  };
  int k = 0;
  for (k = 0; k < maxit; ++k) {
    Mark iteration(ar);
    IVec lset(ar, nfree), uset(ar, nfree), pset(ar, nfree);
    IVec yl(ar, nfree), yu(ar, nfree), yp(ar, nfree);
    lset.n = yl.n = X::compact(nfree, in_l, [&](int t, int i) {
      lset[t] = fv[i];
      yl[t] = i;
    });
    uset.n = yu.n = X::compact(nfree, in_u, [&](int t, int i) {
      uset[t] = fv[i];
      yu[t] = i;
    });
    pset.n = yp.n = X::compact(
        nfree, [&](int i) { return !in_l(i) && !in_u(i); },
        [&](int t, int i) {
          pset[t] = fv[i];
          yp[t] = i;
        });
    X::each(nfree, [&](int i) {
      if (in_l(i)) {
        vecy[i] = vecl[i];
        mu[i] = 0.0;
      } else if (in_u(i)) {
        vecy[i] = vecu[i];
        lam[i] = 0.0;
      } else {
        lam[i] = 0.0;
        mu[i] = 0.0;
      }
    });
    if (!yp.empty()) {
      DVec rhs(ar, yp.size());
      rhs.n = yp.size();
      X::each(yp.size(), [&](int i) { rhs[i] = vecc[yp[i]]; });
      DVec ll(ar, yl.size()), uu(ar, yu.size()), tmp(ar, yp.size());
      ll.n = yl.size();
      uu.n = yu.size();
      X::each(dmax(yl.size(), yu.size()), [&](int i) {
        if (i < yl.size()) ll[i] = vecl[yl[i]];
        if (i < yu.size()) uu[i] = vecu[yu[i]];
      });
      bfgs.apply_ptbqv(pset, lset, ll, tmp);
      X::each(yp.size(), [&](int i) { rhs[i] += tmp[i]; });
      bfgs.apply_ptbqv(pset, uset, uu, tmp);
      X::each(yp.size(), [&](int i) {
        rhs[i] += tmp[i];
        rhs[i] = -rhs[i];
      });
      bfgs.solve_ptbp(pset, rhs, tmp);
      X::each(yp.size(), [&](int i) { vecy[yp[i]] = tmp[i]; });
    }
    DVec fy(ar, 2 * bfgs.m);
    if (!yl.empty() || !yu.empty()) bfgs.apply_wtpv(fv, vecy.data(), fy);
    if (!yl.empty()) {
      DVec res(ar, lset.size());
      bfgs.apply_ptwmv(lset, fy, -1.0, res);
      X::each(yl.size(), [&](int i) {
        lam[yl[i]] = res[i] + vecc[yl[i]] + bfgs.theta * vecy[yl[i]];
      });
    }
    if (!yu.empty()) {
      DVec res(ar, uset.size());
      bfgs.apply_ptwmv(uset, fy, -1.0, res);
      X::each(yu.size(), [&](int i) {
        mu[yu[i]] = -(res[i] + vecc[yu[i]] + bfgs.theta * vecy[yu[i]]);
      });
    }
    const bool conv =
        !X::any(yl.size(), [&](int i) { return lam[yl[i]] < 0.0; }) &&
        !X::any(yu.size(), [&](int i) { return mu[yu[i]] < 0.0; }) &&
        !X::any(yp.size(), [&](int i) {
          return vecy[yp[i]] < vecl[yp[i]] || vecy[yp[i]] > vecu[yp[i]];
        });
    if (conv) break;
  }
  if (k >= maxit) {
    // 3-level fallback
    X::each(nfree, [&](int i) {
      drt[fv[i]] = dmin(dmax(vecy[i], vecl[i]), vecu[i]);
    });
    if (dot<X>(drt, g, n) <= -eps) return;
    X::each(nfree, [&](int i) {
      drt[fv[i]] = dmin(dmax(yfb[i], vecl[i]), vecu[i]);
    });
    if (dot<X>(drt, g, n) <= -eps) return;
    X::each(nfree, [&](int i) { drt[fv[i]] = yfb[i]; });
    return;
  }
  X::each(nfree, [&](int i) { drt[fv[i]] = vecy[i]; });
}

template <class X>
LBFGSPP_HD inline void force_bounds(double* x, const double* lb,
                                    const double* ub, int n) {
  X::each(n, [&](int i) { x[i] = dmin(dmax(x[i], lb[i]), ub[i]); });
}

template <class X>
LBFGSPP_HD inline double proj_grad_norm(const double* x, const double* g,
                                        const double* lb, const double* ub,
                                        int n) {
  return X::reduce(n, 0.0, [&](int i) {
    const double p = dmin(dmax(x[i] - g[i], lb[i]), ub[i]) - x[i];
    return dabs(p);
  }, Max{});
}

template <class X>
LBFGSPP_HD inline double max_step_size_b(const double* x, const double* d,
                                         const double* lb, const double* ub,
                                         int n) {
  return X::reduce(n, kInf, [&](int i) {
    if (d[i] > 0.0) return (ub[i] - x[i]) / d[i];
    if (d[i] < 0.0) return (lb[i] - x[i]) / d[i];
    return kInf;
  }, Min{});
}

// The More-Thuente search as lbfgsb.cpp reaches it (core.cpp's
// lbfgspp_native_morethuente_c): a Params holding only the search's fields.
template <class X, class F>
LBFGSPP_HD LsResult morethuente_b(const F& f, Arena& ar, int max_linesearch,
                                  double min_step, double ftol, double wolfe,
                                  const double* xp, const double* drt,
                                  double step_max, double step_in,
                                  double fx_in, double* x, double* grad,
                                  double dg_in, int n) {
  Params p{};
  p.max_linesearch = max_linesearch;
  p.min_step = min_step;
  p.max_step = 1e20;
  p.ftol = ftol;
  p.wolfe = wolfe;
  return ls_morethuente<X>(f, ar, p, xp, drt, step_max, step_in, fx_in, x,
                           grad, dg_in, n);
}

// Full L-BFGS-B solve (LBFGSB.h:117-262 semantics) on a workspace of
// native_workspace_b(n, p.m, p.past) bytes.  Returns a Status code (on
// every lane; lane 0 writes the outputs).  X::mark brackets each search
// and, inside the direction that runs from a search's end to the next
// search's begin, the Cauchy point (up to the subspace step's begin) and
// the subspace step.
template <class X, class F>
LBFGSPP_HD int minimize_b(const F& f, int n, double* x, const double* lb,
                          const double* ub, const ParamsB& p, void* ws,
                          double* out_fx, double* out_pgnorm, int* out_niter,
                          int* out_nfev) {
  Arena ar(ws, native_doubles_b(n, p.m, p.past), native_ints_b(n, p.m));
  force_bounds<X>(x, lb, ub, n);
  BHist<X> bfgs(n, p.m, ar);
  double* grad = ar.doubles(n);
  double* xp = ar.doubles(n);
  double* gradp = ar.doubles(n);
  double* drt = ar.doubles(n);
  double* xcp = ar.doubles(n);
  double* vs = ar.doubles(n);
  double* vy = ar.doubles(n);
  DVec vecc(ar, 2 * p.m);
  IVec newact(ar, n), fvset(ar, n);
  const int nring = dmax(p.past, 1);
  double* fx_ring = ar.doubles(nring);
  X::each(nring, [&](int i) { fx_ring[i] = 0.0; });
  const double eps_machine = kEps;

  double fx = f(X{}, x, grad, n);
  int nfev = 1;
  double pg = proj_grad_norm<X>(x, grad, lb, ub, n);
  if (p.past > 0) X::put(fx_ring, fx);

  int k = 1;
  int status = kRunning;
  if (pg <= p.epsilon || pg <= p.epsilon_rel * nrm2<X>(x, n)) {
    status = kConvergedGrad;
  } else {
    cauchy_point(bfgs, x, grad, lb, ub, xcp, vecc, newact, fvset);
    X::each(n, [&](int i) { drt[i] = xcp[i] - x[i]; });
    const double dn = nrm2<X>(drt, n);
    if (dn > 0.0) X::each(n, [&](int i) { drt[i] /= dn; });

    for (;;) {
      copy2<X>(xp, x, gradp, grad, n);
      double dg = dot<X>(grad, drt, n);
      double step_max = max_step_size_b<X>(x, drt, lb, ub, n);
      if (dg >= 0.0 || step_max <= p.min_step) {
        X::each(n, [&](int i) { drt[i] = xcp[i] - x[i]; });
        bfgs.reset(n, p.m);
        dg = dot<X>(grad, drt, n);
        step_max = max_step_size_b<X>(x, drt, lb, ub, n);
      }
      step_max = dmin(p.max_step, step_max);
      double step = dmin(1.0, step_max);

      X::mark(kSearchBegin);
      const LsResult ls = morethuente_b<X>(
          f, ar, p.max_linesearch, p.min_step, p.ftol, p.wolfe, xp, drt,
          step_max, step, fx, x, grad, dg, n);
      X::mark(kSearchEnd);
      nfev += ls.nfev;
      fx = ls.fx;
      if (ls.status != kRunning) {
        status = ls.status;
        break;
      }
      pg = proj_grad_norm<X>(x, grad, lb, ub, n);
      if (pg <= p.epsilon || pg <= p.epsilon_rel * nrm2<X>(x, n)) {
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
      X::each(n, [&](int i) {
        vs[i] = x[i] - xp[i];
        vy[i] = grad[i] - gradp[i];
      });
      if (dot<X>(vs, vy, n) > eps_machine * dot<X>(vy, vy, n))
        bfgs.add(vs, vy);

      force_bounds<X>(x, lb, ub, n);
      X::mark(kCauchyBegin);
      cauchy_point(bfgs, x, grad, lb, ub, xcp, vecc, newact, fvset);
      X::mark(kSubspaceBegin);
      subspace_minimize(bfgs, x, xcp, grad, lb, ub, newact, fvset,
                        p.max_submin, drt);
      X::mark(kSubspaceEnd);
      ++k;
    }
  }

  X::put(out_fx, fx);
  X::put(out_pgnorm, pg);
  X::put(out_niter, k);
  X::put(out_nfev, nfev);
  return ar.exhausted ? kWorkspaceExhausted : status;
}

}  // namespace lbfgspp_native
