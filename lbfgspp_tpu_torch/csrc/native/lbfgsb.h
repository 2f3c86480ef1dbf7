// The native L-BFGS-B core (box constraints), one source for the host and
// the card.
//
// The port's own copy of lbfgspp_tpu/native/lbfgsb.cpp (the B-mode middle
// matrix, the generalized Cauchy point, BOXCQP subspace minimization and
// the solve loop; reference semantics LBFGSB.h, BFGSMat.h, Cauchy.h,
// SubspaceMin.h) under the treatment of core.h: LBFGSPP_HD functions, the
// objective a functor, and every std::vector a slice of the caller's
// workspace.  The temporaries come from core.h's bump allocator (Arena),
// which each function gives back on return (Mark); their peak, derived at
// native_doubles_b, is bounded by n (index sets and their values) and 2m
// (the middle-matrix vectors), so native_workspace_b(n, m, past) bytes
// always suffice.  std::stable_sort
// of the Cauchy break points becomes a stable merge sort, which orders them
// as any stable sort does.
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
//   BHist::refactor             scaled [d, d], e [d], lu_solve's copy [d, d]
//                               2d^2 + d
//   the line search             x_lo, grad_lo                       2n
//   cauchy_point                brk, vecd [n], vecp, cache, wact [d],
//                               apply_mv's pad, out [d]         2n + 5d
//                               ints: ord [n], the sort's merge [n]  2n
//   subspace_minimize           vecc, vecl, vecu, negc, vecy, yfb, lam,
//                               mu [nf]; per BOXCQP iteration rhs, tmp
//                               [|yp|], ll [|yl|], uu [|yu|] (<= 2nf in
//                               all, their index sets partition the free
//                               set) under solve_ptbp's mid [dd, dd], wpv
//                               [dd], lu_solve's copy [dd, dd] (dd = 2c
//                               <= d) or apply_ptbqv's rhs, mv [d] over
//                               apply_mv's 2d; after them fy [d] and
//                               res [<= nf] over apply_ptwmv's 3d;
//                               before them compute_ftbab's ad [nact],
//                               rhs [d] over apply_ptwmv's 3d, beside
//                               vecc [nf]:  at most 10n + 2d^2 + d
//                               ints: lset, uset, pset, yl, yu, yp [nf]
//                                                                   6n
// The largest is the subspace step's (10n + 2d^2 + d >= 2n + 5d, as
// 2d^2 >= 4d for d >= 2), so this is exact for a solve that reaches it,
// and a workspace of native_workspace_b bytes never runs out.
LBFGSPP_HD inline long long native_doubles_b(int n, int m, int past) {
  const long long d = 2LL * m, nn = n;
  return d * nn + m + 2 * d * d + 7 * nn + d + dmax(past, 1) +
         10 * nn + 2 * d * d + d;
}
LBFGSPP_HD inline long long native_ints_b(int n) {
  return 2LL * n + 6LL * n;
}
LBFGSPP_HD inline long long native_workspace_b(int n, int m, int past) {
  return workspace_bytes(native_doubles_b(n, m, past), native_ints_b(n));
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
  LBFGSPP_HD void assign(int k, double v) {
    n = k;
    for (int i = 0; i < k; ++i) p[i] = v;
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
  LBFGSPP_HD void push_back(int v) { p[n++] = v; }
};

LBFGSPP_HD inline double vdot(const double* a, const double* b, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) s += a[i] * b[i];
  return s;
}

LBFGSPP_HD inline double vnrm2(const double* a, int n) {
  return dsqrt(vdot(a, a, n));
}

// std::inner_product(a, a + n, b, 0.0).
LBFGSPP_HD inline double inner(const double* a, const double* b, int n) {
  double init = 0.0;
  for (int i = 0; i < n; ++i) init = init + a[i] * b[i];
  return init;
}

// Dense LU solve with partial pivoting for the small middle systems
// (2m x 2m); `a_in` is copied (lbfgsb.cpp takes it by value) and b solved
// in place.
LBFGSPP_HD inline bool lu_solve(const double* a_in, double* b, int n,
                                Arena& ar) {
  Mark mark(ar);
  double* a = ar.doubles(static_cast<long long>(n) * n);
  copy_n(a, a_in, n * n);
  for (int k = 0; k < n; ++k) {
    int p = k;
    for (int i = k + 1; i < n; ++i)
      if (dabs(a[i * n + k]) > dabs(a[p * n + k])) p = i;
    if (a[p * n + k] == 0.0) return false;
    if (p != k) {
      for (int j = 0; j < n; ++j) {
        const double t = a[k * n + j];
        a[k * n + j] = a[p * n + j];
        a[p * n + j] = t;
      }
      const double t = b[k];
      b[k] = b[p];
      b[p] = t;
    }
    for (int i = k + 1; i < n; ++i) {
      const double f = a[i * n + k] / a[k * n + k];
      a[i * n + k] = f;
      for (int j = k + 1; j < n; ++j) a[i * n + j] -= f * a[k * n + j];
      b[i] -= f * b[k];
    }
  }
  for (int i = n - 1; i >= 0; --i) {
    for (int j = i + 1; j < n; ++j) b[i] -= a[i * n + j] * b[j];
    b[i] /= a[i * n + i];
  }
  return true;
}

// B-mode history: ring buffer + 2m x 2m middle matrix (BFGSMat.h:99-146),
// slot-indexed with identity padding exactly like the JAX design.
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
    for (long long i = 0; i < static_cast<long long>(n) * m; ++i) {
      s[i] = 0.0;
      y[i] = 0.0;
    }
    for (int i = 0; i < m; ++i) ys[i] = 0.0;
    for (int i = 0; i < 4 * m * m; ++i) minv[i] = 0.0;
    for (int i = 0; i < 2 * m; ++i) minv[i * 2 * m + i] = 1.0;
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

  LBFGSPP_HD void refactor() {
    // mdense = inv(minv with SS block scaled by theta), column by column.
    const int d = 2 * m;
    Mark mark(*ar);
    double* scaled = ar->doubles(static_cast<long long>(d) * d);
    copy_n(scaled, minv, d * d);
    for (int i = m; i < d; ++i)
      for (int j = m; j < d; ++j) scaled[i * d + j] *= theta;
    for (int i = 0; i < d * d; ++i) mdense[i] = 0.0;
    double* e = ar->doubles(d);
    for (int c = 0; c < d; ++c) {
      for (int r = 0; r < d; ++r) e[r] = 0.0;
      e[c] = 1.0;
      lu_solve(scaled, e, d, *ar);
      for (int r = 0; r < d; ++r) mdense[r * d + c] = e[r];
    }
  }

  LBFGSPP_HD void add(const double* sv, const double* yv) {
    const int loc = ptr % m;
    copy_n(srow(loc), sv, n);
    copy_n(yrow(loc), yv, n);
    const double d = vdot(sv, yv, n);
    ys[loc] = d;
    theta = vdot(yv, yv, n) / d;
    if (ncorr < m) ++ncorr;
    ptr = loc + 1;

    const int dd = 2 * m;
    minv[loc * dd + loc] = -d;
    // S'S row/col (valid slots)
    for (int j = 0; j < ncorr; ++j) {
      const double v = vdot(srow(j), sv, n);
      minv[(m + loc) * dd + (m + j)] = v;
      minv[(m + j) * dd + (m + loc)] = v;
    }
    // Stale y column when the buffer is full
    if (ncorr >= m) {
      for (int i = 0; i < m; ++i) {
        minv[(m + i) * dd + loc] = 0.0;
        minv[loc * dd + (m + i)] = 0.0;
      }
    }
    // L row for the new s: ring distance 1..ncorr-1
    int yloc = (loc + m - 1) % m;
    for (int i = 0; i < ncorr - 1; ++i) {
      const double v = vdot(sv, yrow(yloc), n);
      minv[(m + loc) * dd + yloc] = v;
      minv[yloc * dd + (m + loc)] = v;
      yloc = (yloc + m - 1) % m;
    }
    refactor();
  }

  // W'v with W = [Y, theta*S]; compact [2*ncorr] (slot order; slots fill
  // sequentially so compact == slot prefix).
  LBFGSPP_HD void apply_wtv(const double* v, DVec& res) const {
    res.assign(2 * ncorr, 0.0);
    for (int j = 0; j < ncorr; ++j) {
      res[j] = vdot(yrow(j), v, n);
      res[ncorr + j] = theta * vdot(srow(j), v, n);
    }
  }

  // M v on a compact [2*ncorr] vector via the padded dense inverse.
  LBFGSPP_HD void apply_mv(const DVec& v, DVec& res) const {
    const int d = 2 * m;
    Mark mark(*ar);
    DVec pad(*ar, d);
    pad.assign(d, 0.0);
    for (int j = 0; j < ncorr; ++j) {
      pad[j] = v[j];
      pad[m + j] = v[ncorr + j];
    }
    DVec out(*ar, d);
    out.assign(d, 0.0);
    for (int r = 0; r < d; ++r)
      out[r] = inner(pad.data(), mdense + static_cast<long long>(r) * d, d);
    res.assign(2 * ncorr, 0.0);
    for (int j = 0; j < ncorr; ++j) {
      res[j] = out[j];
      res[ncorr + j] = out[m + j];
    }
  }

  // Row b of W (compact)
  LBFGSPP_HD void wb(int b, DVec& res) const {
    res.assign(2 * ncorr, 0.0);
    for (int j = 0; j < ncorr; ++j) {
      res[j] = yrow(j)[b];
      res[ncorr + j] = theta * srow(j)[b];
    }
  }

  LBFGSPP_HD void apply_wtpv(const IVec& pset, const double* v,
                             DVec& res) const {
    res.assign(2 * ncorr, 0.0);
    for (int j = 0; j < ncorr; ++j) {
      double ry = 0.0, rs = 0.0;
      const double* yp = yrow(j);
      const double* sp = srow(j);
      for (int i = 0; i < pset.size(); ++i) {
        ry += yp[pset[i]] * v[i];
        rs += sp[pset[i]] * v[i];
      }
      res[j] = ry;
      res[ncorr + j] = theta * rs;
    }
  }

  LBFGSPP_HD void apply_ptwmv(const IVec& pset, const DVec& v, double scale,
                              DVec& res) const {
    res.assign(pset.size(), 0.0);
    if (ncorr < 1 || pset.empty()) return;
    Mark mark(*ar);
    DVec mv(*ar, 2 * m);
    apply_mv(v, mv);
    for (int j = 0; j < ncorr; ++j) mv[ncorr + j] *= theta;
    for (int j = 0; j < ncorr; ++j) {
      const double* yp = yrow(j);
      const double* sp = srow(j);
      for (int i = 0; i < pset.size(); ++i)
        res[i] += mv[j] * yp[pset[i]] + mv[ncorr + j] * sp[pset[i]];
    }
    for (int i = 0; i < res.size(); ++i) res[i] *= scale;
  }

  LBFGSPP_HD void compute_ftbab(const IVec& fv, const IVec& act,
                                const double* drt, DVec& res) const {
    res.assign(fv.size(), 0.0);
    if (ncorr < 1 || act.empty() || fv.empty()) return;
    Mark mark(*ar);
    DVec ad(*ar, act.size());
    ad.assign(act.size(), 0.0);
    for (int i = 0; i < act.size(); ++i) ad[i] = drt[act[i]];
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
    res.assign(np, 0.0);
    if (np == 0) return;
    if (ncorr < 1) {
      for (int i = 0; i < np; ++i) res[i] = v[i] / theta;
      return;
    }
    const int c = ncorr, dd = 2 * c, mm = m;
    Mark mark(*ar);
    // WP rows: wy[j][i] = y_j[p_i], ws[j][i] = s_j[p_i] (raw, no theta)
    DVec mid(*ar, dd * dd);
    mid.assign(dd * dd, 0.0);
    for (int j = 0; j < c; ++j)
      for (int k = 0; k < c; ++k) {
        mid[j * dd + k] = minv[j * 2 * mm + k] - gram(pset, true, j, true, k) /
            theta;
        mid[(c + j) * dd + k] =
            minv[(mm + j) * 2 * mm + k] - gram(pset, false, j, true, k);
        mid[j * dd + (c + k)] = mid[(c + k) * dd + j];
        mid[(c + j) * dd + (c + k)] = theta *
            (minv[(mm + j) * 2 * mm + (mm + k)] -
             gram(pset, false, j, false, k));
      }
    // Fix the upper-left/lower-left symmetry: recompute upper-right from
    // lower-left transpose after both are filled.
    for (int j = 0; j < c; ++j)
      for (int k = 0; k < c; ++k)
        mid[j * dd + (c + k)] = mid[(c + k) * dd + j];

    DVec wpv(*ar, dd);
    wpv.assign(dd, 0.0);
    for (int j = 0; j < c; ++j) {
      double ry = 0.0, rs = 0.0;
      const double* yp = yrow(j);
      const double* sp = srow(j);
      for (int i = 0; i < np; ++i) {
        ry += yp[pset[i]] * v[i];
        rs += sp[pset[i]] * v[i];
      }
      wpv[j] = ry;
      wpv[c + j] = theta * rs;
    }
    lu_solve(mid.data(), wpv.data(), dd, *ar);
    for (int j = 0; j < c; ++j) wpv[c + j] *= theta;
    for (int i = 0; i < np; ++i) {
      double acc = v[i] / theta;
      for (int j = 0; j < c; ++j)
        acc += (yrow(j)[pset[i]] * wpv[j] + srow(j)[pset[i]] * wpv[c + j]) /
            (theta * theta);
      res[i] = acc;
    }
  }

  LBFGSPP_HD void apply_ptbqv(const IVec& pset, const IVec& qset,
                              const DVec& v, DVec& res) const {
    res.assign(pset.size(), 0.0);
    if (ncorr < 1 || pset.empty() || qset.empty()) return;
    Mark mark(*ar);
    DVec rhs(*ar, 2 * m);
    apply_wtpv(qset, v.data(), rhs);
    DVec mv(*ar, 2 * m);
    apply_mv(rhs, mv);
    for (int j = 0; j < ncorr; ++j) mv[ncorr + j] *= theta;
    for (int j = 0; j < ncorr; ++j) {
      const double* yp = yrow(j);
      const double* sp = srow(j);
      for (int i = 0; i < pset.size(); ++i)
        res[i] -= mv[j] * yp[pset[i]] + mv[ncorr + j] * sp[pset[i]];
    }
  }
};

// Stable ascending sort of ord[0, k) by key[ord[i]]: a bottom-up merge
// that takes from the left run on ties, so it orders as std::stable_sort.
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
  if (src != ord) copy_n(ord, src, k);
}

// Generalized Cauchy point (Cauchy.h:86-284 semantics).
LBFGSPP_HD inline void cauchy_point(const BHist& bfgs, const double* x0,
                                    const double* g, const double* lb,
                                    const double* ub, double* xcp,
                                    DVec& vecc, IVec& newact, IVec& fv) {
  const int n = bfgs.n;
  const double inf = kInf;
  Arena& ar = *bfgs.ar;
  copy_n(xcp, x0, n);
  vecc.assign(2 * bfgs.ncorr, 0.0);
  newact.clear();
  fv.clear();

  Mark mark(ar);
  double* brk = ar.doubles(n);
  double* vecd = ar.doubles(n);
  IVec ord(ar, n);
  for (int i = 0; i < n; ++i) {
    if (lb[i] == ub[i])
      brk[i] = 0.0;
    else if (g[i] < 0.0)
      brk[i] = (x0[i] - ub[i]) / g[i];
    else if (g[i] > 0.0)
      brk[i] = (x0[i] - lb[i]) / g[i];
    else
      brk[i] = inf;
    const bool iszero = brk[i] == 0.0;
    vecd[i] = iszero ? 0.0 : -g[i];
    if (brk[i] == inf)
      fv.push_back(i);
    else if (!iszero)
      ord.push_back(i);
  }
  stable_sort_by(ord.p, ord.size(), brk, ar);

  const int nord = ord.size();
  const int nfree = fv.size();
  if (nfree < 1 && nord < 1) return;

  const int m2 = 2 * bfgs.m;
  DVec vecp(ar, m2), cache(ar, m2), wact(ar, m2);
  bfgs.apply_wtv(vecd, vecp);
  double fp = -vdot(vecd, vecd, n);
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
    for (int j = 0; j < vecc.size(); ++j) vecc[j] += deltat * vecp[j];
    const int act_begin = b;
    int i = b;
    while (i < nord && brk[ord[i]] <= iu) ++i;
    const int act_end = i - 1;
    if (nfree == 0 && act_end == nord - 1) {
      for (int k = act_begin; k <= act_end; ++k) {
        const int act = ord[k];
        xcp[act] = (vecd[act] > 0.0) ? ub[act] : lb[act];
        newact.push_back(act);
      }
      crossed_all = true;
      break;
    }
    fp += deltat * fpp;
    for (int k = act_begin; k <= act_end; ++k) {
      const int act = ord[k];
      xcp[act] = (vecd[act] > 0.0) ? ub[act] : lb[act];
      const double zact = xcp[act] - x0[act];
      const double gact = g[act];
      const double ggact = gact * gact;
      bfgs.wb(act, wact);
      bfgs.apply_mv(wact, cache);
      const double cd_c = inner(cache.data(), vecc.data(), cache.size());
      const double cd_p = inner(cache.data(), vecp.data(), cache.size());
      const double cd_w = inner(cache.data(), wact.data(), cache.size());
      fp += ggact + bfgs.theta * gact * zact - gact * cd_c;
      fpp -= bfgs.theta * ggact + 2.0 * gact * cd_p + ggact * cd_w;
      for (int j = 0; j < vecp.size(); ++j) vecp[j] += gact * wact[j];
      vecd[act] = 0.0;
      newact.push_back(act);
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
    for (int j = 0; j < vecc.size(); ++j) vecc[j] += deltatmin * vecp[j];
    const double tfinal = il + deltatmin;
    for (int i = 0; i < nfree; ++i) {
      const int coord = fv[i];
      xcp[coord] = x0[coord] + tfinal * vecd[coord];
    }
    for (int i = b; i < nord; ++i) {
      const int coord = ord[i];
      xcp[coord] = x0[coord] + tfinal * vecd[coord];
      fv.push_back(coord);
    }
  }
}

// BOXCQP subspace minimization (SubspaceMin.h:122-302 semantics).
LBFGSPP_HD inline void subspace_minimize(const BHist& bfgs, const double* x0,
                                         const double* xcp, const double* g,
                                         const double* lb, const double* ub,
                                         const IVec& newact, const IVec& fv,
                                         int maxit, double* drt) {
  const int n = bfgs.n;
  const double eps = kEps;
  Arena& ar = *bfgs.ar;
  for (int i = 0; i < n; ++i) drt[i] = xcp[i] - x0[i];
  const int nfree = fv.size();
  if (nfree < 1) return;

  Mark mark(ar);
  DVec vecc(ar, nfree);
  bfgs.compute_ftbab(fv, newact, drt, vecc);
  DVec vecl(ar, nfree), vecu(ar, nfree);
  vecl.assign(nfree, 0.0);
  vecu.assign(nfree, 0.0);
  for (int i = 0; i < nfree; ++i) {
    const int coord = fv[i];
    vecl[i] = lb[coord] - x0[coord];
    vecu[i] = ub[coord] - x0[coord];
    vecc[i] += g[coord];
  }
  DVec negc(ar, nfree);
  negc.assign(nfree, 0.0);
  for (int i = 0; i < nfree; ++i) negc[i] = -vecc[i];
  DVec vecy(ar, nfree);
  bfgs.solve_ptbp(fv, negc, vecy);

  bool feasible = true;
  for (int i = 0; i < nfree; ++i)
    if (vecy[i] < vecl[i] || vecy[i] > vecu[i]) {
      feasible = false;
      break;
    }
  if (feasible) {
    for (int i = 0; i < nfree; ++i) drt[fv[i]] = vecy[i];
    return;
  }

  DVec yfb(ar, nfree);
  yfb.assign(nfree, 0.0);
  copy_n(yfb.data(), vecy.data(), nfree);
  DVec lam(ar, nfree), mu(ar, nfree);
  lam.assign(nfree, 0.0);
  mu.assign(nfree, 0.0);
  int k = 0;
  for (k = 0; k < maxit; ++k) {
    Mark iteration(ar);
    IVec lset(ar, nfree), uset(ar, nfree), pset(ar, nfree);
    IVec yl(ar, nfree), yu(ar, nfree), yp(ar, nfree);
    for (int i = 0; i < nfree; ++i) {
      const int coord = fv[i];
      const double li = vecl[i], ui = vecu[i];
      if (vecy[i] < li || (vecy[i] == li && lam[i] >= 0.0)) {
        lset.push_back(coord);
        yl.push_back(i);
        vecy[i] = li;
        mu[i] = 0.0;
      } else if (vecy[i] > ui || (vecy[i] == ui && mu[i] >= 0.0)) {
        uset.push_back(coord);
        yu.push_back(i);
        vecy[i] = ui;
        lam[i] = 0.0;
      } else {
        pset.push_back(coord);
        yp.push_back(i);
        lam[i] = 0.0;
        mu[i] = 0.0;
      }
    }
    if (!yp.empty()) {
      DVec rhs(ar, yp.size());
      rhs.assign(yp.size(), 0.0);
      for (int i = 0; i < yp.size(); ++i) rhs[i] = vecc[yp[i]];
      DVec ll(ar, yl.size()), uu(ar, yu.size()), tmp(ar, yp.size());
      ll.assign(yl.size(), 0.0);
      uu.assign(yu.size(), 0.0);
      for (int i = 0; i < yl.size(); ++i) ll[i] = vecl[yl[i]];
      for (int i = 0; i < yu.size(); ++i) uu[i] = vecu[yu[i]];
      bfgs.apply_ptbqv(pset, lset, ll, tmp);
      for (int i = 0; i < yp.size(); ++i) rhs[i] += tmp[i];
      bfgs.apply_ptbqv(pset, uset, uu, tmp);
      for (int i = 0; i < yp.size(); ++i) rhs[i] += tmp[i];
      for (int i = 0; i < rhs.size(); ++i) rhs[i] = -rhs[i];
      bfgs.solve_ptbp(pset, rhs, tmp);
      for (int i = 0; i < yp.size(); ++i) vecy[yp[i]] = tmp[i];
    }
    DVec fy(ar, 2 * bfgs.m);
    if (!yl.empty() || !yu.empty()) bfgs.apply_wtpv(fv, vecy.data(), fy);
    if (!yl.empty()) {
      DVec res(ar, lset.size());
      bfgs.apply_ptwmv(lset, fy, -1.0, res);
      for (int i = 0; i < yl.size(); ++i)
        lam[yl[i]] = res[i] + vecc[yl[i]] + bfgs.theta * vecy[yl[i]];
    }
    if (!yu.empty()) {
      DVec res(ar, uset.size());
      bfgs.apply_ptwmv(uset, fy, -1.0, res);
      for (int i = 0; i < yu.size(); ++i)
        mu[yu[i]] = -(res[i] + vecc[yu[i]] + bfgs.theta * vecy[yu[i]]);
    }
    bool conv = true;
    for (int i = 0; i < yl.size() && conv; ++i)
      if (lam[yl[i]] < 0.0) conv = false;
    for (int i = 0; i < yu.size() && conv; ++i)
      if (mu[yu[i]] < 0.0) conv = false;
    for (int i = 0; i < yp.size() && conv; ++i)
      if (vecy[yp[i]] < vecl[yp[i]] || vecy[yp[i]] > vecu[yp[i]])
        conv = false;
    if (conv) break;
  }
  if (k >= maxit) {
    // 3-level fallback
    for (int i = 0; i < nfree; ++i)
      drt[fv[i]] = dmin(dmax(vecy[i], vecl[i]), vecu[i]);
    if (vdot(drt, g, n) <= -eps) return;
    for (int i = 0; i < nfree; ++i)
      drt[fv[i]] = dmin(dmax(yfb[i], vecl[i]), vecu[i]);
    if (vdot(drt, g, n) <= -eps) return;
    for (int i = 0; i < nfree; ++i) drt[fv[i]] = yfb[i];
    return;
  }
  for (int i = 0; i < nfree; ++i) drt[fv[i]] = vecy[i];
}

LBFGSPP_HD inline void force_bounds(double* x, const double* lb,
                                    const double* ub, int n) {
  for (int i = 0; i < n; ++i) x[i] = dmin(dmax(x[i], lb[i]), ub[i]);
}

LBFGSPP_HD inline double proj_grad_norm(const double* x, const double* g,
                                        const double* lb, const double* ub,
                                        int n) {
  double r = 0.0;
  for (int i = 0; i < n; ++i) {
    const double p = dmin(dmax(x[i] - g[i], lb[i]), ub[i]) - x[i];
    r = dmax(r, dabs(p));
  }
  return r;
}

LBFGSPP_HD inline double max_step_size_b(const double* x, const double* d,
                                         const double* lb, const double* ub,
                                         int n) {
  double step = kInf;
  for (int i = 0; i < n; ++i) {
    if (d[i] > 0.0)
      step = dmin(step, (ub[i] - x[i]) / d[i]);
    else if (d[i] < 0.0)
      step = dmin(step, (lb[i] - x[i]) / d[i]);
  }
  return step;
}

// The More-Thuente search as lbfgsb.cpp reaches it (core.cpp's
// lbfgspp_native_morethuente_c): a Params holding only the search's fields.
template <class F>
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
  return ls_morethuente(f, ar, p, xp, drt, step_max, step_in, fx_in, x, grad,
                        dg_in, n);
}

// Full L-BFGS-B solve (LBFGSB.h:117-262 semantics) on a workspace of
// native_workspace_b(n, p.m, p.past) bytes.  Returns a Status code.
template <class F>
LBFGSPP_HD int minimize_b(const F& f, int n, double* x, const double* lb,
                          const double* ub, const ParamsB& p, void* ws,
                          double* out_fx, double* out_pgnorm, int* out_niter,
                          int* out_nfev) {
  Arena ar(ws, native_doubles_b(n, p.m, p.past), native_ints_b(n));
  force_bounds(x, lb, ub, n);
  BHist bfgs(n, p.m, ar);
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
  for (int i = 0; i < nring; ++i) fx_ring[i] = 0.0;
  const double eps_machine = kEps;

  double fx = f(x, grad, n);
  int nfev = 1;
  double pg = proj_grad_norm(x, grad, lb, ub, n);
  if (p.past > 0) fx_ring[0] = fx;

  int k = 1;
  int status = kRunning;
  if (pg <= p.epsilon || pg <= p.epsilon_rel * vnrm2(x, n)) {
    status = kConvergedGrad;
  } else {
    cauchy_point(bfgs, x, grad, lb, ub, xcp, vecc, newact, fvset);
    for (int i = 0; i < n; ++i) drt[i] = xcp[i] - x[i];
    const double dn = vnrm2(drt, n);
    if (dn > 0.0)
      for (int i = 0; i < n; ++i) drt[i] /= dn;

    for (;;) {
      copy_n(xp, x, n);
      copy_n(gradp, grad, n);
      double dg = vdot(grad, drt, n);
      double step_max = max_step_size_b(x, drt, lb, ub, n);
      if (dg >= 0.0 || step_max <= p.min_step) {
        for (int i = 0; i < n; ++i) drt[i] = xcp[i] - x[i];
        bfgs.reset(n, p.m);
        dg = vdot(grad, drt, n);
        step_max = max_step_size_b(x, drt, lb, ub, n);
      }
      step_max = dmin(p.max_step, step_max);
      double step = dmin(1.0, step_max);

      const LsResult ls = morethuente_b(
          f, ar, p.max_linesearch, p.min_step, p.ftol, p.wolfe, xp, drt,
          step_max, step, fx, x, grad, dg, n);
      nfev += ls.nfev;
      fx = ls.fx;
      if (ls.status != kRunning) {
        status = ls.status;
        break;
      }
      pg = proj_grad_norm(x, grad, lb, ub, n);
      if (pg <= p.epsilon || pg <= p.epsilon_rel * vnrm2(x, n)) {
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
        fx_ring[k % p.past] = fx;
      }
      if (p.max_iterations != 0 && k >= p.max_iterations) {
        status = kMaxIterations;
        break;
      }
      for (int i = 0; i < n; ++i) {
        vs[i] = x[i] - xp[i];
        vy[i] = grad[i] - gradp[i];
      }
      if (vdot(vs, vy, n) > eps_machine * vdot(vy, vy, n)) bfgs.add(vs, vy);

      force_bounds(x, lb, ub, n);
      cauchy_point(bfgs, x, grad, lb, ub, xcp, vecc, newact, fvset);
      subspace_minimize(bfgs, x, xcp, grad, lb, ub, newact, fvset,
                        p.max_submin, drt);
      ++k;
    }
  }

  *out_fx = fx;
  *out_pgnorm = pg;
  *out_niter = k;
  *out_nfev = nfev;
  return ar.exhausted ? kWorkspaceExhausted : status;
}

}  // namespace lbfgspp_native
