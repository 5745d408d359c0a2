// Native arbitrary-precision TT-cross engine on GNU MPFR.
//
// ttcross_tpu_torch's own copy of ttcross_tpu/native/src/mpfr_cross.cpp,
// built with g++ by ttcross_tpu_torch/native/_mpfr.py.  Host code, like
// the whole mp tier: no device is involved.
//
// The reference's 120-digit tier is COMPILED code: MPFUN-MPFR Fortran over
// C shims onto libmpfr (mpfun-mpfr-v08/mpfung1.f90:55-575, mpinterface.c:
// 4-85), driven by the mp mirror engine mptt_dmrgg (dmrggmp.f90:11-704).
// This file plays the same role for ttcross-tpu: the host-precision cross
// engine (the algorithm of cross/engine_mp.py::MpEngine, itself the
// mptt_dmrgg analogue) implemented directly over MPFR so the >=100-digit
// tier runs at compiled speed instead of pure-Python mpmath
// (cross/engine_mp.py stays as the reference implementation and the
// arbitrary-integrand fallback).
//
// The image ships libmpfr.so.6 / libgmp.so.10 but no mpfr.h, so the
// minimal required ABI is declared here (the MPFR 4.x C ABI on LP64
// x86-64 — stable across 4.x; verified at runtime by a self-test that
// computes known digits, see mp_selftest()).
//
// Entry points (ctypes, see ttcross_tpu_torch/native/_mpfr.py):
//   mp_selftest()        -- ABI sanity: digits of exp(1) at 120 dps
//   mp_ising_cross(...)  -- built-in Ising C/D/E integrand, all native
//   mp_cross_cb(...)     -- engine native, integrand via Python callback
//                           (decimal strings across the boundary)

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <vector>

// ----------------------------------------------------------- MPFR ABI
extern "C" {
typedef long mpfr_prec_t;
typedef int mpfr_sign_t;
typedef long mpfr_exp_t;
typedef unsigned long mp_limb_t;
typedef struct {
  mpfr_prec_t _mpfr_prec;
  mpfr_sign_t _mpfr_sign;
  mpfr_exp_t _mpfr_exp;
  mp_limb_t *_mpfr_d;
} __mpfr_struct;
typedef __mpfr_struct mpfr_t[1];
typedef __mpfr_struct *mpfr_ptr;
typedef const __mpfr_struct *mpfr_srcptr;
typedef int mpfr_rnd_t;
static const mpfr_rnd_t RNDN = 0;

void mpfr_init2(mpfr_ptr, mpfr_prec_t);
void mpfr_clear(mpfr_ptr);
int mpfr_set(mpfr_ptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_set_si(mpfr_ptr, long, mpfr_rnd_t);
int mpfr_set_d(mpfr_ptr, double, mpfr_rnd_t);
int mpfr_set_str(mpfr_ptr, const char *, int, mpfr_rnd_t);
int mpfr_add(mpfr_ptr, mpfr_srcptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_sub(mpfr_ptr, mpfr_srcptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_mul(mpfr_ptr, mpfr_srcptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_div(mpfr_ptr, mpfr_srcptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_fma(mpfr_ptr, mpfr_srcptr, mpfr_srcptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_neg(mpfr_ptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_abs(mpfr_ptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_mul_si(mpfr_ptr, mpfr_srcptr, long, mpfr_rnd_t);
int mpfr_div_si(mpfr_ptr, mpfr_srcptr, long, mpfr_rnd_t);
int mpfr_si_div(mpfr_ptr, long, mpfr_srcptr, mpfr_rnd_t);
int mpfr_exp(mpfr_ptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_cos(mpfr_ptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_const_pi(mpfr_ptr, mpfr_rnd_t);
int mpfr_cmp(mpfr_srcptr, mpfr_srcptr);
int mpfr_cmpabs(mpfr_srcptr, mpfr_srcptr);
int mpfr_cmp_si(mpfr_srcptr, long);
int mpfr_zero_p(mpfr_srcptr);
double mpfr_get_d(mpfr_srcptr, mpfr_rnd_t);
mpfr_exp_t mpfr_get_exp(mpfr_srcptr);
char *mpfr_get_str(char *, mpfr_exp_t *, int, size_t, mpfr_srcptr,
                   mpfr_rnd_t);
void mpfr_free_str(char *);
}

// --------------------------------------------------------- RAII wrapper
namespace {

mpfr_prec_t g_prec = 512;

struct Mp {
  mpfr_t v;
  Mp() { mpfr_init2(v, g_prec); mpfr_set_si(v, 0, RNDN); }
  explicit Mp(long x) { mpfr_init2(v, g_prec); mpfr_set_si(v, x, RNDN); }
  Mp(const Mp &o) { mpfr_init2(v, g_prec); mpfr_set(v, o.v, RNDN); }
  Mp &operator=(const Mp &o) {
    if (this != &o) mpfr_set(v, o.v, RNDN);
    return *this;
  }
  ~Mp() { mpfr_clear(v); }
};

inline void add(Mp &r, const Mp &a, const Mp &b) { mpfr_add(r.v, a.v, b.v, RNDN); }
inline void sub(Mp &r, const Mp &a, const Mp &b) { mpfr_sub(r.v, a.v, b.v, RNDN); }
inline void mul(Mp &r, const Mp &a, const Mp &b) { mpfr_mul(r.v, a.v, b.v, RNDN); }
inline void divq(Mp &r, const Mp &a, const Mp &b) { mpfr_div(r.v, a.v, b.v, RNDN); }

// log10 magnitude from the binary exponent (the thresholds live in the
// log10 domain like dmrggmp.f90:50-53; +-0.302 slack is irrelevant there)
inline double mag10(const Mp &x) {
  if (mpfr_zero_p(x.v)) return -1e300;
  return (double)mpfr_get_exp(x.v) * 0.30102999566398119521;
}

// splitmix64: the lottery draw (pivot-path RNG need not match Python's;
// tests assert accuracy envelopes, not bitwise pivot paths)
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed + 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  long below(long n) { return (long)(next() % (uint64_t)n); }
};

// ----------------------------------------------- Gauss-Legendre (mp)
// Newton iteration on the Legendre recurrence (the lgwt construction,
// quad.f90:97-131 re-derived): nodes/weights on [-1, 1].
void gauss_legendre_mp(long n, std::vector<Mp> &x, std::vector<Mp> &w) {
  x.assign(n, Mp());
  w.assign(n, Mp());
  Mp pi, t, p0, p1, p2, dp, dx, num, den, tmp;
  mpfr_const_pi(pi.v, RNDN);
  for (long i = 0; i < (n + 1) / 2; ++i) {
    // x0 = cos(pi (i + 0.75) / (n + 0.5))
    mpfr_set_d(t.v, (double)i + 0.75, RNDN);
    mul(t, t, pi);
    mpfr_set_d(tmp.v, (double)n + 0.5, RNDN);
    divq(t, t, tmp);
    mpfr_cos(t.v, t.v, RNDN);
    for (int it = 0; it < 200; ++it) {
      // P_n(t) by recurrence
      mpfr_set_si(p0.v, 1, RNDN);
      mpfr_set(p1.v, t.v, RNDN);
      for (long k = 2; k <= n; ++k) {
        // p2 = ((2k-1) t p1 - (k-1) p0) / k
        mul(p2, t, p1);
        mpfr_mul_si(p2.v, p2.v, 2 * k - 1, RNDN);
        mpfr_mul_si(tmp.v, p0.v, k - 1, RNDN);
        sub(p2, p2, tmp);
        mpfr_div_si(p2.v, p2.v, k, RNDN);
        p0 = p1;
        p1 = p2;
      }
      // P'_n(t) = n (t P_n - P_{n-1}) / (t^2 - 1)
      mul(num, t, p1);
      sub(num, num, p0);
      mpfr_mul_si(num.v, num.v, n, RNDN);
      mul(den, t, t);
      mpfr_set_si(tmp.v, 1, RNDN);
      sub(den, den, tmp);
      divq(dp, num, den);
      // dx = P_n / P'_n;  t -= dx
      divq(dx, p1, dp);
      sub(t, t, dx);
      if (mpfr_zero_p(dx.v) ||
          (double)mpfr_get_exp(dx.v) < -(double)g_prec - 8)
        break;
    }
    x[i] = t;
    mpfr_neg(x[n - 1 - i].v, t.v, RNDN);
    // w = 2 / ((1 - t^2) P'_n(t)^2); recompute P'_n at the converged t
    mpfr_set_si(p0.v, 1, RNDN);
    mpfr_set(p1.v, t.v, RNDN);
    for (long k = 2; k <= n; ++k) {
      mul(p2, t, p1);
      mpfr_mul_si(p2.v, p2.v, 2 * k - 1, RNDN);
      mpfr_mul_si(tmp.v, p0.v, k - 1, RNDN);
      sub(p2, p2, tmp);
      mpfr_div_si(p2.v, p2.v, k, RNDN);
      p0 = p1;
      p1 = p2;
    }
    mul(num, t, p1);
    sub(num, num, p0);
    mpfr_mul_si(num.v, num.v, n, RNDN);
    mul(den, t, t);
    mpfr_set_si(tmp.v, 1, RNDN);
    sub(den, den, tmp);
    divq(dp, num, den);
    mul(den, t, t);
    mpfr_set_si(tmp.v, 1, RNDN);
    sub(den, tmp, den);        // 1 - t^2
    mul(tmp, dp, dp);
    mul(den, den, tmp);
    mpfr_set_si(num.v, 2, RNDN);
    divq(w[i], num, den);
    w[n - 1 - i] = w[i];
  }
  if (n % 2 == 1) {  // center node is exactly 0
    mpfr_set_si(x[n / 2].v, 0, RNDN);
  }
}

// ------------------------------------------------------- Ising integrand
// dfunc_ising_discr (test_crs_ising.f90:176-218) at mp precision —
// the same formulation as apps/ising.py::make_ising_mp::fun_mp.
struct IsingMp {
  int kid;  // 1 = C (2b), 2 = D (2ab), 3 = E (2a)
  long d, n;
  std::vector<Mp> nodes, weights;  // on [0, 1], weights carry 0.5*val

  void init(char kind, long m, long nn, bool &rescale) {
    kid = kind == 'C' ? 1 : (kind == 'D' ? 2 : 3);
    d = m - 1;
    n = nn % 2 == 0 ? nn + 1 : nn;
    std::vector<Mp> x, w;
    gauss_legendre_mp(n, x, w);
    rescale = (kid != 1) && m >= 10;
    long val = rescale ? 5 * (n / 2) : (n / 2);
    nodes.assign(n, Mp());
    weights.assign(n, Mp());
    Mp one(1), half, tmp;
    mpfr_set_d(half.v, 0.5, RNDN);
    for (long i = 0; i < n; ++i) {
      add(tmp, x[i], one);
      mul(nodes[i], tmp, half);          // (x+1)/2 in [0, 1]
      mul(tmp, w[i], half);
      mpfr_mul_si(weights[i].v, tmp.v, val, RNDN);
    }
    quad_val = val;
  }
  long quad_val = 1;

  // f(ind) for one multi-index (scalar mp loops — compiled, the whole
  // point of this tier)
  void eval(const long *ind, Mp &f, std::vector<Mp> &scratch) const {
    if ((long)scratch.size() < d + 1) scratch.assign(d + 1, Mp());
    Mp tmp, tmp2;
    mpfr_set_si(f.v, 2, RNDN);
    if (kid == 2 || kid == 3) {  // a-term over prefix products
      std::vector<Mp> &P = scratch;
      mpfr_set_si(P[0].v, 1, RNDN);
      for (long s = 0; s < d; ++s) mul(P[s + 1], P[s], nodes[ind[s]]);
      Mp a(1), r;
      for (long i = 0; i <= d; ++i)
        for (long j = i + 1; j <= d; ++j) {
          sub(tmp, P[j], P[i]);
          add(tmp2, P[j], P[i]);
          divq(r, tmp, tmp2);
          mul(a, a, r);
          mul(a, a, r);
        }
      mul(f, f, a);
    }
    if (kid == 1 || kid == 2) {  // b-term: 2 / (v w)
      Mp pre(1), wsum(1), suf(1), vsum(1);
      for (long s = 0; s < d; ++s) {
        mul(pre, pre, nodes[ind[s]]);
        add(wsum, wsum, pre);
      }
      for (long s = d - 1; s >= 0; --s) {
        mul(suf, suf, nodes[ind[s]]);
        add(vsum, vsum, suf);
      }
      mul(tmp, vsum, wsum);
      divq(f, f, tmp);
    }
    for (long s = 0; s < d; ++s) mul(f, f, weights[ind[s]]);
  }
};

// ------------------------------------------------------------ the engine
// Mirror of cross/engine_mp.py::MpEngine (single-process path): ragged
// growth, rook hunts, two-threshold accept in log10, strike-3 stop,
// per-sweep LU-solved value chain.
using Fun = std::function<void(const long *ind, long B, long d, Mp *out)>;

struct MpMat {  // row-major (r0, n, r1) ragged block
  long r0 = 0, n = 0, r1 = 0;
  std::vector<Mp> a;
  void init(long r0_, long n_, long r1_) {
    r0 = r0_; n = n_; r1 = r1_;
    a.assign(r0 * n * r1, Mp());
  }
  Mp &at(long i, long j, long k) { return a[(i * n + j) * r1 + k]; }
};

struct Engine {
  Fun fun;
  long d, max_rank, piv, snum;
  std::vector<long> n;
  double lse, lsp, lacc;
  Rng rng;
  long long neval = 0;
  double log_amax = -1e300, log_pivotmax_prev = 0;

  std::vector<std::vector<std::array<long, 4>>> vip;  // per bond
  std::vector<long> r;          // d+1 bond ranks
  std::vector<MpMat> G;         // d cores (r[c], n[c], r[c+1])
  std::vector<MpMat> Cf, Rf;    // d-1 factors: Cf[b] (r[b], n[b], r[b+1]),
                                // Rf[b] (r[b+1], n[b+1], r[b+2])
  // bordered inverses per bond: itl (s x s) row-major, itt (s x s)
  std::vector<std::vector<Mp>> itl, itt;

  Engine(Fun f, std::vector<long> n_, long R, long piv_, long snum_,
         double lse_, double lsp_, double lacc_, uint64_t seed)
      : fun(std::move(f)), d(n_.size()), max_rank(R), piv(piv_ < 0 ? 0 : piv_),
        snum(snum_), n(std::move(n_)), lse(lse_), lsp(lsp_), lacc(lacc_),
        rng(seed) {}

  void walk_index(long b, long i, long j, long k, long q, long *ind) const {
    long t = i;
    for (long s = b - 1; s >= 0; --s) {
      ind[s] = vip[s][t][1];
      t = vip[s][t][0];
    }
    ind[b] = j;
    ind[b + 1] = k;
    t = q;
    for (long s = b + 1; s < d - 1; ++s) {
      ind[s + 1] = vip[s][t][2];
      t = vip[s][t][3];
    }
  }

  void init_state() {
    long nn = *std::min_element(n.begin(), n.end());
    long B = snum * nn;
    std::vector<long> cand(B * d);
    for (long s = 0; s < snum; ++s)
      for (long k = 0; k < nn; ++k)
        for (long p = 0; p < d; ++p)
          cand[(s * nn + k) * d + p] = (k + s * p) % n[p];
    std::vector<Mp> vals(B);
    fun(cand.data(), B, d, vals.data());
    neval += B;
    long best = 0;
    for (long i = 1; i < B; ++i)
      if (mpfr_cmpabs(vals[i].v, vals[best].v) > 0) best = i;
    log_amax = mag10(vals[best]);
    std::vector<long> ind0(cand.begin() + best * d,
                           cand.begin() + (best + 1) * d);

    vip.assign(d - 1, {});
    for (long b = 0; b < d - 1; ++b)
      vip[b].push_back({0, ind0[b], ind0[b + 1], 0});
    r.assign(d + 1, 1);

    G.resize(d);
    std::vector<long> fib(d);
    for (long c = 0; c < d; ++c) {
      G[c].init(1, n[c], 1);
      std::vector<long> idx(n[c] * d);
      for (long j = 0; j < n[c]; ++j) {
        for (long p = 0; p < d; ++p) idx[j * d + p] = ind0[p];
        idx[j * d + c] = j;
      }
      std::vector<Mp> fv(n[c]);
      fun(idx.data(), n[c], d, fv.data());
      neval += n[c];
      for (long j = 0; j < n[c]; ++j) {
        double m10 = mag10(fv[j]);
        if (m10 > log_amax) log_amax = m10;
        G[c].at(0, j, 0) = fv[j];
      }
    }
    Mp delta = G[0].at(0, ind0[0], 0);
    Cf.resize(d - 1);
    Rf.resize(d - 1);
    for (long b = 0; b < d - 1; ++b) {
      Cf[b].init(1, n[b], 1);
      Rf[b].init(1, n[b + 1], 1);
      for (long j = 0; j < n[b]; ++j)
        divq(Cf[b].at(0, j, 0), G[b].at(0, j, 0), delta);
      for (long j = 0; j < n[b + 1]; ++j)
        Rf[b].at(0, j, 0) = G[b + 1].at(0, j, 0);
    }
    itl.assign(d - 1, {});
    itt.assign(d - 1, {});
    Mp one(1), inv;
    divq(inv, one, delta);
    for (long b = 0; b < d - 1; ++b) {
      itl[b] = {one};
      itt[b] = {inv};
    }
    log_pivotmax_prev = log_amax;
  }

  // raw column fiber (r[b], n[b]) at fixed (kk, qq) -> into out
  void eval_col(long b, long kk, long qq, std::vector<Mp> &out) {
    long B = r[b] * n[b];
    std::vector<long> idx(B * d);
    long t = 0;
    for (long i = 0; i < r[b]; ++i)
      for (long j = 0; j < n[b]; ++j, ++t)
        walk_index(b, i, j, kk, qq, idx.data() + t * d);
    out.assign(B, Mp());
    fun(idx.data(), B, d, out.data());
    neval += B;
  }
  void eval_row(long b, long ii, long jj, std::vector<Mp> &out) {
    long B = n[b + 1] * r[b + 2];
    std::vector<long> idx(B * d);
    long t = 0;
    for (long k = 0; k < n[b + 1]; ++k)
      for (long q = 0; q < r[b + 2]; ++q, ++t)
        walk_index(b, ii, jj, k, q, idx.data() + t * d);
    out.assign(B, Mp());
    fun(idx.data(), B, d, out.data());
    neval += B;
  }

  void track_amax(const std::vector<Mp> &v) {
    for (const Mp &x : v) {
      double m10 = mag10(x);
      if (m10 > log_amax) log_amax = m10;
    }
  }

  // residual of a column fiber: bcol = acol - Cf[b] . Rf[b][:, kk, qq]
  void col_residual(long b, const std::vector<Mp> &acol, long kk, long qq,
                    std::vector<Mp> &bcol) {
    long R1 = r[b + 1];
    bcol = acol;
    Mp t;
    for (long i = 0; i < r[b]; ++i)
      for (long j = 0; j < n[b]; ++j) {
        Mp &o = bcol[i * n[b] + j];
        for (long s = 0; s < R1; ++s) {
          mul(t, Cf[b].at(i, j, s), Rf[b].at(s, kk, qq));
          sub(o, o, t);
        }
      }
  }
  void row_residual(long b, const std::vector<Mp> &arow, long ii, long jj,
                    std::vector<Mp> &brow) {
    long R1 = r[b + 1];
    brow = arow;
    Mp t;
    for (long k = 0; k < n[b + 1]; ++k)
      for (long q = 0; q < r[b + 2]; ++q) {
        Mp &o = brow[k * r[b + 2] + q];
        for (long s = 0; s < R1; ++s) {
          mul(t, Cf[b].at(ii, jj, s), Rf[b].at(s, k, q));
          sub(o, o, t);
        }
      }
  }

  static long argmax_abs(const std::vector<Mp> &v) {
    long best = 0;
    for (long i = 1; i < (long)v.size(); ++i)
      if (mpfr_cmpabs(v[i].v, v[best].v) > 0) best = i;
    return best;
  }

  // one bond visit; returns log10|pivot| if accepted else -inf
  double visit_bond(long b, bool dir_fwd) {
    if (r[b + 1] >= max_rank) return -1e300;
    // allowed candidate sets minus used pivots
    std::vector<std::pair<long, long>> all_c, all_r;
    {
      std::vector<char> used_c(r[b] * n[b], 0), used_r(n[b + 1] * r[b + 2], 0);
      for (auto &pv : vip[b]) {
        if (pv[0] < r[b] && pv[1] < n[b]) used_c[pv[0] * n[b] + pv[1]] = 1;
        if (pv[2] < n[b + 1] && pv[3] < r[b + 2])
          used_r[pv[2] * r[b + 2] + pv[3]] = 1;
      }
      for (long i = 0; i < r[b]; ++i)
        for (long j = 0; j < n[b]; ++j)
          if (!used_c[i * n[b] + j]) all_c.push_back({i, j});
      for (long k = 0; k < n[b + 1]; ++k)
        for (long q = 0; q < r[b + 2]; ++q)
          if (!used_r[k * r[b + 2] + q]) all_r.push_back({k, q});
    }
    if (all_c.empty() || all_r.empty()) return -1e300;
    long nlot = r[b] + n[b] + n[b + 1] + r[b + 2];
    std::vector<long> idx(nlot * d);
    std::vector<std::pair<long, long>> sel_c(nlot), sel_r(nlot);
    for (long t = 0; t < nlot; ++t) {
      sel_c[t] = all_c[rng.below(all_c.size())];
      sel_r[t] = all_r[rng.below(all_r.size())];
      walk_index(b, sel_c[t].first, sel_c[t].second, sel_r[t].first,
                 sel_r[t].second, idx.data() + t * d);
    }
    std::vector<Mp> bvals(nlot);
    fun(idx.data(), nlot, d, bvals.data());
    neval += nlot;
    track_amax(bvals);
    // lottery residuals
    std::vector<Mp> resid(nlot);
    Mp t;
    for (long q = 0; q < nlot; ++q) {
      resid[q] = bvals[q];
      for (long s = 0; s < r[b + 1]; ++s) {
        mul(t, Cf[b].at(sel_c[q].first, sel_c[q].second, s),
            Rf[b].at(s, sel_r[q].first, sel_r[q].second));
        sub(resid[q], resid[q], t);
      }
    }
    long bi = argmax_abs(resid);
    long ii = sel_c[bi].first, jj = sel_c[bi].second;
    long kk = sel_r[bi].first, qq = sel_r[bi].second;
    Mp pivot = resid[bi];

    // rook passes (dmrgg.f90:515-582 semantics, as in MpEngine)
    std::vector<Mp> acol, arow, bres;
    bool havecol = false, haverow = false;
    long crs = 0;
    bool skipcol = !dir_fwd;
    bool done = piv == 0;
    if (piv == 0) {
      eval_col(b, kk, qq, acol);
      eval_row(b, ii, jj, arow);
      havecol = haverow = true;
    }
    while (!done) {
      if (!skipcol) {
        eval_col(b, kk, qq, acol);
        havecol = true;
        ++crs;
        if (!(havecol && haverow && crs >= 2 * piv)) {
          col_residual(b, acol, kk, qq, bres);
          long f = argmax_abs(bres);
          long i2 = f / n[b], j2 = f % n[b];
          bool stat = havecol && haverow && i2 == ii && j2 == jj;
          ii = i2; jj = j2; pivot = bres[f];
          if (stat) break;
        } else {
          break;
        }
      }
      skipcol = false;
      eval_row(b, ii, jj, arow);
      haverow = true;
      ++crs;
      if (!(havecol && haverow && crs >= 2 * piv)) {
        row_residual(b, arow, ii, jj, bres);
        long f = argmax_abs(bres);
        long k2 = f / r[b + 2], q2 = f % r[b + 2];
        bool stat = havecol && haverow && k2 == kk && q2 == qq;
        kk = k2; qq = q2; pivot = bres[f];
        if (stat) break;
      } else {
        break;
      }
    }
    if (!havecol) eval_col(b, kk, qq, acol);
    if (!haverow) eval_row(b, ii, jj, arow);
    track_amax(acol);
    track_amax(arow);

    double lp = mag10(pivot);
    if (!(lp > lse + log_amax && lp > lsp + log_pivotmax_prev))
      return -1e300;

    accept(b, ii, jj, kk, qq, pivot, acol, arow);
    return lp;
  }

  void accept(long b, long ii, long jj, long kk, long qq, const Mp &pivot,
              const std::vector<Mp> &acol, const std::vector<Mp> &arow) {
    long R1 = r[b + 1];
    std::vector<Mp> c_new(R1), u_new(R1);
    for (long s = 0; s < R1; ++s) {
      c_new[s] = Cf[b].at(ii, jj, s);
      u_new[s] = Rf[b].at(s, kk, qq);
    }
    vip[b].push_back({ii, jj, kk, qq});

    // G[b] gains the column fiber as a new right slice; G[b+1] the row
    auto grow_right = [](MpMat &M, const std::vector<Mp> &col) {
      MpMat out;
      out.init(M.r0, M.n, M.r1 + 1);
      for (long i = 0; i < M.r0; ++i)
        for (long j = 0; j < M.n; ++j) {
          for (long k = 0; k < M.r1; ++k) out.at(i, j, k) = M.at(i, j, k);
          out.at(i, j, M.r1) = col[i * M.n + j];
        }
      M = std::move(out);
    };
    auto grow_left = [](MpMat &M, const std::vector<Mp> &row) {
      MpMat out;
      out.init(M.r0 + 1, M.n, M.r1);
      for (long i = 0; i < M.r0; ++i)
        for (long j = 0; j < M.n; ++j)
          for (long k = 0; k < M.r1; ++k) out.at(i, j, k) = M.at(i, j, k);
      for (long j = 0; j < M.n; ++j)
        for (long k = 0; k < M.r1; ++k)
          out.at(M.r0, j, k) = row[j * M.r1 + k];
      M = std::move(out);
    };
    grow_right(G[b], acol);
    grow_left(G[b + 1], arow);

    // new_colf = (acol - Cf[b] . u_new) / pivot
    std::vector<Mp> nc(r[b] * n[b]);
    Mp t;
    for (long i = 0; i < r[b]; ++i)
      for (long j = 0; j < n[b]; ++j) {
        Mp &o = nc[i * n[b] + j];
        o = acol[i * n[b] + j];
        for (long s = 0; s < R1; ++s) {
          mul(t, Cf[b].at(i, j, s), u_new[s]);
          sub(o, o, t);
        }
        divq(o, o, pivot);
      }
    grow_right(Cf[b], nc);
    // new_rowf = arow - c_new . Rf[b]
    std::vector<Mp> nr(n[b + 1] * r[b + 2]);
    for (long k = 0; k < n[b + 1]; ++k)
      for (long q = 0; q < r[b + 2]; ++q) {
        Mp &o = nr[k * r[b + 2] + q];
        o = arow[k * r[b + 2] + q];
        for (long s = 0; s < R1; ++s) {
          mul(t, c_new[s], Rf[b].at(s, k, q));
          sub(o, o, t);
        }
      }
    grow_left(Rf[b], nr);

    // bordered inverse growth (itl row, itt column), as _extend_inverses
    long s0 = R1;
    {
      std::vector<Mp> row_new(s0 + 1);
      for (long jx = 0; jx < s0; ++jx) {
        Mp acc;
        for (long ix = 0; ix < s0; ++ix) {
          mul(t, c_new[ix], itl[b][ix * s0 + jx]);
          add(acc, acc, t);
        }
        mpfr_neg(row_new[jx].v, acc.v, RNDN);
      }
      mpfr_set_si(row_new[s0].v, 1, RNDN);
      std::vector<Mp> out((s0 + 1) * (s0 + 1));
      for (long ix = 0; ix < s0; ++ix)
        for (long jx = 0; jx < s0; ++jx)
          out[ix * (s0 + 1) + jx] = itl[b][ix * s0 + jx];
      for (long jx = 0; jx <= s0; ++jx)
        out[s0 * (s0 + 1) + jx] = row_new[jx];
      itl[b] = std::move(out);
    }
    {
      std::vector<Mp> col_new(s0 + 1);
      for (long ix = 0; ix < s0; ++ix) {
        Mp acc;
        for (long jx = 0; jx < s0; ++jx) {
          mul(t, itt[b][ix * s0 + jx], u_new[jx]);
          add(acc, acc, t);
        }
        mpfr_neg(acc.v, acc.v, RNDN);
        divq(col_new[ix], acc, pivot);
      }
      Mp one(1);
      divq(col_new[s0], one, pivot);
      std::vector<Mp> out((s0 + 1) * (s0 + 1));
      for (long ix = 0; ix < s0; ++ix)
        for (long jx = 0; jx < s0; ++jx)
          out[ix * (s0 + 1) + jx] = itt[b][ix * s0 + jx];
      for (long ix = 0; ix <= s0; ++ix)
        out[ix * (s0 + 1) + s0] = col_new[ix];
      itt[b] = std::move(out);
    }
    r[b + 1] += 1;

    // neighbour slices (single-process: always local), as
    // apply_left_slice / apply_right_slice
    if (b > 0) {
      long sL = r[b];  // itl[b-1] is (sL x sL)
      std::vector<Mp> slc(sL * n[b]);
      for (long ix = 0; ix < sL; ++ix)
        for (long j = 0; j < n[b]; ++j) {
          Mp &o = slc[ix * n[b] + j];
          for (long s = 0; s < sL; ++s) {
            mul(t, itl[b - 1][ix * sL + s], acol[s * n[b] + j]);
            add(o, o, t);
          }
        }
      grow_right(Rf[b - 1], slc);
    }
    if (b < d - 2) {
      long sR = r[b + 2];  // itt[b+1] is (sR x sR)
      std::vector<Mp> slc(n[b + 1] * sR);
      for (long k = 0; k < n[b + 1]; ++k)
        for (long jx = 0; jx < sR; ++jx) {
          Mp &o = slc[k * sR + jx];
          for (long s = 0; s < sR; ++s) {
            mul(t, arow[k * r[b + 2] + s], itt[b + 1][s * sR + jx]);
            add(o, o, t);
          }
        }
      grow_left(Cf[b + 1], slc);
    }
  }

  // LU-solved quadrature value (ttqq + mptt_lua + mptt_quad)
  void value(const std::vector<std::vector<Mp>> &w, Mp &out) {
    // v starts as 1x1 [1]; per core: M = (G_c . w_c), itl/itt solves
    std::vector<Mp> v = {Mp(1)};
    long vr = 1;
    Mp t;
    for (long c = 0; c < d; ++c) {
      long r0 = G[c].r0, r1 = G[c].r1;
      std::vector<Mp> M(r0 * r1);
      for (long i = 0; i < r0; ++i)
        for (long k = 0; k < r1; ++k) {
          Mp &o = M[i * r1 + k];
          for (long j = 0; j < n[c]; ++j) {
            mul(t, G[c].at(i, j, k), w[c][j]);
            add(o, o, t);
          }
        }
      if (c > 0) {  // M = itl[c-1] @ M
        long s = r0;
        std::vector<Mp> M2(r0 * r1);
        for (long i = 0; i < r0; ++i)
          for (long k = 0; k < r1; ++k) {
            Mp &o = M2[i * r1 + k];
            for (long x = 0; x < s; ++x) {
              mul(t, itl[c - 1][i * s + x], M[x * r1 + k]);
              add(o, o, t);
            }
          }
        M = std::move(M2);
      }
      if (c < d - 1) {  // M = M @ itt[c]
        long s = r1;
        std::vector<Mp> M2(r0 * r1);
        for (long i = 0; i < r0; ++i)
          for (long k = 0; k < r1; ++k) {
            Mp &o = M2[i * r1 + k];
            for (long x = 0; x < s; ++x) {
              mul(t, M[i * r1 + x], itt[c][x * s + k]);
              add(o, o, t);
            }
          }
        M = std::move(M2);
      }
      // v = v @ M   (v is 1 x vr; M is r0 x r1 with r0 == vr)
      std::vector<Mp> v2(r1);
      for (long k = 0; k < r1; ++k) {
        Mp &o = v2[k];
        for (long x = 0; x < vr; ++x) {
          mul(t, v[x], M[x * r1 + k]);
          add(o, o, t);
        }
      }
      v = std::move(v2);
      vr = r1;
    }
    out = v[0];
  }

  // full driver loop; returns sweeps executed
  long run(const std::vector<std::vector<Mp>> &w, Mp &val_out,
           double *sweep_log10piv, double *sweep_err, const Mp *truth,
           long hist_cap) {
    init_state();
    long strike = 0, it = 0;
    Mp val, t;
    while (it + 1 < max_rank) {
      ++it;
      bool dir_fwd = it % 2 == 1;
      double log_pivotmax = -1e300;
      if (dir_fwd) {
        for (long b = 0; b < d - 1; ++b) {
          double lp = visit_bond(b, dir_fwd);
          if (lp > log_pivotmax) log_pivotmax = lp;
        }
      } else {
        for (long b = d - 2; b >= 0; --b) {
          double lp = visit_bond(b, dir_fwd);
          if (lp > log_pivotmax) log_pivotmax = lp;
        }
      }
      double err = -1;
      if (!w.empty()) {
        value(w, val);
        if (truth) {
          divq(t, val, *truth);
          Mp one(1);
          sub(t, one, t);
          mpfr_abs(t.v, t.v, RNDN);
          err = mag10(t);
        }
      }
      if (it - 1 < hist_cap) {
        if (sweep_log10piv) sweep_log10piv[it - 1] = log_pivotmax;
        if (sweep_err) sweep_err[it - 1] = err;
      }
      if (log_pivotmax > -1e299) log_pivotmax_prev = log_pivotmax;
      bool quiet = log_pivotmax <= lacc + log_amax;
      strike = quiet ? strike + 1 : 0;
      if (strike >= 3) break;
    }
    if (!w.empty()) value(w, val_out);
    return it;
  }
};

}  // namespace

// ------------------------------------------------------------- C exports
extern "C" {

// ABI sanity: return the first 8 digits of exp(1) at 400 bits as a long
// (27182818 expected) — proves the struct layout + link are right.
int64_t mp_selftest() {
  g_prec = 400;
  Mp one(1), e;
  mpfr_exp(e.v, one.v, RNDN);
  mpfr_mul_si(e.v, e.v, 10000000, RNDN);
  double v = mpfr_get_d(e.v, RNDN);
  return (int64_t)v;
}

// Built-in Ising cross at dps decimal digits.  Returns 0 on success.
// value_out receives the quadrature value as a decimal string.
int64_t mp_ising_cross(char kind, int64_t m, int64_t n_in, int64_t max_rank,
                       int64_t piv, int64_t dps, uint64_t seed, int64_t snum,
                       double small_element_log10, double small_pivot_log10,
                       double accuracy_log10, const char *truth_str,
                       char *value_out, int64_t value_cap,
                       int64_t *neval_out, int64_t *sweeps_out,
                       int64_t *ranks_out, double *sweep_log10piv,
                       double *sweep_err, int64_t hist_cap) {
  g_prec = (mpfr_prec_t)(dps * 3.3219280948873623) + 32;
  IsingMp ising;
  bool rescale = false;
  ising.init(kind, m, n_in, rescale);
  long d = ising.d;

  Fun fun = [&ising](const long *ind, long B, long dd, Mp *out) {
    std::vector<Mp> scratch;
    for (long b = 0; b < B; ++b) ising.eval(ind + b * dd, out[b], scratch);
  };

  double lse = small_element_log10 < 1e299 ? small_element_log10
                                           : (double)(-dps + 2);
  double lacc = accuracy_log10 < 1e299 ? accuracy_log10 : (double)(-dps + 4);
  Engine eng(fun, std::vector<long>(d, ising.n), max_rank, piv, snum, lse,
             small_pivot_log10, lacc, seed);

  std::vector<std::vector<Mp>> w(d);
  Mp qw, one(1);
  mpfr_set_si(qw.v, ising.quad_val, RNDN);
  divq(qw, one, qw);
  for (long c = 0; c < d; ++c) w[c].assign(ising.n, qw);

  Mp truth, val;
  const Mp *tp = nullptr;
  if (truth_str && truth_str[0]) {
    mpfr_set_str(truth.v, truth_str, 10, RNDN);
    tp = &truth;
  }
  long sweeps = eng.run(w, val, sweep_log10piv, sweep_err, tp, hist_cap);

  // serialize the value: mpfr_get_str gives mantissa digits + exponent
  mpfr_exp_t e10;
  char *s = mpfr_get_str(nullptr, &e10, 10, (size_t)dps + 8, val.v, RNDN);
  if (!s) return 2;
  int neg = s[0] == '-';
  long written = snprintf(value_out, value_cap, "%s0.%sE%ld",
                          neg ? "-" : "", s + neg, (long)e10);
  mpfr_free_str(s);
  if (written < 0 || written >= value_cap) return 3;

  *neval_out = eng.neval;
  *sweeps_out = sweeps;
  for (long c = 0; c <= d; ++c) ranks_out[c] = eng.r[c];
  return 0;
}

// Engine-native cross with a Python-callback integrand: cb fills
// out_strs[b] (decimal, caller-allocated cap bytes each) for ind (B, d).
typedef void (*mp_fun_cb)(int64_t B, const int64_t *ind, int64_t d,
                          char *out_strs, int64_t cap);

int64_t mp_cross_cb(mp_fun_cb cb, int64_t d, const int64_t *n_arr,
                    int64_t max_rank, int64_t piv, int64_t dps, uint64_t seed,
                    int64_t snum, double small_element_log10,
                    double small_pivot_log10, double accuracy_log10,
                    const char *quad_strs, int64_t quad_stride,
                    const char *truth_str, char *value_out, int64_t value_cap,
                    int64_t *neval_out, int64_t *sweeps_out,
                    int64_t *ranks_out) {
  g_prec = (mpfr_prec_t)(dps * 3.3219280948873623) + 32;
  long cap = dps + 32;
  std::vector<long> n(n_arr, n_arr + d);

  std::vector<int64_t> ibuf;
  std::vector<char> sbuf;
  Fun fun = [&](const long *ind, long B, long dd, Mp *out) {
    ibuf.assign(ind, ind + B * dd);
    sbuf.assign(B * cap, 0);
    cb(B, ibuf.data(), dd, sbuf.data(), cap);
    for (long b = 0; b < B; ++b)
      mpfr_set_str(out[b].v, sbuf.data() + b * cap, 10, RNDN);
  };

  double lse = small_element_log10 < 1e299 ? small_element_log10
                                           : (double)(-dps + 2);
  double lacc = accuracy_log10 < 1e299 ? accuracy_log10 : (double)(-dps + 4);
  Engine eng(fun, n, max_rank, piv, snum, lse, small_pivot_log10, lacc, seed);

  std::vector<std::vector<Mp>> w;
  if (quad_strs) {
    w.resize(d);
    for (long c = 0; c < d; ++c) {
      w[c].assign(n[c], Mp());
      for (long j = 0; j < n[c]; ++j)
        mpfr_set_str(w[c][j].v, quad_strs + (c * n[c] + j) * quad_stride, 10,
                     RNDN);
    }
  }
  Mp truth, val;
  const Mp *tp = nullptr;
  if (truth_str && truth_str[0]) {
    mpfr_set_str(truth.v, truth_str, 10, RNDN);
    tp = &truth;
  }
  long sweeps = eng.run(w, val, nullptr, nullptr, tp, 0);

  mpfr_exp_t e10;
  char *s = mpfr_get_str(nullptr, &e10, 10, (size_t)dps + 8, val.v, RNDN);
  if (!s) return 2;
  int neg = s[0] == '-';
  long written = snprintf(value_out, value_cap, "%s0.%sE%ld",
                          neg ? "-" : "", s + neg, (long)e10);
  mpfr_free_str(s);
  if (written < 0 || written >= value_cap) return 3;
  *neval_out = eng.neval;
  *sweeps_out = sweeps;
  for (long c = 0; c <= d; ++c) ranks_out[c] = eng.r[c];
  return 0;
}

}  // extern "C"
