// Native runtime components for ttcross-tpu.
//
// ttcross_tpu_torch's own copy of ttcross_tpu/native/src/ttcross_native.cpp,
// built with g++ by ttcross_tpu_torch/native/__init__.py.  Host code in
// __float128 and long double: the port's verification twins, no kernel.
//
// Plays the role of the reference's native layer (the MPFR C shims,
// mpinterface.c:1-85, were its only non-Fortran code): host-side kernels
// that need precision or IO throughput beyond what the Python layer should
// hand-roll.
//
//  1. gauss_legendre_q: Gauss-Legendre nodes/weights computed in __float128
//     (quad precision Newton on the Legendre recurrence — lgwt,
//     quad.f90:97-131) and returned as double-double (hi, lo) pairs.  This
//     feeds the dd precision tier (ops/dd.py) with quadrature rules whose
//     error is ~1e-34 instead of the ~1e-16 of an f64 rule generator.
//  2. dd_contract_chain: quad-precision TT chain contraction for
//     verification of the device dd path (mptt_quad analogue).
//  3. tt_write_raw / tt_read_raw: buffered binary TT core IO
//     (ttio.f90 stream format analogue at native speed).
//
// Built as a plain shared library; bound via ctypes (no pybind11 in the
// image).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <quadmath.h>

extern "C" {

// ---------------------------------------------------------------- quad GL
// Gauss-Legendre on [-1, 1] in __float128; outputs hi/lo double-double.
int gauss_legendre_q(int64_t n, double* x_hi, double* x_lo,
                     double* w_hi, double* w_lo) {
    const __float128 one = 1.0Q;
    const __float128 pi_q = 3.14159265358979323846264338327950288Q;
    int64_t m = (n + 1) / 2;
    for (int64_t i = 1; i <= m; ++i) {
        // Chebyshev initial guess, then Newton in quad precision
        __float128 z = cosq(pi_q * (4 * i - 1) / (4 * n + 2));
        __float128 pp = 0.0Q;
        for (int iter = 0; iter < 200; ++iter) {
            __float128 p1 = one, p2 = 0.0Q;
            for (int64_t j = 1; j <= n; ++j) {
                __float128 p3 = p2;
                p2 = p1;
                p1 = ((2 * j - 1) * z * p2 - (j - 1) * p3) / j;
            }
            pp = n * (z * p1 - p2) / (z * z - one);
            __float128 dz = p1 / pp;
            z -= dz;
            if (fabsq(dz) < 1e-35Q) break;
        }
        __float128 x = -z;
        __float128 w = 2.0Q / ((one - z * z) * pp * pp);
        double xh = (double)x;         double xl = (double)(x - (__float128)xh);
        double wh = (double)w;         double wl = (double)(w - (__float128)wh);
        x_hi[i - 1] = xh;  x_lo[i - 1] = xl;
        w_hi[i - 1] = wh;  w_lo[i - 1] = wl;
        x_hi[n - i] = -xh; x_lo[n - i] = -xl;
        w_hi[n - i] = wh;  w_lo[n - i] = wl;
    }
    if (n % 2 == 1) { x_hi[n / 2] = 0.0; x_lo[n / 2] = 0.0; }
    return 0;
}

// -------------------------------------------------- quad chain contraction
// val = e0^T (prod_c M_c) e0 with M_c[i,j] = sum_k cores_c[i,k,j] w_c[k],
// all arithmetic in __float128.  cores: concatenated C-order buffers.
int dd_contract_chain(int64_t d, const int64_t* rk, const int64_t* nmode,
                      const double* cores_flat, const double* w_hi,
                      const double* w_lo, int64_t wstride,
                      double* out_hi, double* out_lo) {
    // v has rk[0] entries (= 1 for a proper train)
    int64_t rmax = 1;
    for (int64_t c = 0; c <= d; ++c) if (rk[c] > rmax) rmax = rk[c];
    __float128* v = new __float128[rmax];
    __float128* vn = new __float128[rmax];
    for (int64_t i = 0; i < rk[0]; ++i) v[i] = (i == 0) ? 1.0Q : 0.0Q;

    const double* core = cores_flat;
    for (int64_t c = 0; c < d; ++c) {
        int64_t r1 = rk[c], nc = nmode[c], r2 = rk[c + 1];
        for (int64_t j = 0; j < r2; ++j) vn[j] = 0.0Q;
        for (int64_t i = 0; i < r1; ++i) {
            for (int64_t k = 0; k < nc; ++k) {
                __float128 wk = (__float128)w_hi[c * wstride + k]
                              + (__float128)w_lo[c * wstride + k];
                __float128 gv = (__float128)core[(i * nc + k) * r2] * wk;
                // inner loop over j with contiguous access
                const double* row = core + (i * nc + k) * r2;
                for (int64_t j = 0; j < r2; ++j) {
                    vn[j] += v[i] * (__float128)row[j] * wk;
                }
                (void)gv;
            }
        }
        for (int64_t j = 0; j < r2; ++j) v[j] = vn[j];
        core += r1 * nc * r2;
    }
    __float128 val = v[0];
    *out_hi = (double)val;
    *out_lo = (double)(val - (__float128)(*out_hi));
    delete[] v;
    delete[] vn;
    return 0;
}

// -------------------------------------------- extended-precision refinement
// The high-precision tier (the reference's MPFUN role): integrands and the
// cross-interpolant quadrature evaluated in __float128 on host.  Values in
// and out as double-double (hi, lo) pairs.

static inline __float128 dd_in(double hi, double lo) {
    return (__float128)hi + (__float128)lo;
}
static inline void dd_out(__float128 v, double* hi, double* lo) {
    *hi = (double)v;
    *lo = (double)(v - (__float128)(*hi));
}

// stdnorm integrand exp(-sum x^2) at dd nodes (test_crs_stdnorm parity)
int stdnorm_q(int64_t B, int64_t d, const int64_t* ind,
              const double* nodes_hi, const double* nodes_lo,
              double* out_hi, double* out_lo) {
    for (int64_t b = 0; b < B; ++b) {
        __float128 s = 0.0Q;
        for (int64_t c = 0; c < d; ++c) {
            __float128 x = dd_in(nodes_hi[ind[b * d + c]], nodes_lo[ind[b * d + c]]);
            s += x * x;
        }
        dd_out(expq(-s), out_hi + b, out_lo + b);
    }
    return 0;
}

// Ising C-kind integrand 2/(v w) * prod weights at dd nodes
// (dfunc_ising_discr id=1, test_crs_ising.f90:196-217)
int ising_c_q(int64_t B, int64_t d, const int64_t* ind,
              const double* nodes_hi, const double* nodes_lo,
              const double* w_hi, const double* w_lo,
              double* out_hi, double* out_lo) {
    for (int64_t b = 0; b < B; ++b) {
        __float128 v = 1.0Q, w = 1.0Q, vk = 1.0Q, wk = 1.0Q, f;
        for (int64_t i = 0; i < d; ++i) {
            int64_t fwd = ind[b * d + i];
            int64_t bwd = ind[b * d + (d - 1 - i)];
            wk *= dd_in(nodes_hi[fwd], nodes_lo[fwd]);
            vk *= dd_in(nodes_hi[bwd], nodes_lo[bwd]);
            v += vk;
            w += wk;
        }
        f = 2.0Q / (v * w);
        for (int64_t i = 0; i < d; ++i) {
            int64_t j = ind[b * d + i];
            f *= dd_in(w_hi[j], w_lo[j]);
        }
        dd_out(f, out_hi + b, out_lo + b);
    }
    return 0;
}

// Quadrature value of the cross interpolant in __float128:
//   val = e0 (prod_c  M_c * inv(Ahat_c))  with  M_c[i,j] = sum_k G_c[i,k,j] w_c[k]
// (the dtt_lua + dtt_quad pipeline of the mp tier, dmrggmp.f90:720-888).
// cores_*: concatenated C-order (r_c, n_c, r_{c+1}) buffers; ahat_*:
// concatenated (r_{b+1} x r_{b+1}) pivot submatrices per bond.
int cross_value_q(int64_t d, const int64_t* rk, const int64_t* nmode,
                  const double* cores_hi, const double* cores_lo,
                  const double* ahat_hi, const double* ahat_lo,
                  const double* w_hi, const double* w_lo, int64_t wstride,
                  double* out_hi, double* out_lo) {
    int64_t rmax = 1;
    for (int64_t c = 0; c <= d; ++c) if (rk[c] > rmax) rmax = rk[c];
    __float128* v = new __float128[rmax];
    __float128* vn = new __float128[rmax];
    __float128* A = new __float128[rmax * rmax];
    int64_t* piv = new int64_t[rmax];
    v[0] = 1.0Q;

    const double* core_h = cores_hi;
    const double* core_l = cores_lo;
    const double* ah = ahat_hi;
    const double* al = ahat_lo;
    int status = 0;
    for (int64_t c = 0; c < d; ++c) {
        int64_t r1 = rk[c], nc = nmode[c], r2 = rk[c + 1];
        // vn = v^T M_c
        for (int64_t j = 0; j < r2; ++j) vn[j] = 0.0Q;
        for (int64_t i = 0; i < r1; ++i) {
            for (int64_t k = 0; k < nc; ++k) {
                __float128 wk = dd_in(w_hi[c * wstride + k], w_lo[c * wstride + k]);
                const double* row_h = core_h + (i * nc + k) * r2;
                const double* row_l = core_l + (i * nc + k) * r2;
                __float128 s = v[i] * wk;
                for (int64_t j = 0; j < r2; ++j)
                    vn[j] += s * dd_in(row_h[j], row_l[j]);
            }
        }
        core_h += r1 * nc * r2;
        core_l += r1 * nc * r2;
        if (c < d - 1) {
            // need y = vn * inv(Ahat_c): solve B y^T = vn^T with B = Ahat^T
            // by textbook row-pivoted LU in __float128
            for (int64_t i = 0; i < r2; ++i)
                for (int64_t j = 0; j < r2; ++j)
                    A[i * r2 + j] = dd_in(ah[j * r2 + i], al[j * r2 + i]);  // B = Ahat^T
            ah += r2 * r2;
            al += r2 * r2;
            for (int64_t i = 0; i < r2; ++i) piv[i] = i;
            for (int64_t k = 0; k < r2; ++k) {
                int64_t p = k;
                for (int64_t i = k + 1; i < r2; ++i)
                    if (fabsq(A[piv[i] * r2 + k]) > fabsq(A[piv[p] * r2 + k])) p = i;
                int64_t tmp = piv[k]; piv[k] = piv[p]; piv[p] = tmp;
                __float128 akk = A[piv[k] * r2 + k];
                if (akk == 0.0Q) { status = -2; goto done; }
                for (int64_t i = k + 1; i < r2; ++i) {
                    __float128 m = A[piv[i] * r2 + k] / akk;
                    A[piv[i] * r2 + k] = m;
                    for (int64_t j = k + 1; j < r2; ++j)
                        A[piv[i] * r2 + j] -= m * A[piv[k] * r2 + j];
                }
            }
            // forward: L z = P vn^T (L unit lower, rows permuted by piv)
            for (int64_t k = 0; k < r2; ++k) {
                __float128 s = vn[piv[k]];
                for (int64_t j = 0; j < k; ++j) s -= A[piv[k] * r2 + j] * v[j];
                v[k] = s;   // z
            }
            // backward: U y^T = z
            for (int64_t k = r2 - 1; k >= 0; --k) {
                __float128 s = v[k];
                for (int64_t j = k + 1; j < r2; ++j) s -= A[piv[k] * r2 + j] * v[j];
                v[k] = s / A[piv[k] * r2 + k];
            }
        } else {
            for (int64_t j = 0; j < r2; ++j) v[j] = vn[j];
        }
    }
done:
    dd_out(v[0], out_hi, out_lo);
    delete[] v; delete[] vn; delete[] A; delete[] piv;
    return status;
}

// ------------------------------------------------- cross-language CHF check
// Independent C++ implementation of the n-d Gaussian characteristic
// function phi(omega) = exp(i omega.mu - omega^T Sigma omega / 2), for the
// cross-language validation the reference ran against an external binary
// (test_chf_equal.f90:44-63; that binary was not vendored — this one is).
int gaussian_chf_batch(int64_t B, int64_t n, const double* omega,
                       const double* mu, const double* sigma,
                       double* out_re, double* out_im) {
    for (int64_t b = 0; b < B; ++b) {
        const double* w = omega + b * n;
        long double dot_mu = 0.0L, quad = 0.0L;
        for (int64_t i = 0; i < n; ++i) {
            dot_mu += (long double)w[i] * mu[i];
            long double row = 0.0L;
            for (int64_t j = 0; j < n; ++j) row += (long double)sigma[i * n + j] * w[j];
            quad += (long double)w[i] * row;
        }
        long double mag = std::exp(-0.5L * quad);
        out_re[b] = (double)(mag * std::cos(dot_mu));
        out_im[b] = (double)(mag * std::sin(dot_mu));
    }
    return 0;
}

// ------------------------------------------------------------- binary IO
// Raw little-endian stream: magic "TTXN", version, flags, d, n[d], r[d+1],
// then core payloads (f64 or interleaved complex).
static const char MAGIC[4] = {'T', 'T', 'X', 'N'};

int tt_write_raw(const char* path, int64_t d, const int64_t* n,
                 const int64_t* r, const double* flat, int64_t count,
                 int32_t is_complex) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    int32_t hdr[4] = {1, 0, is_complex, (int32_t)d};
    if (fwrite(MAGIC, 1, 4, f) != 4) { fclose(f); return -2; }
    fwrite(hdr, sizeof(int32_t), 4, f);
    fwrite(n, sizeof(int64_t), d, f);
    fwrite(r, sizeof(int64_t), d + 1, f);
    size_t nw = fwrite(flat, sizeof(double), count, f);
    fclose(f);
    return nw == (size_t)count ? 0 : -3;
}

int tt_read_header(const char* path, int64_t* d_out, int32_t* is_complex,
                   int64_t* n_out, int64_t* r_out, int64_t max_d) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char magic[4];
    int32_t hdr[4];
    if (fread(magic, 1, 4, f) != 4 || memcmp(magic, MAGIC, 4) != 0) {
        fclose(f); return -2;
    }
    if (fread(hdr, sizeof(int32_t), 4, f) != 4 || hdr[0] != 1) {
        fclose(f); return -3;
    }
    int64_t d = hdr[3];
    if (d > max_d) { fclose(f); return -4; }
    *is_complex = hdr[2];
    *d_out = d;
    if (fread(n_out, sizeof(int64_t), d, f) != (size_t)d) { fclose(f); return -5; }
    if (fread(r_out, sizeof(int64_t), d + 1, f) != (size_t)d + 1) { fclose(f); return -6; }
    fclose(f);
    return 0;
}

int tt_read_data(const char* path, int64_t d, double* flat, int64_t count) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    long skip = 4 + 4 * sizeof(int32_t) + d * sizeof(int64_t)
              + (d + 1) * sizeof(int64_t);
    if (fseek(f, skip, SEEK_SET) != 0) { fclose(f); return -2; }
    size_t nr = fread(flat, sizeof(double), count, f);
    fclose(f);
    return nr == (size_t)count ? 0 : -3;
}

}  // extern "C"
