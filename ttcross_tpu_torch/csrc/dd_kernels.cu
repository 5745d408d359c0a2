// Hand-written Hopper (sm_90a) kernels of ttcross_tpu_torch's double-double
// (dd) tier.
//
// Built by ttcross_tpu_torch/ops/_build.py beside csrc/kernels.cu, with the
// same flags, and linked with it into one library with a plain C interface,
// loaded with ctypes by ttcross_tpu_torch/ops/kernels.py.  Every entry point
// launches on the stream it is given, allocates nothing (the wrapper
// allocates outputs and scratch with torch.empty) and returns
// cudaGetLastError().
//
// A dd value is a pair (hi, lo) of doubles; arrays of them are pairs of
// f64 arrays.  The JAX package runs these functions as XLA dd ops
// (ttcross_tpu/ops/dd.py, cross/engine_dd.py, apps/ising.py), never in
// Pallas; they are the dd variants of its two Pallas kernels
// (ttcross_tpu/ops/pallas_kernels.py:62 score_residual_argmax and :151
// small_table_lookup_limbs), because in eager PyTorch each dd operation is
// some twenty elementwise launches.
//
// Rounding.  Every step is written with __dadd_rn / __dsub_rn / __dmul_rn /
// __ddiv_rn, which nvcc never contracts into an FMA (the build keeps its
// default -fmad=true for csrc/kernels.cu), and in the operation order of
// ttcross_tpu_torch/ops/dd.py.  two_prod keeps Dekker's split as the plain
// version does: an FMA error term is exact on Hopper too, but it differs
// from Dekker's where a partial product underflows.  So each kernel is bit
// for bit its plain PyTorch version, hi and lo, on any input.
//
// What bounds them: f64 operations.  A dd multiply is 24 flops (two_prod
// 17, its cross terms 4, quick_two_sum 3), a dd add 11 (two_sum 6, two
// adds, quick_two_sum 3); none of them runs on the f64 tensor cores, so the
// card's rate for them is its f64 vector rate (33.5 TFLOP/s on the H100
// SXM).  Their shapes are small (a few thousand rows of R <= 64 terms), so
// the design is a thread per output with its sum in order, enough threads
// in flight, and one launch per call.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr double kSplit = 134217729.0;  // 2^27 + 1, Dekker's constant for binary64
constexpr int kThreads = 256;           // a block of D1, D3 and D4
constexpr int kClusterMax = 16;         // D1: blocks of its (non-portable) cluster
constexpr int kGatherRMax = 64;         // D3: ranks up to this
constexpr int kIsingThreads = 128;      // D2: rows (threads) of a block

struct DD {
  double hi, lo;
};

__device__ __forceinline__ DD two_sum(double a, double b) {
  const double s = __dadd_rn(a, b);
  const double v = __dsub_rn(s, a);
  return {s, __dadd_rn(__dsub_rn(a, __dsub_rn(s, v)), __dsub_rn(b, v))};
}

__device__ __forceinline__ DD quick_two_sum(double a, double b) {
  const double s = __dadd_rn(a, b);
  return {s, __dsub_rn(b, __dsub_rn(s, a))};
}

__device__ __forceinline__ void split(double a, double& hi, double& lo) {
  const double t = __dmul_rn(kSplit, a);
  hi = __dsub_rn(t, __dsub_rn(t, a));
  lo = __dsub_rn(a, hi);
}

__device__ __forceinline__ DD two_prod(double a, double b) {
  const double p = __dmul_rn(a, b);
  double ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  double e = __dsub_rn(__dmul_rn(ah, bh), p);
  e = __dadd_rn(e, __dmul_rn(ah, bl));
  e = __dadd_rn(e, __dmul_rn(al, bh));
  return {p, __dadd_rn(e, __dmul_rn(al, bl))};
}

__device__ __forceinline__ DD dd_add(DD x, DD y) {
  const DD s = two_sum(x.hi, y.hi);
  return quick_two_sum(s.hi, __dadd_rn(__dadd_rn(s.lo, x.lo), y.lo));
}

__device__ __forceinline__ DD dd_neg(DD x) { return {-x.hi, -x.lo}; }

__device__ __forceinline__ DD dd_mul(DD x, DD y) {
  const DD p = two_prod(x.hi, y.hi);
  const double e = __dadd_rn(__dadd_rn(p.lo, __dmul_rn(x.hi, y.lo)), __dmul_rn(x.lo, y.hi));
  return quick_two_sum(p.hi, e);
}

__device__ __forceinline__ DD dd_div(DD x, DD y) {
  const double q1 = __ddiv_rn(x.hi, y.hi);
  DD r = dd_add(x, dd_neg(dd_mul(DD{q1, 0.0}, y)));
  const double q2 = __ddiv_rn(r.hi, y.hi);
  r = dd_add(r, dd_neg(dd_mul(DD{q2, 0.0}, y)));
  const double q3 = __ddiv_rn(r.hi, y.hi);
  const DD s = quick_two_sum(q1, q2);
  return quick_two_sum(s.hi, __dadd_rn(s.lo, q3));
}

// sum_t (x_t m_t) * y_t or x_t * (y_t m_t), t = 0..T-1 in order from (0, 0)
// by dd_add of dd_mul terms (ops/dd.py::dd_sum's scan); m_t = 1 for t <
// rank, else 0, multiplied into the side mask_side names (1: x, 2: y, 0:
// none), as the JAX engine's rank mask multiplies it.
__device__ __forceinline__ DD dd_dot(const double* __restrict__ xh, const double* __restrict__ xl,
                                     long long xo, long long xst,
                                     const double* __restrict__ yh, const double* __restrict__ yl,
                                     long long yo, long long yst, int T, int rank,
                                     int mask_side) {
  DD acc{0.0, 0.0};
  for (int t = 0; t < T; ++t) {
    DD x{xh[xo + t * xst], xl[xo + t * xst]};
    DD y{yh[yo + t * yst], yl[yo + t * yst]};
    const double m = t < rank ? 1.0 : 0.0;
    if (mask_side == 1) {
      x = DD{__dmul_rn(x.hi, m), __dmul_rn(x.lo, m)};
    } else if (mask_side == 2) {
      y = DD{__dmul_rn(y.hi, m), __dmul_rn(y.lo, m)};
    }
    acc = dd_add(acc, dd_mul(x, y));
  }
  return acc;
}

// ---------------------------------------------------------------------------
// D1: the dd kernel A, masked |residual| argmax in dd.
//
// The dd variant of ttcross_tpu/ops/pallas_kernels.py:62
// score_residual_argmax; its dd function is every lottery and rook pass of
// ttcross_tpu/cross/engine_dd.py (:274-283, :306-334) and, with no mask,
// the accept's _mv_rank / _vm_rank (:378-394).  For b < B:
//     r[b] = vals[b] - sum_t x[b, t] y[b, t]   (r = the sum without vals)
// in dd, written out in full, and the first maximum of
//     mask[b] ? |r[b].hi| : -1
// with NaN above every number (torch.argmax), its index and r there.  x and
// y are strided views (a stride may be 0: a broadcast vector, or the
// transposed row factor of a row pass).  Bound: operations, B T dd
// multiply-adds (3120 x 48 x 35 flops at C_6, R = 48: 5.2 MFLOP, 0.16 us at
// 33.5 TFLOP/s).  One launch: a cluster of up to kClusterMax blocks, a
// thread per row (the cluster walks further rows in turn); each warp
// writes its best to the scratch words and arrives on the cluster barrier,
// and rank 0's first warp waits there and reduces the partials, as kernel
// A's fiber path does (csrc/kernels.cu).
// ---------------------------------------------------------------------------

struct Best {
  double score;
  long long idx;
  double hi, lo;
};

__device__ __forceinline__ bool better(double as, long long ai, double bs, long long bi) {
  const bool an = isnan(as), bn = isnan(bs);
  if (an || bn) return an && (!bn || ai < bi);
  return as > bs || (as == bs && ai < bi);
}

__device__ __forceinline__ void keep(Best& b, const Best& o) {
  if (better(o.score, o.idx, b.score, b.idx)) b = o;
}

__device__ __forceinline__ Best warp_reduce(Best b) {
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.score = __shfl_down_sync(0xffffffffu, b.score, off);
    o.idx = __shfl_down_sync(0xffffffffu, b.idx, off);
    o.hi = __shfl_down_sync(0xffffffffu, b.hi, off);
    o.lo = __shfl_down_sync(0xffffffffu, b.lo, off);
    keep(b, o);
  }
  return b;
}

__global__ void __launch_bounds__(kThreads)
dd_score_kernel(const double* __restrict__ vh, const double* __restrict__ vl,
                const double* __restrict__ xh, const double* __restrict__ xl,
                const double* __restrict__ yh, const double* __restrict__ yl, long long B,
                int T, long long xsb, long long xst, long long ysb, long long yst,
                const int32_t* __restrict__ rank_ptr, int mask_side,
                const uint8_t* __restrict__ mask, double* __restrict__ out,
                long long* __restrict__ words) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int t = threadIdx.x;
  const int rk = rank_ptr != nullptr ? *rank_ptr : T;
  Best b{-INFINITY, LLONG_MAX, 0.0, 0.0};
  for (long long row = (long long)rank * blockDim.x + t; row < B;
       row += (long long)C * blockDim.x) {
    DD r = dd_dot(xh, xl, row * xsb, xst, yh, yl, row * ysb, yst, T, rk, mask_side);
    if (vh != nullptr) r = dd_add(DD{vh[row], vl[row]}, dd_neg(r));
    out[row] = r.hi;
    out[B + row] = r.lo;
    const bool on = mask != nullptr && mask[row] != 0;
    keep(b, Best{on ? fabs(r.hi) : -1.0, row, r.hi, r.lo});
  }
  // words: [index, score, hi, lo] of the result, then 4 words per warp
  const unsigned nparts = C * (blockDim.x >> 5);
  double* part = reinterpret_cast<double*>(words + 4);
  b = warp_reduce(b);
  if ((t & 31) == 0) {
    const unsigned i = rank * (blockDim.x >> 5) + (t >> 5);
    part[i] = b.score;
    words[4 + nparts + i] = b.idx;
    part[2 * nparts + i] = b.hi;
    part[3 * nparts + i] = b.lo;
  }
  // release: the warps' partials are visible to whoever acquires the barrier
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  if (rank != 0 || t >= 32) return;
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  Best q{-INFINITY, LLONG_MAX, 0.0, 0.0};
  for (unsigned i = t; i < nparts; i += 32) {
    keep(q, Best{__ldcg(part + i), __ldcg(words + 4 + nparts + i), __ldcg(part + 2 * nparts + i),
                 __ldcg(part + 3 * nparts + i)});
  }
  q = warp_reduce(q);
  if (t == 0) {
    words[0] = q.idx;
    double* w = reinterpret_cast<double*>(words);
    w[1] = q.score;
    w[2] = q.hi;
    w[3] = q.lo;
  }
}

// ---------------------------------------------------------------------------
// D4: a small dd GEMM with strides.  out[i, j] = sum_t x[i, j, t] y[i, j, t]
// (t = 0..T-1 in order from (0, 0)), out (M, N) contiguous, x and y any
// strided views (a GEMM A @ B is x = A broadcast over j, y = B broadcast
// over i).  It serves the dd engine's _mm_left / _mm_right, value_mat and
// finalize (ttcross_tpu/cross/engine_dd.py:135-147, :443-504), its dd
// quadrature and the dd contraction (ops/dd.py::dd_contract).  Bound:
// operations, M N T dd multiply-adds.  A thread per output.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
dd_dot_kernel(const double* __restrict__ xh, const double* __restrict__ xl,
              const double* __restrict__ yh, const double* __restrict__ yl, long long M,
              long long N, int T, long long xs0, long long xs1, long long xs2, long long ys0,
              long long ys1, long long ys2, double* __restrict__ oh, double* __restrict__ ol) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M * N) return;
  const long long i = e / N, j = e % N;
  const DD r = dd_dot(xh, xl, i * xs0 + j * xs1, xs2, yh, yl, i * ys0 + j * ys1, ys2, T, T, 0);
  oh[e] = r.hi;
  ol[e] = r.lo;
}

// ---------------------------------------------------------------------------
// D3: dd_gather_tt, an f64 train evaluated at (B, d) indices with dd
// accumulation (ttcross_tpu/ops/dd.py:319-335): v = (1), then per core c
// v'[j] = sum_t v[t] * (G_c[t, i_c, j], 0) for t < r_c in order from (0, 0).
// The defect integrand's whole cost (cross/defect.py): at C_6 level 2 with
// a rank-32 first train ~4 x 32 x 32 dd multiply-adds per row.  The cores
// come packed, (d, R, N, R) zero-padded, with the ranks on the device.
// W threads per row (a multiple of 32, W >= every rank), kThreads / W rows
// per block; thread j of a row computes v'[j]; v lives in shared memory,
// double-buffered, one barrier per core.  Bound: operations.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
dd_gather_tt_kernel(const double* __restrict__ cores, const int32_t* __restrict__ ranks, int d,
                    int R, int N, const int32_t* __restrict__ ind, long long B,
                    double* __restrict__ oh, double* __restrict__ ol, int W) {
  __shared__ double v[2][2][kThreads];   // [buffer][hi, lo][row in block * W + j]
  const int j = threadIdx.x % W;
  const int rb = threadIdx.x / W;
  const long long row = (long long)blockIdx.x * (blockDim.x / W) + rb;
  const bool live = row < B;
  const int base = rb * W;
  v[0][0][base + j] = j == 0 ? 1.0 : 0.0;
  v[0][1][base + j] = 0.0;
  __syncthreads();
  int cur = 0;
  for (int c = 0; c < d; ++c) {
    const int r = ranks[c], r2 = ranks[c + 1];
    if (live && j < r2) {
      int i = ind[row * d + c];
      i = i < 0 ? 0 : (i >= N ? N - 1 : i);
      const double* g = cores + (long long)c * R * N * R + (long long)i * R + j;
      DD acc{0.0, 0.0};
      for (int t = 0; t < r; ++t) {
        const DD x{v[cur][0][base + t], v[cur][1][base + t]};
        acc = dd_add(acc, dd_mul(x, DD{g[(long long)t * N * R], 0.0}));
      }
      v[cur ^ 1][0][base + j] = acc.hi;
      v[cur ^ 1][1][base + j] = acc.lo;
    }
    cur ^= 1;
    __syncthreads();
  }
  if (live && j == 0) {
    oh[row] = v[cur][0][base];
    ol[row] = v[cur][1][base];
  }
}

// ---------------------------------------------------------------------------
// D2: the C-kind Ising integrand in dd, fused with its node / weight lookup
// (the dd variant of small_table_lookup_limbs, ttcross_tpu/ops/
// pallas_kernels.py:151, on the integrand of ttcross_tpu/apps/ising.py:
// 172-210): f = 2 / (v w) prod_i W_i with w = 1 + sum_k prod_{i<=k} x_i and
// v the same over the reversed row, each a scan of dd_mul / dd_add, then
// dd_div, then the weight product, in that file's order.  A row per thread,
// any d: each scan reads the row's indices from ind as it goes; the (4, n)
// table (node hi, node lo, weight hi, weight lo) in shared memory.  An
// index outside [0, n) is clamped, as JAX's gather clamps.  Bound:
// operations, ~4d + 20 dd operations per row.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kIsingThreads)
ising_c_dd_kernel(const double* __restrict__ tables, int n, const int32_t* __restrict__ ind,
                  long long B, int d, double* __restrict__ oh, double* __restrict__ ol) {
  extern __shared__ double tab[];
  for (int e = threadIdx.x; e < 4 * n; e += blockDim.x) tab[e] = tables[e];
  __syncthreads();
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const int32_t* row_ind = ind + row * d;
  auto at = [&](int c) {
    const int i = row_ind[c];
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
  };
  const DD one{1.0, 0.0};
  DD pk = one, w = one;
  for (int c = 0; c < d; ++c) {
    const int i = at(c);
    pk = dd_mul(pk, DD{tab[i], tab[n + i]});
    w = dd_add(w, pk);
  }
  DD v = one;
  pk = one;
  for (int c = d - 1; c >= 0; --c) {
    const int i = at(c);
    pk = dd_mul(pk, DD{tab[i], tab[n + i]});
    v = dd_add(v, pk);
  }
  const DD b = dd_div(DD{2.0, 0.0}, dd_mul(v, w));
  DD pw = one;
  for (int c = 0; c < d; ++c) {
    const int i = at(c);
    pw = dd_mul(pw, DD{tab[2 * n + i], tab[3 * n + i]});
  }
  const DD f = dd_mul(b, pw);
  oh[row] = f.hi;
  ol[row] = f.lo;
}

}  // namespace

extern "C" {

// D1.  vh/vl: (B,) or null (then r is the sum itself); x*/y*: strided
// (B, T) views, element (b, t) at b * s?b + t * s?t; rank: one int32 on
// the device or null (no rank mask); mask: B bytes or null (every score
// -1).  out: 2B doubles, r's hi then lo.  words: 4 + 4 * blocks *
// threads / 32 eight-byte words, the result [index, score, hi, lo] first.
// blocks <= kClusterMax is the cluster, threads a multiple of 32 <= kThreads.
int ttd_score_residual_argmax(const double* vh, const double* vl, const double* xh,
                              const double* xl, const double* yh, const double* yl,
                              long long B, int T, long long xsb, long long xst, long long ysb,
                              long long yst, const int32_t* rank, int mask_side,
                              const uint8_t* mask, double* out, long long* words, int blocks,
                              int threads, void* stream) {
  if (B < 1 || T < 0 || blocks < 1 || blocks > kClusterMax || threads < 32 ||
      threads > kThreads || threads % 32 != 0 || mask_side < 0 || mask_side > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(dd_score_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;  // the grid is one cluster
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dd_score_kernel, vh, vl, xh, xl, yh, yl, B, T, xsb, xst, ysb,
                           yst, rank, mask_side, mask, out, words);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// D4.  out (M, N) contiguous, hi and lo; strides in elements.
int ttd_dot(const double* xh, const double* xl, const double* yh, const double* yl, long long M,
            long long N, int T, long long xs0, long long xs1, long long xs2, long long ys0,
            long long ys1, long long ys2, double* oh, double* ol, void* stream) {
  const long long E = M * N;
  if (M < 1 || N < 1 || T < 0 || E > (long long)INT_MAX * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = (unsigned)((E + kThreads - 1) / kThreads);
  dd_dot_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xh, xl, yh, yl, M, N, T, xs0, xs1, xs2, ys0, ys1, ys2, oh, ol);
  return static_cast<int>(cudaGetLastError());
}

// D3.  cores (d, R, N, R) f64 contiguous, ranks d + 1 int32 on the device
// (every rank <= W <= kGatherRMax, W a multiple of 32), ind (B, d) int32.
int ttd_gather_tt(const double* cores, const int32_t* ranks, int d, int R, int N,
                  const int32_t* ind, long long B, double* oh, double* ol, int W, void* stream) {
  if (B < 1 || d < 1 || W < 32 || W > kGatherRMax || W % 32 != 0 || R > W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = kThreads / W;
  const unsigned blocks = (unsigned)((B + rows - 1) / rows);
  dd_gather_tt_kernel<<<blocks, rows * W, 0, static_cast<cudaStream_t>(stream)>>>(
      cores, ranks, d, R, N, ind, B, oh, ol, W);
  return static_cast<int>(cudaGetLastError());
}

// D2.  tables (4, n) f64: node hi, node lo, weight hi, weight lo; ind (B, d)
// int32, d >= 1.
int ttd_ising_c_integrand(const double* tables, int n, const int32_t* ind, long long B, int d,
                          double* oh, double* ol, void* stream) {
  if (B < 1 || d < 1 || n < 1 || 4 * n * (int)sizeof(double) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = (unsigned)((B + kIsingThreads - 1) / kIsingThreads);
  ising_c_dd_kernel<<<blocks, kIsingThreads, 4 * n * sizeof(double),
                      static_cast<cudaStream_t>(stream)>>>(tables, n, ind, B, d, oh, ol);
  return static_cast<int>(cudaGetLastError());
}

int ttd_threads(void) { return kThreads; }

int ttd_cluster_max(void) { return kClusterMax; }

int ttd_gather_rmax(void) { return kGatherRMax; }

}  // extern "C"
