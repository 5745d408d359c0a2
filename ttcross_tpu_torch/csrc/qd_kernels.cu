// Hand-written Hopper (sm_90a) kernels of ttcross_tpu_torch's quad-double
// (qd) tier: Q1-Q4.
//
// Built by ttcross_tpu_torch/ops/_build.py beside csrc/kernels.cu and
// csrc/dd_kernels.cu, with the same flags, and linked with them into one
// library with a plain C interface, loaded with ctypes by
// ttcross_tpu_torch/ops/kernels.py.  Every entry point launches on the
// stream it is given, allocates nothing (the wrapper allocates outputs and
// scratch with torch.empty) and returns cudaGetLastError().
//
// A qd value is four doubles (e0, e1, e2, e3); arrays of them are four f64
// arrays.  The JAX package runs these functions as numpy qd operations on
// the host (ttcross_tpu/ops/qd.py, cross/engine_qd.py, apps/ising.py,
// cross/defect.py), never in Pallas; they are the qd variants of its two
// Pallas kernels (ttcross_tpu/ops/pallas_kernels.py:62 score_residual_argmax
// and :151 small_table_lookup_limbs), because in eager PyTorch one qd
// multiply is some 130 elementwise launches.
//   Q1 ising_c_qd_kernel     the C-kind Ising integrand in qd with its lookup
//   Q2 qd_score_kernel       qd residual vals - sum_t x y (pairwise tree) and
//                            the first index of max |e0|
//   Q3 qd_gather_tt_kernel   an f64 train at (B, d) indices, qd accumulation
//   Q4 qd_dot_kernel         the small qd product: qd_matmul's sequential
//                            k-loop or qd_vdot_axis's pairwise tree
//
// Rounding.  Every step is written with __dadd_rn / __dsub_rn / __dmul_rn /
// __ddiv_rn, which nvcc never contracts into an FMA, in the operation order
// of ttcross_tpu_torch/ops/qd.py (Dekker's two_prod, the four bottom-up
// distill sweeps and the tail summed in order, qd_sum's tree with the odd
// middle term riding along, qd_matmul's k-loop).  So each kernel is bit for
// bit its plain PyTorch version on any input.
//
// Host emulation.  Compiled without nvcc (-DTTQ_HOST, a host C++ compiler,
// -ffp-contract=off), the file gives host entry points ttq_host_* that
// compute one output of a kernel with its own per-output function: the CPU
// tests hold that arithmetic to the plain versions where there is no card.
//
// What bounds them: f64 operations.  A qd multiply is 6 two_prods (17
// flops each), 5 products and the order-4 sum (5), and a distill of 17
// terms (4 x 16 two_sums of 6 flops, 13 adds): 508 flops; a qd add is a
// distill of 8 terms, 4 x 7 x 6 + 4 = 172 flops.  None runs on the f64
// tensor cores, so the card's rate for them is its f64 vector rate (33.5
// TFLOP/s on the H100 SXM).  The shapes are small (a few thousand outputs of
// T <= a few hundred terms), so the design is a thread per output with its
// sum in order, and one launch per call.

#include <climits>
#include <cmath>
#include <cstdint>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define TTQ_FN __device__ __forceinline__
#define TTQ_UNROLL _Pragma("unroll")
#define TTQ_ADD(a, b) __dadd_rn((a), (b))
#define TTQ_SUB(a, b) __dsub_rn((a), (b))
#define TTQ_MUL(a, b) __dmul_rn((a), (b))
#define TTQ_DIV(a, b) __ddiv_rn((a), (b))
#define TTQ_ISNAN(a) isnan(a)
#else
#define TTQ_FN static inline
#define TTQ_UNROLL
#define TTQ_ADD(a, b) ((a) + (b))
#define TTQ_SUB(a, b) ((a) - (b))
#define TTQ_MUL(a, b) ((a) * (b))
#define TTQ_DIV(a, b) ((a) / (b))
#define TTQ_ISNAN(a) std::isnan(a)
#endif

namespace {

constexpr double kSplit = 134217729.0;  // 2^27 + 1, Dekker's constant for binary64
constexpr int kThreads = 256;           // a block of Q2, Q3 and Q4
constexpr int kRowsThreads = 128;       // Q1: rows (threads) of a block
constexpr int kGatherRMax = 64;         // Q3: ranks up to this
constexpr int kTreeDepth = 16;          // the pairwise tree takes up to 2^16 terms

struct QD {
  double e0, e1, e2, e3;
};

TTQ_FN void two_sum(double a, double b, double& s, double& e) {
  s = TTQ_ADD(a, b);
  const double v = TTQ_SUB(s, a);
  e = TTQ_ADD(TTQ_SUB(a, TTQ_SUB(s, v)), TTQ_SUB(b, v));
}

TTQ_FN void split(double a, double& hi, double& lo) {
  const double t = TTQ_MUL(kSplit, a);
  hi = TTQ_SUB(t, TTQ_SUB(t, a));
  lo = TTQ_SUB(a, hi);
}

TTQ_FN void two_prod(double a, double b, double& p, double& e) {
  p = TTQ_MUL(a, b);
  double ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  double x = TTQ_SUB(TTQ_MUL(ah, bh), p);
  x = TTQ_ADD(x, TTQ_MUL(ah, bl));
  x = TTQ_ADD(x, TTQ_MUL(al, bh));
  e = TTQ_ADD(x, TTQ_MUL(al, bl));
}

// Four bottom-up VecSum sweeps of two_sum over the K terms, then the tail
// t[3] + t[4] + ... in order (ops/qd.py::_distill).
template <int K>
TTQ_FN QD distill(double (&t)[K]) {
  TTQ_UNROLL
  for (int pass = 0; pass < 4; ++pass) {
    TTQ_UNROLL
    for (int i = K - 2; i >= 0; --i) {
      double s, e;
      two_sum(t[i], t[i + 1], s, e);
      t[i] = s;
      t[i + 1] = e;
    }
  }
  double tail = t[3];
  TTQ_UNROLL
  for (int i = 4; i < K; ++i) tail = TTQ_ADD(tail, t[i]);
  return QD{t[0], t[1], t[2], tail};
}

TTQ_FN QD qd_neg(QD x) { return QD{-x.e0, -x.e1, -x.e2, -x.e3}; }

TTQ_FN QD qd_add(QD x, QD y) {
  double t[8] = {x.e0, y.e0, x.e1, y.e1, x.e2, y.e2, x.e3, y.e3};
  return distill<8>(t);
}

TTQ_FN QD qd_sub(QD x, QD y) { return qd_add(x, qd_neg(y)); }

TTQ_FN QD qd_mul(QD x, QD y) {
  double p00, q00, p01, q01, p10, q10, p02, q02, p11, q11, p20, q20;
  two_prod(x.e0, y.e0, p00, q00);
  two_prod(x.e0, y.e1, p01, q01);
  two_prod(x.e1, y.e0, p10, q10);
  two_prod(x.e0, y.e2, p02, q02);
  two_prod(x.e1, y.e1, p11, q11);
  two_prod(x.e2, y.e0, p20, q20);
  const double p03 = TTQ_MUL(x.e0, y.e3);
  const double p12 = TTQ_MUL(x.e1, y.e2);
  const double p21 = TTQ_MUL(x.e2, y.e1);
  const double p30 = TTQ_MUL(x.e3, y.e0);
  const double o4 = TTQ_ADD(TTQ_ADD(TTQ_MUL(x.e1, y.e3), TTQ_MUL(x.e2, y.e2)),
                            TTQ_MUL(x.e3, y.e1));
  double t[17] = {p00, p01, p10, q00, p02, p11, p20, q01, q10,
                  p03, p12, p21, p30, q02, q11, q20, o4};
  return distill<17>(t);
}

TTQ_FN QD qd_mul_f64(QD x, double b) {
  double p0, q0, p1, q1, p2, q2;
  two_prod(x.e0, b, p0, q0);
  two_prod(x.e1, b, p1, q1);
  two_prod(x.e2, b, p2, q2);
  const double p3 = TTQ_MUL(x.e3, b);
  double t[7] = {p0, p1, q0, p2, q1, p3, q2};
  return distill<7>(t);
}

TTQ_FN QD qd_div(QD x, QD y) {
  const double q0 = TTQ_DIV(x.e0, y.e0);
  QD r = qd_sub(x, qd_mul_f64(y, q0));
  const double q1 = TTQ_DIV(r.e0, y.e0);
  r = qd_sub(r, qd_mul_f64(y, q1));
  const double q2 = TTQ_DIV(r.e0, y.e0);
  r = qd_sub(r, qd_mul_f64(y, q2));
  const double q3 = TTQ_DIV(r.e0, y.e0);
  r = qd_sub(r, qd_mul_f64(y, q3));
  const double q4 = TTQ_DIV(r.e0, y.e0);
  double t[5] = {q0, q1, q2, q3, q4};
  return distill<5>(t);
}

// qd_sum's pairwise tree over the T terms leaf(0), ..., leaf(T - 1)
// (ops/qd.py::qd_sum): with K_0 = T and K_{l+1} = ceil(K_l / 2), position p
// of level l + 1 is qd_add(position p, position p + K_{l+1}) of level l when
// p < K_l - K_{l+1}, else (the odd middle term) position p itself.  Walked
// depth first from the root with a stack of one frame per level, so each
// leaf is computed once, when its sum needs it, and nothing of size T is
// stored.  T >= 1.
template <typename Leaf>
TTQ_FN QD tree_sum(int T, Leaf leaf) {
  int K[kTreeDepth + 1];
  int L = 0;
  K[0] = T;
  while (K[L] > 1 && L < kTreeDepth) {
    K[L + 1] = (K[L] + 1) / 2;
    ++L;
  }
  struct Frame {
    int l, p, state;
    QD left;
  };
  Frame st[kTreeDepth + 1];
  int sp = 0;
  st[0].l = L;
  st[0].p = 0;
  st[0].state = 0;
  QD ret{0.0, 0.0, 0.0, 0.0};
  bool returned = false;
  for (;;) {
    Frame& f = st[sp];
    if (!returned) {                  // a new frame
      if (f.l == 0) {
        ret = leaf(f.p);
      } else {
        f.state = 1;                  // descend to the left child
        ++sp;
        st[sp].l = f.l - 1;
        st[sp].p = f.p;
        st[sp].state = 0;
        continue;
      }
    } else if (f.state == 1) {        // the left child returned ret
      f.left = ret;
      const int lev = f.l - 1;
      if (f.p < K[lev] - K[lev + 1]) {  // paired: descend to the right child
        f.state = 2;
        ++sp;
        st[sp].l = lev;
        st[sp].p = f.p + K[lev + 1];
        st[sp].state = 0;
        returned = false;
        continue;
      }
      ret = f.left;                   // the odd middle term rides along
    } else {                          // the right child returned ret
      ret = qd_add(f.left, ret);
    }
    if (sp == 0) return ret;
    --sp;
    returned = true;
  }
}

// ---------------------------------------------------------------------------
// Per-output functions, shared by the kernels and the host emulation.
// ---------------------------------------------------------------------------

struct Limbs {
  const double* p[4];
};

TTQ_FN QD at(const Limbs& l, long long o) { return QD{l.p[0][o], l.p[1][o], l.p[2][o], l.p[3][o]}; }

// Q2's row: vals[row] - sum_t x[row, t] y[row, t] by the tree, x the left
// factor of every product.
struct ScoreArgs {
  Limbs v, x, y;
  long long B;
  int T;
  long long xsb, xst, ysb, yst;
};

TTQ_FN QD q2_row(const ScoreArgs& a, long long row) {
  const QD r = tree_sum(a.T, [&](int t) {
    return qd_mul(at(a.x, row * a.xsb + (long long)t * a.xst),
                  at(a.y, row * a.ysb + (long long)t * a.yst));
  });
  return qd_sub(at(a.v, row), r);
}

// Q4's output (i, j): sum_t x[i, j, t] y[i, j, t], by the tree (qd_vdot_axis)
// or from term 0 by qd_add of each next term in order (qd_matmul).
struct DotArgs {
  Limbs x, y;
  long long M, N;
  int T, tree;
  long long xs0, xs1, xs2, ys0, ys1, ys2;
};

TTQ_FN QD q4_out(const DotArgs& a, long long i, long long j) {
  const long long xo = i * a.xs0 + j * a.xs1, yo = i * a.ys0 + j * a.ys1;
  auto term = [&](int t) {
    return qd_mul(at(a.x, xo + (long long)t * a.xs2), at(a.y, yo + (long long)t * a.ys2));
  };
  if (a.tree) return tree_sum(a.T, term);
  if (a.T == 0) return QD{0.0, 0.0, 0.0, 0.0};
  QD acc = term(0);
  for (int t = 1; t < a.T; ++t) acc = qd_add(acc, term(t));
  return acc;
}

// Q3's entry j of the next v: sum_{t < r} qd_mul(v[t], (G_c[t, i_c, j], 0,
// 0, 0)) by the tree; g points at G_c[0, i_c, j] of the packed (R, N, R)
// core, vat(t) gives v[t].
template <typename V>
TTQ_FN QD q3_out(V vat, const double* g, int r, int N, int R) {
  return tree_sum(r, [&](int t) {
    return qd_mul(vat(t), QD{g[(long long)t * N * R], 0.0, 0.0, 0.0});
  });
}

// Q1's row: f = 2 / (v w) prod_i W_i with w = 1 + sum_k prod_{i<=k} x_i and
// v the same over the reversed row (ttcross_tpu/apps/ising.py:246-278);
// tab: (8, n) node limbs e0..e3 then weight limbs e0..e3; an index outside
// [0, n) is clamped.
TTQ_FN QD q1_row(const double* tab, int n, const int32_t* ri, int d) {
  auto col = [&](int c) {
    const int i = ri[c];
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
  };
  auto node = [&](int i) { return QD{tab[i], tab[n + i], tab[2 * n + i], tab[3 * n + i]}; };
  auto weight = [&](int i) {
    return QD{tab[4 * n + i], tab[5 * n + i], tab[6 * n + i], tab[7 * n + i]};
  };
  const QD one{1.0, 0.0, 0.0, 0.0};
  QD pk = one, w = one;
  for (int c = 0; c < d; ++c) {
    pk = qd_mul(pk, node(col(c)));
    w = qd_add(w, pk);
  }
  QD v = one;
  pk = one;
  for (int c = d - 1; c >= 0; --c) {
    pk = qd_mul(pk, node(col(c)));
    v = qd_add(v, pk);
  }
  const QD b = qd_div(QD{2.0, 0.0, 0.0, 0.0}, qd_mul(v, w));
  QD pw = one;
  for (int c = 0; c < d; ++c) pw = qd_mul(pw, weight(col(c)));
  return qd_mul(b, pw);
}

// NaN above every number, then the larger score, then the smaller index
// (torch.argmax's order).
TTQ_FN bool better(double as, long long ai, double bs, long long bi) {
  const bool an = TTQ_ISNAN(as), bn = TTQ_ISNAN(bs);
  if (an || bn) return an && (!bn || ai < bi);
  return as > bs || (as == bs && ai < bi);
}

#if defined(__CUDACC__)
struct Best {
  double score;
  long long idx;
};

__device__ __forceinline__ void keep(Best& b, const Best& o) {
  if (better(o.score, o.idx, b.score, b.idx)) b = o;
}

__device__ __forceinline__ Best warp_reduce(Best b) {
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.score = __shfl_down_sync(0xffffffffu, b.score, off);
    o.idx = __shfl_down_sync(0xffffffffu, b.idx, off);
    keep(b, o);
  }
  return b;
}

// The block's best, valid in thread 0; every thread of the block calls it.
__device__ Best block_reduce(Best b) {
  __shared__ double ss[kThreads / 32];
  __shared__ long long si[kThreads / 32];
  b = warp_reduce(b);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    ss[w] = b.score;
    si[w] = b.idx;
  }
  __syncthreads();
  if (w == 0) {
    Best q{-INFINITY, LLONG_MAX};
    if (lane < (int)(blockDim.x >> 5)) q = Best{ss[lane], si[lane]};
    b = warp_reduce(q);
  }
  __syncthreads();
  return b;
}

// ---------------------------------------------------------------------------
// Q2: the qd kernel A.  The qd variant of ttcross_tpu/ops/pallas_kernels.py:62
// score_residual_argmax on the qd engine's lottery and rook passes
// (ttcross_tpu/cross/engine_qd.py:175-268) and the accept's residual fibers
// (:281-290).  A thread per row writes r[row] (4 limbs); each block writes
// its best |r.e0| and index to the scratch words, and the last block to
// finish (by the counter in words[1], zeroed by the caller for each launch)
// reduces them into words[0].  Bound: operations, B T (qd multiply + qd add)
// + B qd adds.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
qd_score_kernel(ScoreArgs a, double* __restrict__ out, long long* __restrict__ words) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  Best b{-INFINITY, LLONG_MAX};
  if (row < a.B) {
    const QD r = q2_row(a, row);
    out[row] = r.e0;
    out[a.B + row] = r.e1;
    out[2 * a.B + row] = r.e2;
    out[3 * a.B + row] = r.e3;
    b = Best{fabs(r.e0), row};
  }
  b = block_reduce(b);
  const unsigned nb = gridDim.x;
  unsigned long long* counter = reinterpret_cast<unsigned long long*>(words + 1);
  double* pscore = reinterpret_cast<double*>(words + 2);
  long long* pidx = words + 2 + nb;
  __shared__ bool last;
  if (threadIdx.x == 0) {
    pscore[blockIdx.x] = b.score;
    pidx[blockIdx.x] = b.idx;
    __threadfence();  // the partials are visible before the count says so
    last = atomicAdd(counter, 1ull) == nb - 1;
  }
  __syncthreads();
  if (!last) return;
  Best q{-INFINITY, LLONG_MAX};
  for (unsigned i = threadIdx.x; i < nb; i += blockDim.x) {
    keep(q, Best{__ldcg(pscore + i), __ldcg(pidx + i)});
  }
  q = block_reduce(q);
  if (threadIdx.x == 0) words[0] = q.idx;
}

// ---------------------------------------------------------------------------
// Q4: a small qd product with strides.  out[i, j] = sum_t x[i, j, t]
// y[i, j, t], out (4, M, N) contiguous, x and y any strided views (a GEMM A @
// B is x = A broadcast over j, y = B broadcast over i).  It serves
// qd_matmul (tree = 0: apply_*_slice, solve_core, the value chain's
// products) and qd_vdot_axis (tree = 1: _extend_inverses, the value chain's
// weight contraction, qd_contract, refine_dd).  Bound: operations, M N T (qd
// multiply + qd add).  A thread per output.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
qd_dot_kernel(DotArgs a, double* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long E = a.M * a.N;
  if (e >= E) return;
  const QD r = q4_out(a, e / a.N, e % a.N);
  out[e] = r.e0;
  out[E + e] = r.e1;
  out[2 * E + e] = r.e2;
  out[3 * E + e] = r.e3;
}

// ---------------------------------------------------------------------------
// Q3: qd_gather_tt, an f64 train at (B, d) indices with qd accumulation
// (ttcross_tpu/ops/qd.py:384-403), the qd defect integrand's cost
// (ttcross_tpu/cross/defect.py:115-184).  The cores come packed, (d, R, N,
// R) zero-padded, the ranks on the device.  W threads per row (a multiple of
// 32, W >= every rank), kThreads / W rows per block; thread j of a row
// computes v'[j]; v lives in shared memory, double-buffered, one barrier per
// core.  Bound: operations, B sum_c r_c r_{c+1} (qd multiply + qd add).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
qd_gather_tt_kernel(const double* __restrict__ cores, const int32_t* __restrict__ ranks, int d,
                    int R, int N, const int32_t* __restrict__ ind, long long B,
                    double* __restrict__ out, int W) {
  __shared__ double v[2][4][kThreads];   // [buffer][limb][row in block * W + j]
  const int j = threadIdx.x % W;
  const int rb = threadIdx.x / W;
  const long long row = (long long)blockIdx.x * (blockDim.x / W) + rb;
  const bool live = row < B;
  const int base = rb * W;
  v[0][0][base + j] = j == 0 ? 1.0 : 0.0;
  v[0][1][base + j] = 0.0;
  v[0][2][base + j] = 0.0;
  v[0][3][base + j] = 0.0;
  __syncthreads();
  int cur = 0;
  for (int c = 0; c < d; ++c) {
    const int r = ranks[c], r2 = ranks[c + 1];
    if (live && j < r2) {
      int i = ind[row * d + c];
      i = i < 0 ? 0 : (i >= N ? N - 1 : i);
      const double* g = cores + (long long)c * R * N * R + (long long)i * R + j;
      const QD acc = q3_out(
          [&](int t) {
            return QD{v[cur][0][base + t], v[cur][1][base + t], v[cur][2][base + t],
                      v[cur][3][base + t]};
          },
          g, r, N, R);
      v[cur ^ 1][0][base + j] = acc.e0;
      v[cur ^ 1][1][base + j] = acc.e1;
      v[cur ^ 1][2][base + j] = acc.e2;
      v[cur ^ 1][3][base + j] = acc.e3;
    }
    cur ^= 1;
    __syncthreads();
  }
  if (live && j == 0) {
    out[row] = v[cur][0][base];
    out[B + row] = v[cur][1][base];
    out[2 * B + row] = v[cur][2][base];
    out[3 * B + row] = v[cur][3][base];
  }
}

// ---------------------------------------------------------------------------
// Q1: the C-kind Ising integrand in qd, fused with its node / weight lookup
// (the qd variant of small_table_lookup_limbs, ttcross_tpu/ops/
// pallas_kernels.py:151, on the integrand of ttcross_tpu/apps/ising.py:
// 246-278).  A row per thread, any d; the (8, n) table in shared memory.
// Bound: operations, per row 3d qd multiplies, 2d qd adds, one qd multiply,
// one qd divide and one more multiply.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kRowsThreads)
ising_c_qd_kernel(const double* __restrict__ tables, int n, const int32_t* __restrict__ ind,
                  long long B, int d, double* __restrict__ out) {
  extern __shared__ double tab[];
  for (int e = threadIdx.x; e < 8 * n; e += blockDim.x) tab[e] = tables[e];
  __syncthreads();
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const QD f = q1_row(tab, n, ind + row * d, d);
  out[row] = f.e0;
  out[B + row] = f.e1;
  out[2 * B + row] = f.e2;
  out[3 * B + row] = f.e3;
}
#endif  // __CUDACC__

Limbs limbs_of(const double* const* p) {
  Limbs l{};
  for (int k = 0; k < 4; ++k) l.p[k] = p[k];
  return l;
}

ScoreArgs score_args(const double* const* vals, const double* const* x, const double* const* y,
                     long long B, int T, long long xsb, long long xst, long long ysb,
                     long long yst) {
  return ScoreArgs{limbs_of(vals), limbs_of(x), limbs_of(y), B, T, xsb, xst, ysb, yst};
}

DotArgs dot_args(const double* const* x, const double* const* y, long long M, long long N, int T,
                 long long xs0, long long xs1, long long xs2, long long ys0, long long ys1,
                 long long ys2, int tree) {
  return DotArgs{limbs_of(x), limbs_of(y), M, N, T, tree, xs0, xs1, xs2, ys0, ys1, ys2};
}

#if !defined(__CUDACC__)
void put(const QD& r, double* out4) {
  out4[0] = r.e0;
  out4[1] = r.e1;
  out4[2] = r.e2;
  out4[3] = r.e3;
}
#endif

}  // namespace

extern "C" {

#if defined(__CUDACC__)
// Q2.  vals/x/y: host arrays of the 4 limb pointers; x and y strided (B, T)
// views, element (b, t) at b * s?b + t * s?t; T >= 1.  out: 4B doubles
// (limb-major).  words: 2 + 2 * blocks eight-byte words on the device, the
// index first, then the block counter, which must be zero at the launch.
// blocks = ceil(B / kThreads).
int ttq_score_residual_argmax(const double* const* vals, const double* const* x,
                              const double* const* y, long long B, int T, long long xsb,
                              long long xst, long long ysb, long long yst, double* out,
                              long long* words, void* stream) {
  if (B < 1 || T < 1 || T > (1 << kTreeDepth)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  qd_score_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      score_args(vals, x, y, B, T, xsb, xst, ysb, yst), out, words);
  return static_cast<int>(cudaGetLastError());
}

// Q4.  out (4, M, N) contiguous; strides in elements; tree: 1 for the
// pairwise tree (T >= 1), 0 for the sequential sum (T >= 0).
int ttq_dot(const double* const* x, const double* const* y, long long M, long long N, int T,
            long long xs0, long long xs1, long long xs2, long long ys0, long long ys1,
            long long ys2, int tree, double* out, void* stream) {
  const long long E = M * N;
  if (M < 1 || N < 1 || T < (tree ? 1 : 0) || T > (1 << kTreeDepth) ||
      E > (long long)INT_MAX * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = (unsigned)((E + kThreads - 1) / kThreads);
  qd_dot_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dot_args(x, y, M, N, T, xs0, xs1, xs2, ys0, ys1, ys2, tree), out);
  return static_cast<int>(cudaGetLastError());
}

// Q3.  cores (d, R, N, R) f64 contiguous, ranks d + 1 int32 on the device
// (every rank <= W <= kGatherRMax, W a multiple of 32), ind (B, d) int32;
// out 4B doubles.
int ttq_gather_tt(const double* cores, const int32_t* ranks, int d, int R, int N,
                  const int32_t* ind, long long B, double* out, int W, void* stream) {
  if (B < 1 || d < 1 || W < 32 || W > kGatherRMax || W % 32 != 0 || R > W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = kThreads / W;
  const unsigned blocks = (unsigned)((B + rows - 1) / rows);
  qd_gather_tt_kernel<<<blocks, rows * W, 0, static_cast<cudaStream_t>(stream)>>>(
      cores, ranks, d, R, N, ind, B, out, W);
  return static_cast<int>(cudaGetLastError());
}

// Q1.  tables (8, n) f64: node limbs e0..e3, weight limbs e0..e3; ind (B, d)
// int32, d >= 1; out 4B doubles.
int ttq_ising_c_integrand(const double* tables, int n, const int32_t* ind, long long B, int d,
                          double* out, void* stream) {
  if (B < 1 || d < 1 || n < 1 || 8 * n * (int)sizeof(double) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = (unsigned)((B + kRowsThreads - 1) / kRowsThreads);
  ising_c_qd_kernel<<<blocks, kRowsThreads, 8 * n * sizeof(double),
                      static_cast<cudaStream_t>(stream)>>>(tables, n, ind, B, d, out);
  return static_cast<int>(cudaGetLastError());
}

int ttq_threads(void) { return kThreads; }

int ttq_rows_threads(void) { return kRowsThreads; }

int ttq_gather_rmax(void) { return kGatherRMax; }

int ttq_tree_max(void) { return 1 << kTreeDepth; }

#else   // the host emulation: each kernel's per-output function, one output a call

// Q2's r[row], arguments as ttq_score_residual_argmax's.
void ttq_host_q2_row(const double* const* vals, const double* const* x, const double* const* y,
                     long long B, int T, long long xsb, long long xst, long long ysb,
                     long long yst, long long row, double* out4) {
  put(q2_row(score_args(vals, x, y, B, T, xsb, xst, ysb, yst), row), out4);
}

// Q4's out[i, j], arguments as ttq_dot's.
void ttq_host_q4_out(const double* const* x, const double* const* y, long long M, long long N,
                     int T, long long xs0, long long xs1, long long xs2, long long ys0,
                     long long ys1, long long ys2, int tree, long long i, long long j,
                     double* out4) {
  put(q4_out(dot_args(x, y, M, N, T, xs0, xs1, xs2, ys0, ys1, ys2, tree), i, j), out4);
}

// Q3's next v[j] from v (4 limb pointers, r entries) and g at G_c[0, i_c, j]
// of the packed (R, N, R) core.
void ttq_host_q3_out(const double* const* v, const double* g, int r, int N, int R,
                     double* out4) {
  const Limbs l = limbs_of(v);
  put(q3_out([&](int t) { return at(l, t); }, g, r, N, R), out4);
}

// Q1's row: tables (8, n), ri the row's d indices.
void ttq_host_q1_row(const double* tables, int n, const int32_t* ri, int d, double* out4) {
  put(q1_row(tables, n, ri, d), out4);
}

#endif  // __CUDACC__

}  // extern "C"
