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
// for bit its plain PyTorch version, hi and lo, on any input: a kernel
// chooses which thread computes a product, never the order of a sum.
//
// Host emulation.  Compiled without nvcc (-DTTD_HOST, a host C++ compiler,
// -ffp-contract=off), the file gives host entry points ttd_host_* that run
// D1's own functions in one host thread: its whole call block after block,
// each stage's items in turn, the stages in the kernel's order, in any plan;
// and ttd_dd_score_plan, its launch rule.  The CPU tests hold that
// arithmetic and its bookkeeping to the plain version where there is no
// card.
//
// What bounds them.  A dd multiply is 24 flops (two_prod 17, its cross
// terms 4, quick_two_sum 3), a dd add 11 (two_sum 6, two adds,
// quick_two_sum 3); none of them runs on the f64 tensor cores, so the card's
// rate for them is its f64 vector rate (33.5 TFLOP/s on the H100 SXM).
// Their shapes are small (a few thousand rows of R <= 64 terms), so the
// rate is far off; what a call waits on is a chain of dependent operations
// and loads.  D1's sum is ops/dd.py::dd_sum's scan, left to right from
// (0, 0) (the JAX package's lax.scan, on which the dd engine's
// pivot-for-pivot parity rests), so it cannot become a tree: one row's
// critical path is T dependent dd_adds (8 dependent f64 adds each).  D1
// therefore moves the products and their loads off the adding thread and
// spreads the rows over the card (below); D2-D4 keep a thread per output.

#include <climits>
#include <cmath>
#include <cstdint>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define TTD_FN __device__ __forceinline__
#define TTD_HD __host__ __device__ __forceinline__
#define TTD_ADD(a, b) __dadd_rn((a), (b))
#define TTD_SUB(a, b) __dsub_rn((a), (b))
#define TTD_MUL(a, b) __dmul_rn((a), (b))
#define TTD_DIV(a, b) __ddiv_rn((a), (b))
#define TTD_LD(p) __ldg(p)
#define TTD_UNROLL _Pragma("unroll")
#define TTD_ISNAN(a) isnan(a)
#define TTD_FABS(a) fabs(a)
#else
#include <vector>
#define TTD_FN static inline
#define TTD_HD static inline
#define TTD_ADD(a, b) ((a) + (b))
#define TTD_SUB(a, b) ((a) - (b))
#define TTD_MUL(a, b) ((a) * (b))
#define TTD_DIV(a, b) ((a) / (b))
#define TTD_LD(p) (*(p))
#define TTD_UNROLL
#define TTD_ISNAN(a) std::isnan(a)
#define TTD_FABS(a) std::fabs(a)
#endif

namespace {

constexpr double kSplit = 134217729.0;  // 2^27 + 1, Dekker's constant for binary64
constexpr int kThreads = 256;           // a block of D1, D3 and D4 at most
constexpr int kGatherRMax = 64;         // D3: ranks up to this
constexpr int kIsingThreads = 128;      // D2: rows (threads) of a block
constexpr int kChainLanes = 32;         // D1 chain: rows of a block at most (a warp's lanes)
constexpr int kItems = 4;               // D1: products a producer loads before it multiplies
constexpr int kSmemMax = 227 * 1024;    // shared memory one block may use
constexpr int kStaticSmem = 48 * 1024;  // dynamic shared memory above this needs an opt-in

struct DD {
  double hi, lo;
};

TTD_FN DD two_sum(double a, double b) {
  const double s = TTD_ADD(a, b);
  const double v = TTD_SUB(s, a);
  return {s, TTD_ADD(TTD_SUB(a, TTD_SUB(s, v)), TTD_SUB(b, v))};
}

TTD_FN DD quick_two_sum(double a, double b) {
  const double s = TTD_ADD(a, b);
  return {s, TTD_SUB(b, TTD_SUB(s, a))};
}

TTD_FN void split(double a, double& hi, double& lo) {
  const double t = TTD_MUL(kSplit, a);
  hi = TTD_SUB(t, TTD_SUB(t, a));
  lo = TTD_SUB(a, hi);
}

TTD_FN DD two_prod(double a, double b) {
  const double p = TTD_MUL(a, b);
  double ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  double e = TTD_SUB(TTD_MUL(ah, bh), p);
  e = TTD_ADD(e, TTD_MUL(ah, bl));
  e = TTD_ADD(e, TTD_MUL(al, bh));
  return {p, TTD_ADD(e, TTD_MUL(al, bl))};
}

TTD_FN DD dd_add(DD x, DD y) {
  const DD s = two_sum(x.hi, y.hi);
  return quick_two_sum(s.hi, TTD_ADD(TTD_ADD(s.lo, x.lo), y.lo));
}

TTD_FN DD dd_neg(DD x) { return {-x.hi, -x.lo}; }

TTD_FN DD dd_mul(DD x, DD y) {
  const DD p = two_prod(x.hi, y.hi);
  const double e = TTD_ADD(TTD_ADD(p.lo, TTD_MUL(x.hi, y.lo)), TTD_MUL(x.lo, y.hi));
  return quick_two_sum(p.hi, e);
}

TTD_FN DD dd_div(DD x, DD y) {
  const double q1 = TTD_DIV(x.hi, y.hi);
  DD r = dd_add(x, dd_neg(dd_mul(DD{q1, 0.0}, y)));
  const double q2 = TTD_DIV(r.hi, y.hi);
  r = dd_add(r, dd_neg(dd_mul(DD{q2, 0.0}, y)));
  const double q3 = TTD_DIV(r.hi, y.hi);
  const DD s = quick_two_sum(q1, q2);
  return quick_two_sum(s.hi, TTD_ADD(s.lo, q3));
}

// ---------------------------------------------------------------------------
// D1: the dd kernel A, masked |residual| argmax in dd.
//
// The dd variant of ttcross_tpu/ops/pallas_kernels.py:62
// score_residual_argmax; its dd function is every lottery and rook pass of
// ttcross_tpu/cross/engine_dd.py (:274-283, :306-334) and, with no mask,
// the accept's _mv_rank / _vm_rank (:378-394).  For b < B:
//     r[b] = vals[b] - sum_t x[b, t] y[b, t]   (r = the sum without vals)
// in dd, the sum from (0, 0) by dd_add of each dd_mul term in order, and the
// first maximum of
//     mask[b] ? |r[b].hi| : -1
// with NaN above every number (torch.argmax), its index and r there.  x and
// y are strided views (a stride may be 0: a broadcast vector, or the
// transposed row factor of a row pass).  The rank mask m_t = (t < rank)
// multiplies x (mask_side 1) or y (mask_side 2), as the JAX engine's does.
//
// Bound.  Operations: B T dd multiply-adds (3120 x 48 x 35 flops at C_6,
// R = 48: 5.2 MFLOP, 0.16 us at 33.5 TFLOP/s), or bytes where both operands
// are gathered; but a row's critical path is its T dependent dd_adds
// (the scan may not become a tree), each 8 dependent f64 adds from the
// running sum's hi part to the next one's: ~0.04 us a term on an H100.  A
// thread that loads its own terms waits on four scattered loads per term
// before its dd_mul and dd_add (0.3-0.5 us a term measured with a thread
// per row in one cluster of at most 16 blocks: the loads' latency, not the
// adds'), and few rows leave most SMs idle.
//
// Design.  A block takes P <= 32 rows.  Warp 0 is the chain warp: lane g
// holds row g's sum and adds its terms in order from shared memory.  The
// block's other warps (the producers) load the next chunk of C terms of x
// and y and compute its dd_mul products (rank mask included) into the
// other half of a double buffer, one barrier a chunk; each producer issues
// the loads of up to kItems products before it multiplies any, so a chunk
// costs about one load latency however long it is.  The producers walk t
// fastest where an operand is a (B, T) array contiguous along t (the
// lottery's and the column pass's gathered rows), b fastest where the only
// such operand is contiguous along b (the row pass's transposed rowf_t), so
// neighbouring threads read neighbouring words; a broadcast vector (stride
// 0 along b) comes from the L2 once per block and from L1 after.  The plan
// (score_plan) is a function of the shape alone: every row in one block up
// to 32 rows (no step across blocks), else P rows a block so that a small B
// still spreads over the card.  Each block writes its best (score, index,
// r.hi, r.lo) to the scratch words; the last block to finish (a counter in
// the scratch words that the entry point zeroes on the stream for each
// launch, so no state outlives a launch) reduces them.  A grid of one block
// writes its best directly.
// ---------------------------------------------------------------------------

struct ScoreArgs {
  const double *vh, *vl, *xh, *xl, *yh, *yl;
  long long B;
  int T;
  long long xsb, xst, ysb, yst;
  const int32_t* rank;
  int mask_side;
  const uint8_t* mask;
};

TTD_FN int rank_of(const ScoreArgs& a) { return a.rank != nullptr ? TTD_LD(a.rank) : a.T; }

// Term t of row b's factors.
TTD_FN void d1_load(const ScoreArgs& a, long long b, int t, DD& x, DD& y) {
  const long long xo = b * a.xsb + (long long)t * a.xst, yo = b * a.ysb + (long long)t * a.yst;
  x = DD{TTD_LD(a.xh + xo), TTD_LD(a.xl + xo)};
  y = DD{TTD_LD(a.yh + yo), TTD_LD(a.yl + yo)};
}

// Term t's product, the rank mask multiplied into the side mask_side names.
TTD_FN DD d1_term(const ScoreArgs& a, int t, int rk, DD x, DD y) {
  const double m = t < rk ? 1.0 : 0.0;
  if (a.mask_side == 1) {
    x = DD{TTD_MUL(x.hi, m), TTD_MUL(x.lo, m)};
  } else if (a.mask_side == 2) {
    y = DD{TTD_MUL(y.hi, m), TTD_MUL(y.lo, m)};
  }
  return dd_mul(x, y);
}

// Row b's vals and mask, read by its chain lane before the sum, so that
// their latency hides behind the first chunk's.
struct RowIn {
  DD v;
  bool on;
};

TTD_FN RowIn d1_row_in(const ScoreArgs& a, long long b) {
  RowIn in{DD{0.0, 0.0}, a.mask != nullptr && TTD_LD(a.mask + b) != 0};
  if (a.vh != nullptr) in.v = DD{TTD_LD(a.vh + b), TTD_LD(a.vl + b)};
  return in;
}

TTD_FN DD d1_finish(const ScoreArgs& a, const RowIn& in, DD acc) {
  return a.vh == nullptr ? acc : dd_add(in.v, dd_neg(acc));
}

// Whether the producers walk t fastest (else b): see the design note.
TTD_FN bool terms_fastest(const ScoreArgs& a) {
  const bool xt = a.xsb != 0 && a.xst == 1, yt = a.ysb != 0 && a.yst == 1;
  return xt || yt || !(a.xsb == 1 || a.ysb == 1);
}

// The stages.  Chunk k holds terms kC .. kC + len - 1 of the block's np rows
// in half k & 1 of the double buffer: term c of row g at half + g W + c (hi)
// and half + P W + g W + c (lo), W = C | 1 an odd pitch (a walk along c or
// along g, and the chain lanes' reads along g, hit distinct banks), half =
// (k & 1) 2 P W.
TTD_HD int pitch(int C) { return C | 1; }

TTD_FN void d1_produce(const ScoreArgs& a, long long row0, int np, int P, int C, double* buf,
                       int k, int rk, bool tfast, int tid, int nth) {
  const int t0 = k * C, len = a.T - t0 < C ? a.T - t0 : C, W = pitch(C);
  const int half = (k & 1) * 2 * P * W, n = np * len;
  for (int base = tid; base < n; base += kItems * nth) {
    DD x[kItems], y[kItems];
    TTD_UNROLL
    for (int u = 0; u < kItems; ++u) {   // every load first: in flight together
      const int it = base + u * nth;
      if (it < n) {
        const int g = tfast ? it / len : it % np, c = tfast ? it - g * len : it / np;
        d1_load(a, row0 + g, t0 + c, x[u], y[u]);
      }
    }
    TTD_UNROLL
    for (int u = 0; u < kItems; ++u) {
      const int it = base + u * nth;
      if (it < n) {
        const int g = tfast ? it / len : it % np, c = tfast ? it - g * len : it / np;
        const DD v = d1_term(a, t0 + c, rk, x[u], y[u]);
        buf[half + g * W + c] = v.hi;
        buf[half + P * W + g * W + c] = v.lo;
      }
    }
  }
}

TTD_FN void d1_chain(const ScoreArgs& a, int P, int C, const double* buf, int k, int g, DD& acc) {
  const int t0 = k * C, len = a.T - t0 < C ? a.T - t0 : C, W = pitch(C);
  const double* h = buf + (k & 1) * 2 * P * W + g * W;
  for (int c = 0; c < len; ++c) acc = dd_add(acc, DD{h[c], h[P * W + c]});
}

// The argmax's order: NaN above every number, then the larger score, then
// the smaller index (torch.argmax's).
struct Best {
  double score;
  long long idx;
  double hi, lo;
};

TTD_FN bool better(double as, long long ai, double bs, long long bi) {
  const bool an = TTD_ISNAN(as), bn = TTD_ISNAN(bs);
  if (an || bn) return an && (!bn || ai < bi);
  return as > bs || (as == bs && ai < bi);
}

TTD_FN void keep(Best& b, const Best& o) {
  if (better(o.score, o.idx, b.score, b.idx)) b = o;
}

TTD_FN Best best_of_row(const RowIn& in, long long b, DD r) {
  return Best{in.on ? TTD_FABS(r.hi) : -1.0, b, r.hi, r.lo};
}

TTD_FN Best none() { return Best{-INFINITY, LLONG_MAX, 0.0, 0.0}; }

// Launch of one shape: P rows a block, 32 chain threads + producers, chunks
// of C terms.
struct ScorePlan {
  int P, C, threads;
  long long blocks, smem;
};

ScorePlan score_plan_of(long long B, int P, int C) {
  const long long items = (long long)P * C, prod = kThreads - kChainLanes;
  const int threads = kChainLanes + (int)(items < prod ? (items + 31) / 32 * 32 : prod);
  return ScorePlan{P, C, threads, (B + P - 1) / (P < 1 ? 1 : P), 32LL * P * pitch(C)};
}

// The rule, measured on an H100 (chip_smoke.py --qd-regimes times every
// plan at the dd paths' shapes and at up to ~50k rows; PERF.md): up to 32
// rows one block of B rows, with no step across blocks ((32, 32) 6.4 us
// against 8.4-9.0 in 2-32 blocks); then 8 rows a block below 1,056 rows,
// 16 below 4,224, 32 from there (fewer rows a block leave the chain warp
// more of its block's time to wait on loads: (3120, 48) 11.6 us at 16 rows
// against 17.5 at 4; more rows stretch the producers' pass: 12.7 at 32 with
// chunks of 7).  Chunks: what the producers load in one pass, kItems (256 -
// 32) / P terms, at most T.  A thread per row over the whole card lost at
// every row count measured (4,431 against 752 us at 798,720 rows).
ScorePlan score_plan(long long B, int T) {
  const int P = B <= kChainLanes ? (int)B : (B < 1056 ? 8 : (B < 4224 ? 16 : kChainLanes));
  const int C = kItems * (kThreads - kChainLanes) / P;
  return score_plan_of(B, P, T < 1 ? 1 : (T < C ? T : C));
}

bool score_shape_ok(long long B, int T, int mask_side) {
  return B >= 1 && T >= 0 && mask_side >= 0 && mask_side <= 2;
}

bool score_plan_ok(const ScorePlan& p) {
  return p.blocks <= INT_MAX && p.P >= 1 && p.P <= kChainLanes && p.C >= 1 && p.smem <= kSmemMax;
}

ScoreArgs score_args(const double* vh, const double* vl, const double* xh, const double* xl,
                     const double* yh, const double* yl, long long B, int T, long long xsb,
                     long long xst, long long ysb, long long yst, const int32_t* rank,
                     int mask_side, const uint8_t* mask) {
  return ScoreArgs{vh, vl, xh, xl, yh, yl, B, T, xsb, xst, ysb, yst, rank, mask_side, mask};
}

#if defined(__CUDACC__)
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

// The grid's best from each block's (valid in its thread 0; every thread of
// the block calls it).  words: [index, score, hi, lo] of the result; with
// more than one block, then the counter (zero at the launch) and the blocks'
// scores, indices, hi and lo, nb words each.
__device__ void grid_argmax(Best b, long long* words) {
  const unsigned nb = gridDim.x;
  double* res = reinterpret_cast<double*>(words);
  if (nb == 1) {
    if (threadIdx.x == 0) {
      words[0] = b.idx;
      res[1] = b.score;
      res[2] = b.hi;
      res[3] = b.lo;
    }
    return;
  }
  unsigned long long* counter = reinterpret_cast<unsigned long long*>(words + 4);
  double* ps = reinterpret_cast<double*>(words + 5);
  long long* pi = words + 5 + nb;
  double* ph = ps + 2 * nb;
  double* pl = ps + 3 * nb;
  __shared__ bool last;
  if (threadIdx.x == 0) {
    ps[blockIdx.x] = b.score;
    pi[blockIdx.x] = b.idx;
    ph[blockIdx.x] = b.hi;
    pl[blockIdx.x] = b.lo;
    __threadfence();  // the partials are visible before the count says so
    last = atomicAdd(counter, 1ull) == nb - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  Best q = none();
  for (unsigned i = threadIdx.x; i < nb; i += 32) {
    keep(q, Best{__ldcg(ps + i), __ldcg(pi + i), __ldcg(ph + i), __ldcg(pl + i)});
  }
  q = warp_reduce(q);
  if (threadIdx.x == 0) {
    words[0] = q.idx;
    res[1] = q.score;
    res[2] = q.hi;
    res[3] = q.lo;
  }
}

// Lanes 0..np-1 of warp 0 each add their row's terms in order from one half
// of the double buffer while warps 1.. compute the next chunk into the other
// half; one barrier a chunk.
__global__ void __launch_bounds__(kThreads)
dd_score_kernel(ScoreArgs a, int P, int C, double* __restrict__ out,
                long long* __restrict__ words) {
  extern __shared__ double dsm[];
  const long long row0 = (long long)blockIdx.x * P;
  const int np = (int)(a.B - row0 < P ? a.B - row0 : P), tid = threadIdx.x;
  const int nch = (a.T + C - 1) / C;
  const int rk = rank_of(a);
  const bool tfast = terms_fastest(a);
  const RowIn in = tid < np ? d1_row_in(a, row0 + tid) : RowIn{DD{0.0, 0.0}, false};
  DD acc{0.0, 0.0};
  for (int k = 0; k <= nch; ++k) {
    if (tid >= kChainLanes) {
      if (k < nch) {
        d1_produce(a, row0, np, P, C, dsm, k, rk, tfast, tid - kChainLanes,
                   blockDim.x - kChainLanes);
      }
    } else if (tid < np && k > 0) {
      d1_chain(a, P, C, dsm, k - 1, tid, acc);
    }
    __syncthreads();
  }
  Best b = none();
  if (tid < np) {
    const DD r = d1_finish(a, in, acc);
    out[row0 + tid] = r.hi;
    out[a.B + row0 + tid] = r.lo;
    b = best_of_row(in, row0 + tid, r);
  }
  if (tid < 32) b = warp_reduce(b);  // every row of the block is in warp 0
  grid_argmax(b, words);
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
  const long long xo = i * xs0 + j * xs1, yo = i * ys0 + j * ys1;
  DD acc{0.0, 0.0};
  for (int t = 0; t < T; ++t) {
    acc = dd_add(acc, dd_mul(DD{xh[xo + t * xs2], xl[xo + t * xs2]},
                             DD{yh[yo + t * ys2], yl[yo + t * ys2]}));
  }
  oh[e] = acc.hi;
  ol[e] = acc.lo;
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
#endif  // __CUDACC__

}  // namespace

extern "C" {

#if defined(__CUDACC__)
// D1 in the plan (P, C) that ttd_dd_score_plan gives the shape, or another
// the caller names (the card tests and the tuning launch other plans).
// vh/vl: (B,) or null (then r is the sum itself); x*/y*: strided (B, T)
// views, element (b, t) at b * s?b + t * s?t; rank: one int32 on the
// device or null (no rank mask); mask: B bytes or null (every score -1).
// out: 2B doubles, r's hi then lo.  words: 5 + 4 * blocks eight-byte words,
// the result [index, score, hi, lo] first; with more than one block the
// counter after it is zeroed here, on the stream, before the launch.
int ttd_score_residual_argmax(const double* vh, const double* vl, const double* xh,
                              const double* xl, const double* yh, const double* yl,
                              long long B, int T, long long xsb, long long xst, long long ysb,
                              long long yst, const int32_t* rank, int mask_side,
                              const uint8_t* mask, int P, int C, double* out, long long* words,
                              void* stream) {
  const ScorePlan p = score_plan_of(B, P, C);
  if (!score_shape_ok(B, T, mask_side) || !score_plan_ok(p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.blocks > 1) {
    const cudaError_t err = cudaMemsetAsync(words + 4, 0, sizeof(long long), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p.smem > kStaticSmem) {
    cudaFuncSetAttribute(dd_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)p.smem);
  }
  dd_score_kernel<<<(unsigned)p.blocks, p.threads, p.smem, st>>>(
      score_args(vh, vl, xh, xl, yh, yl, B, T, xsb, xst, ysb, yst, rank, mask_side, mask), p.P,
      p.C, out, words);
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

int ttd_gather_rmax(void) { return kGatherRMax; }

#else   // the host emulation: D1's functions in one host thread

// D1's whole call in the plan (P, C), arguments as
// ttd_score_residual_argmax's (every pointer on the host): block after
// block, each stage's items in turn, the stages in the kernel's order, then
// the grid's argmax over the blocks' best.  out: 2B doubles; words: the
// result [index, score, hi, lo].  Returns 0, or -1 for a shape or plan the
// card's entry point refuses.
int ttd_host_d1(const double* vh, const double* vl, const double* xh, const double* xl,
                const double* yh, const double* yl, long long B, int T, long long xsb,
                long long xst, long long ysb, long long yst, const int32_t* rank, int mask_side,
                const uint8_t* mask, int P, int C, double* out, long long* words) {
  const ScorePlan p = score_plan_of(B, P, C);
  if (!score_shape_ok(B, T, mask_side) || !score_plan_ok(p)) return -1;
  const ScoreArgs a = score_args(vh, vl, xh, xl, yh, yl, B, T, xsb, xst, ysb, yst, rank,
                                 mask_side, mask);
  const int rk = rank_of(a);
  const bool tfast = terms_fastest(a);
  const int nch = (T + C - 1) / C;
  std::vector<double> buf(p.smem / 8);
  Best q = none();     // the blocks' best, in block order
  for (long long row0 = 0; row0 < B; row0 += P) {
    const int np = (int)(B - row0 < P ? B - row0 : P);
    std::vector<DD> acc(np, DD{0.0, 0.0});
    for (int k = 0; k <= nch; ++k) {
      if (k < nch) d1_produce(a, row0, np, P, C, buf.data(), k, rk, tfast, 0, 1);
      for (int g = 0; g < np && k > 0; ++g) d1_chain(a, P, C, buf.data(), k - 1, g, acc[g]);
    }
    Best b = none();
    for (int g = 0; g < np; ++g) {
      const RowIn in = d1_row_in(a, row0 + g);
      const DD r = d1_finish(a, in, acc[g]);
      out[row0 + g] = r.hi;
      out[B + row0 + g] = r.lo;
      keep(b, best_of_row(in, row0 + g, r));
    }
    keep(q, b);
  }
  double* res = reinterpret_cast<double*>(words);
  words[0] = q.idx;
  res[1] = q.score;
  res[2] = q.hi;
  res[3] = q.lo;
  return 0;
}

#endif  // __CUDACC__

// D1's launch for a shape (score_plan): plan[0..4] = P, C, threads, blocks,
// shared bytes.  Returns 0, or -1 for a shape the entry point refuses.
int ttd_dd_score_plan(long long B, int T, long long* plan) {
  if (!score_shape_ok(B, T, 0)) return -1;
  const ScorePlan p = score_plan(B, T);
  const long long v[5] = {p.P, p.C, p.threads, p.blocks, p.smem};
  for (int k = 0; k < 5; ++k) plan[k] = v[k];
  return 0;
}

}  // extern "C"
