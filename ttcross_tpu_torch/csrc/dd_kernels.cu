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
// D1's, D2's, D3's and D4's own functions in one host thread: a whole call
// block after block, each stage's items in turn, the stages in the kernel's
// order, in any plan; and ttd_dd_score_plan, ttd_dd_dot_plan,
// ttd_dd_gather_plan and ttd_dd_ising_plan, their launch rules.  The CPU tests hold that
// arithmetic and its bookkeeping to the plain version where there is no
// card.
//
// What bounds them.  A dd multiply is 24 flops (two_prod 17, its cross
// terms 4, quick_two_sum 3), a dd add 11 (two_sum 6, two adds,
// quick_two_sum 3); none of them runs on the f64 tensor cores, so the card's
// rate for them is its f64 vector rate (33.5 TFLOP/s on the H100 SXM).
// Their shapes are small (a few thousand rows of R <= 64 terms), so the
// rate is far off; what a call waits on is a chain of dependent operations
// and loads.  D1's, D3's and D4's sums are ops/dd.py::dd_sum's scan, left to
// right from (0, 0) (the JAX package's lax.scan, on which the dd engine's
// pivot-for-pivot parity rests), so none can become a tree: one sum's
// critical path is T dependent dd_adds (8 dependent f64 adds each).  D1, D3
// and D4 therefore move the products and their loads off the adding thread
// (chain lanes that only add, from shared memory) and spread the rows over
// the card (below); D2's three scans per row are independent, and run side
// by side (ising_rows.cuh).

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

#include "ising_rows.cuh"   // D2's body, launch, plan and host emulation, shared with Q1

namespace {

constexpr double kSplit = 134217729.0;  // 2^27 + 1, Dekker's constant for binary64
constexpr int kThreads = 256;           // a block of D1, D3 and D4 at most
constexpr int kGatherRMax = 64;         // D3: ranks up to this
constexpr int kChainLanes = 32;         // D1, D4 chain: rows of a block at most (a warp's lanes)
constexpr int kItems = 4;               // D1, D4: products a producer loads before it multiplies
constexpr int kSMs = 132;               // the H100 SXM's SMs: D3 and D4 spread over them
constexpr int kGatherGroup = 8;         // D3: products a lane forms before it adds them
constexpr long long kDotChainMax = 16384;     // D4: the chain below this many outputs
constexpr int kDotChainTMin = 8;        // D4: the chain from this many terms
constexpr int kDotBlocks = 3 * kSMs;    // D4 chain: blocks that fill the card (three an SM)
constexpr int kDotChunk = 28;           // D4 chain: terms of a chunk at most
constexpr int kSmemMax = 227 * 1024;    // shared memory one block may use

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
// The chain body of D1 and D4: a block of P <= 32 rows (D1's rows, D4's
// outputs), each the sum of T products from (0, 0) by dd_add in order
// (ops/dd.py::dd_sum's scan).
//
// Row b's term t is x[b, t] y[b, t] with x and y strided views (D1's
// ScoreArgs; D4's DotArgs: row b is output element (i, j) = (b / N, b % N)).
// The rank mask m_t = (t < rank) multiplies x (mask_side 1) or y (mask_side
// 2), as the JAX engine's does (D1 only).
//
// Bound.  A row's critical path is its T dependent dd_adds (the scan may
// not become a tree), each 8 dependent f64 adds from the running sum's hi
// part to the next one's: ~0.04 us a term on an H100.  A thread that loads
// its own terms waits on four scattered loads per term before its dd_mul
// and dd_add (0.24-0.5 us a term measured with a thread per row or output:
// the loads' latency, not the adds'), and few rows leave most SMs idle.
//
// Design.  Warp 0 is the chain warp: lane g holds row g's sum and adds its
// terms in order from shared memory.  The block's other warps (the
// producers) load the next chunk of C terms of x and y and compute its
// dd_mul products (rank mask included) into the other half of a double
// buffer, one barrier a chunk; each producer issues the loads of up to
// kItems products before it multiplies any, so a chunk costs about one load
// latency however long it is.  D4's rows' operand offsets are computed once,
// by their chain lanes, into a table in shared memory.  The producers walk t
// fastest where an operand is contiguous along t and not broadcast over the
// rows (the lottery's and the column pass's gathered rows), the rows
// fastest where the only operand contiguous along the rows is (the row
// pass's transposed rowf_t, D4's GEMM factor B and value_mat's permuted
// core), so neighbouring threads read neighbouring words; a broadcast
// operand (stride 0 along the rows) comes from the L2 once per block and
// from L1 after.  The plan (score_plan) is a function of the shape alone:
// every row in one block up to 32 rows, else P rows a block so that a small
// B still spreads over the card.
// ---------------------------------------------------------------------------

// D1's rows: row b's term t at b xsb + t xst of x (y alike).
struct ScoreArgs {
  const double *vh, *vl, *xh, *xl, *yh, *yl;
  long long B;   // rows
  int T;
  long long xsb, xst, ysb, yst;
  const int32_t* rank;
  int mask_side;
  const uint8_t* mask;
};

// D4's outputs as the chain body's rows: row b is output element (i, j) =
// (b / N, b % N), its term t at i xsb + j xs1 + t xst of x (y alike).
struct DotArgs : ScoreArgs {
  long long N, xs1, ys1;
};

TTD_FN int rank_of(const ScoreArgs& a) { return a.rank != nullptr ? TTD_LD(a.rank) : a.T; }

// The operand offsets of D4's rows row0 .. row0 + np - 1: x's at off[g],
// y's at off[kChainLanes + g].
TTD_FN void row_offsets(const DotArgs& a, long long row0, int np, long long* off, int tid,
                        int nth) {
  for (int g = tid; g < np; g += nth) {
    const long long b = row0 + g, i = b / a.N, j = b - i * a.N;
    off[g] = i * a.xsb + j * a.xs1;
    off[kChainLanes + g] = i * a.ysb + j * a.ys1;
  }
}

// Term t of the block's row g: its offsets from the table (kTable, D4) or
// from its index row0 + g (D1).
template <bool kTable>
TTD_FN void d1_load(const ScoreArgs& a, const long long* off, long long row0, int g, int t, DD& x,
                    DD& y) {
  const long long xb = kTable ? off[g] : (row0 + g) * a.xsb;
  const long long yb = kTable ? off[kChainLanes + g] : (row0 + g) * a.ysb;
  const long long xo = xb + (long long)t * a.xst, yo = yb + (long long)t * a.yst;
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

// Whether the producers walk t fastest (else the rows): see the design note.
TTD_FN bool walk_terms(long long xsb, long long xst, long long ysb, long long yst) {
  const bool xt = xsb != 0 && xst == 1, yt = ysb != 0 && yst == 1;
  return xt || yt || !(xsb == 1 || ysb == 1);
}

TTD_FN bool terms_fastest(const ScoreArgs& a) { return walk_terms(a.xsb, a.xst, a.ysb, a.yst); }

// D4's rows run along j where N > 1, along i otherwise.
TTD_FN bool terms_fastest(const DotArgs& a) {
  return a.N > 1 ? walk_terms(a.xs1, a.xst, a.ys1, a.yst) : walk_terms(a.xsb, a.xst, a.ysb, a.yst);
}

// The stages.  Chunk k holds terms kC .. kC + len - 1 of the block's np rows
// in half k & 1 of the double buffer: term c of row g at half + g W + c (hi)
// and half + P W + g W + c (lo), W = C | 1 an odd pitch (a walk along c or
// along g, and the chain lanes' reads along g, hit distinct banks), half =
// (k & 1) 2 P W.
TTD_HD int pitch(int C) { return C | 1; }

template <bool kTable>
TTD_FN void d1_produce(const ScoreArgs& a, const long long* off, long long row0, int np, int P,
                       int C, double* buf, int k, int rk, bool tfast, int tid, int nth) {
  const int t0 = k * C, len = a.T - t0 < C ? a.T - t0 : C, W = pitch(C);
  const int half = (k & 1) * 2 * P * W, n = np * len;
  for (int base = tid; base < n; base += kItems * nth) {
    DD x[kItems], y[kItems];
    TTD_UNROLL
    for (int u = 0; u < kItems; ++u) {   // every load first: in flight together
      const int it = base + u * nth;
      if (it < n) {
        const int g = tfast ? it / len : it % np, c = tfast ? it - g * len : it / np;
        d1_load<kTable>(a, off, row0, g, t0 + c, x[u], y[u]);
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

// ---------------------------------------------------------------------------
// D4: a small dd GEMM with strides.  out[i, j] = sum_t x[i, j, t] y[i, j, t]
// (t = 0..T-1 in order from (0, 0)), out (M, N) contiguous, x and y any
// strided views (a GEMM A @ B is x = A broadcast over j, y = B broadcast
// over i).  It serves the dd engine's _mm_left / _mm_right, value_mat and
// finalize (ttcross_tpu/cross/engine_dd.py:135-147, :443-504), its dd
// quadrature and the dd contraction (ops/dd.py::dd_contract).  Bound:
// operations, M N T dd multiply-adds; but an output's critical path is its
// T dependent dd_adds, as D1's row's.  Two kernels, the regime a function of
// the shape (dot_plan): the chain body above with D4's store for an
// epilogue (outputs are its rows: N, s0 = i's strides, s1 = j's), and a
// thread per output for many outputs or few terms.
// ---------------------------------------------------------------------------

DotArgs dot_args(const double* xh, const double* xl, const double* yh, const double* yl,
                 long long M, long long N, int T, long long xs0, long long xs1, long long xs2,
                 long long ys0, long long ys1, long long ys2) {
  return DotArgs{{nullptr, nullptr, xh, xl, yh, yl, M * N, T, xs0, xs2, ys0, ys2, nullptr, 0,
                  nullptr},
                 N, xs1, ys1};
}

// The thread regime's output at offsets xo of x and yo of y: its T
// products and sum in one thread.
TTD_FN DD d4_out(const double* __restrict__ xh, const double* __restrict__ xl,
                 const double* __restrict__ yh, const double* __restrict__ yl, long long xo,
                 long long yo, int T, long long xs2, long long ys2) {
  DD acc{0.0, 0.0};
  for (int t = 0; t < T; ++t) {
    acc = dd_add(acc, dd_mul(DD{xh[xo + t * xs2], xl[xo + t * xs2]},
                             DD{yh[yo + t * ys2], yl[yo + t * ys2]}));
  }
  return acc;
}

enum { kDotThread = 0, kDotChain = 1 };
struct DotPlan {
  int regime, P, C, threads;
  long long blocks, smem;
};

// regime kDotChain: score_plan_of's P outputs a block in chunks of C terms;
// kDotThread: P threads (outputs) a block.
DotPlan dot_plan_of(long long E, int regime, int P, int C) {
  if (regime == kDotChain) {     // the chunks' buffer and the offsets' table
    const ScorePlan s = score_plan_of(E, P, C);
    return DotPlan{kDotChain, s.P, s.C, s.threads, s.blocks, s.smem + 16LL * kChainLanes};
  }
  return DotPlan{regime, P, 0, P, (E + P - 1) / (P < 1 ? 1 : P), 0};
}

// The threads' block, 256, 128 or 64: the one that puts the fewest outputs
// on the busiest SM, the larger on a tie (Q4's rule; (3120, 48, 48) 27.8 us
// in blocks of 128 against 29.8 in 256, (48, 2080, 48) 20.7 in 256 against
// 22.9).
int thread_block(long long E) {
  int best = kThreads;
  long long load = 0;
  for (int b = kThreads; b >= 64; b /= 2) {
    const long long blocks = (E + b - 1) / b, l = (blocks + kSMs - 1) / kSMs * b;
    if (load == 0 || l < load) {
      best = b;
      load = l;
    }
  }
  return best;
}

// The rule, measured on an H100 (chip_smoke.py --qd-regimes times both
// regimes at the dd paths' shapes and over output and term counts;
// PERF.md): the chain below kDotChainMax outputs and from kDotChainTMin
// terms, a thread per output otherwise (T = 48: 10.4 against 14.7 us at
// 12,480 outputs, 17.7 against 15.1 at 24,960; T = 16: 5.8 against 6.9 at
// 8,320, 10.2 against 7.1 at 24,960; (48, 65, T): the thread 3.8 against
// 4.0 at T = 4, the chain 4.3 against 4.8 at T = 8).  The chain's outputs a
// block: the fewest, from 4, a power of two, that leave at most kDotBlocks
// blocks ((48, 65, 48) 6.8 us at 8 against 7.7 at 16; (1, 48, 48) 5.7 at 4
// against 6.2 at 8; (48, 260, 48) 10.4 at 32 against 13.5 at 16); chunks of
// kDotChunk terms, at most T.
DotPlan dot_plan(long long M, long long N, int T) {
  const long long E = M * N;
  if (E >= kDotChainMax || T < kDotChainTMin) return dot_plan_of(E, kDotThread, thread_block(E), 0);
  long long P = 4;
  while (P < kChainLanes && E > P * kDotBlocks) P *= 2;
  return dot_plan_of(E, kDotChain, (int)(P < E ? P : E), T < kDotChunk ? T : kDotChunk);
}

bool dot_shape_ok(long long M, long long N, int T) { return M >= 1 && N >= 1 && T >= 0; }

bool dot_plan_ok(const DotPlan& p) {
  if (p.regime == kDotChain) return score_plan_ok(ScorePlan{p.P, p.C, p.threads, p.blocks, p.smem});
  return p.regime == kDotThread && p.P >= 32 && p.P <= kThreads && p.P % 32 == 0 &&
         p.blocks <= INT_MAX;
}

// ---------------------------------------------------------------------------
// D3: dd_gather_tt, an f64 train evaluated at (B, d) indices with dd
// accumulation (ttcross_tpu/ops/dd.py:319-335): v = (1), then per core c
// v'[j] = sum_t v[t] * (G_c[t, i_c, j], 0) for t < r_c in order from (0, 0)
// (dd_sum's scan), j < r_{c+1}; the result v[0].  The defect integrand's
// whole cost (cross/defect.py): at C_6 level 2, ranks (1, 16, 32, 32, 16,
// 1), 2,080 dd multiply-adds a row.  The cores come packed, (d, R, N, R)
// zero-padded, with the ranks on the device; an index outside [0, N) is
// clamped.
//
// Bound: operations, B sum_c r_c r_{c+1} dd multiply-adds (35 flops of f64
// adds and multiplies, none an FMA, so the f64 pipes give half the FMA rate
// the bound counts: 14.7 us at (3120, 5) at 1.83 GHz against the bound's
// 6.8).  A row's critical path is sum_c r_c dependent dd_adds (97 at C_6),
// and a thread that loads G itself inside its sum waits on the load each
// term (0.27 us a term measured).
//
// Design.  A block holds P rows and P W lanes (W: R rounded up to a power of
// two, at most 32).  At core c a row takes row_lanes(r_{c+1}) of them (a
// lane takes columns j and j + 32 where r_{c+1} > 32), so a core of few
// columns packs several rows into a warp and the warps it leaves idle skip
// it instead of issuing at a fraction of their lanes.  Lane (b, j) walks its
// column's terms a group of kG at a time (gather_group: kGatherGroup, or 1
// below that rank): it issues the loads of the next group's G values
// before it forms the current group's products (the full dd_mul(v_b[t],
// (G, 0)) of the plain version, v from shared memory; independent of the
// sum, so they overlap the adds) and adds them to its sum in order, so no
// add waits on a load; its first group of the next core is loaded during
// this one, from the ranks and the rows' indices that the block reads into
// shared memory once.  It writes v'_b[j] into the other half of v's double
// buffer; one barrier a core.  At the last core lane (b, 0) writes the
// row's value.  Shared memory: v (4 R doubles a row), the ranks and the
// indices, so every row of the defect's batches is resident at once.
//
// Designs that lost on an H100 (timed in turns against this kernel by a
// harness kept in the history at commit 90d94cb, tools/d3_variants.*;
// PERF.md), at (3120, 5) / (226, 5) against this
// kernel's 30.6 / 12.4 us: each product on its own producer thread into
// shared memory and a chain lane per column adding them, the rows' slices
// staged by cp.async a core ahead, 100-106 / 30-37; the same reading G
// from global memory, 61-65 / 35-40; the core's products formed by every
// thread, then added by the lanes, 79-111 / 15-21; the products on the
// lanes from staged slices, 54-64 / 20-23; the earlier kernel, a thread
// per column loading G inside its sum, 31.1 / 17.2 with its rows a block
// spread over the SMs.
// ---------------------------------------------------------------------------

struct GatherArgs {
  const double* cores;
  const int32_t* ranks;
  int d, R, N;
  const int32_t* ind;
  long long B;
};

TTD_HD int log2_up(int v) {   // the least l with 2^l >= v
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

TTD_HD int row_lanes(int R) { return R >= 32 ? 32 : 1 << log2_up(R); }

TTD_HD int chain_warps(int P, int R) { return (P * row_lanes(R) + 31) / 32; }

// Shared memory of P rows: v hi and lo [2][P][R] each, then the ranks (d +
// 1) and the rows' clamped indices [P][d] as ints.
TTD_HD long long gather_smem(int P, int R, int d) {
  return 32LL * P * R + (4LL * (d + 1 + (long long)P * d) + 7) / 8 * 8;
}

struct GatherSmem {
  double *vh, *vl;
  int *rk, *ix;
};

TTD_FN GatherSmem gather_smem_of(double* base, int P, int R, int d) {
  int* ints = reinterpret_cast<int*>(base + 4 * P * R);
  return GatherSmem{base, base + 2 * P * R, ints, ints + d + 1};
}

// The ranks and the np rows' indices into shared memory, by threads tid of
// nth; an index outside [0, N) clamped.
TTD_FN void d3_load(const GatherArgs& a, const GatherSmem& s, long long row0, int np, int tid,
                    int nth) {
  for (int k = tid; k <= a.d; k += nth) s.rk[k] = TTD_LD(a.ranks + k);
  for (int k = tid; k < np * a.d; k += nth) {
    const int i = TTD_LD(a.ind + row0 * a.d + k);
    s.ix[k] = i < 0 ? 0 : (i >= a.N ? a.N - 1 : i);
  }
}

// The block's row that lane L takes at a core of output rank r2.
TTD_HD int lane_row(int L, int r2) { return L >> log2_up(row_lanes(r2)); }

// Lane L's first group of values at core c (ranks r, r2): G_c[t, i_b, j0]
// for t < kG (clamped to t < r), its row b and column j0 there; nothing for
// a lane idle at core c.
template <int kG>
TTD_FN void d3_first(const GatherArgs& a, const GatherSmem& s, int np, int c, int r, int r2, int L,
                     double* first) {
  const int W = row_lanes(r2), b = L >> log2_up(W), j0 = L & (W - 1);
  if (b >= np || j0 >= r2 || r < 1) return;
  const long long step = (long long)a.N * a.R;
  const double* col = a.cores + (long long)c * a.R * step + (long long)s.ix[b * a.d + c] * a.R + j0;
  TTD_UNROLL
  for (int u = 0; u < kG; ++u) first[u] = TTD_LD(col + (u < r ? u : r - 1) * step);
}

// Lane L = (b, j0)'s columns j0 and j0 + 32 of core c (ranks r, r2; a row
// has row_lanes(r2) lanes at this core, so the core's work fills the first
// warps and the others skip it): sum_t dd_mul(v_b[t], (G_c[t, i_b, j], 0))
// from (0, 0) in order, v_b from half c & 1 of v, into half (c + 1) & 1 (at
// the last core, column 0 to the output).  first: column j0's first group,
// loaded a core ahead; on return, the lane's first group at core c + 1 (of
// output rank r3), in flight during this core.  kG: the terms of a group.
template <int kG>
TTD_FN void d3_lane(const GatherArgs& a, const GatherSmem& s, long long row0, int np, int P, int c,
                    int r, int r2, int r3, int L, double* first, double* oh, double* ol) {
  const int R = a.R, W = row_lanes(r2), lw = log2_up(W);
  const int b = L >> lw, j0 = L & (W - 1);
  double next[kG];
  TTD_UNROLL
  for (int u = 0; u < kG; ++u) next[u] = first[u];
  if (c + 1 < a.d) d3_first<kG>(a, s, np, c + 1, r2, r3, L, first);
  if (b >= np) return;
  const int vin = (c & 1) * P * R + b * R, vout = ((c + 1) & 1) * P * R + b * R;
  const long long step = (long long)a.N * R;   // G_c[t + 1, i, j] - G_c[t, i, j]
  const double* row = a.cores + (long long)c * R * step + (long long)s.ix[b * a.d + c] * R;
  for (int j = j0; j < r2; j += W) {
    const double* col = row + j;
    if (j != j0) {   // the second column (r2 > 32): its first group now
      TTD_UNROLL
      for (int u = 0; u < kG; ++u) next[u] = TTD_LD(col + (u < r ? u : r - 1) * step);
    }
    DD acc{0.0, 0.0};
    int t = 0;
    for (; t + kG <= r; t += kG) {   // straight-line groups
      double g[kG];
      TTD_UNROLL
      for (int u = 0; u < kG; ++u) {   // this group's values; the next group's loads
        g[u] = next[u];
        const int tn = t + kG + u;
        next[u] = TTD_LD(col + (tn < r ? tn : r - 1) * step);   // clamped: no load conditional
      }
      DD p[kG];
      TTD_UNROLL
      for (int u = 0; u < kG; ++u) {
        p[u] = dd_mul(DD{s.vh[vin + t + u], s.vl[vin + t + u]}, DD{g[u], 0.0});
      }
      TTD_UNROLL
      for (int u = 0; u < kG; ++u) acc = dd_add(acc, p[u]);
    }
    TTD_UNROLL
    for (int u = 0; u < kG - 1; ++u) {   // the last r mod kG terms
      if (t + u < r) {
        acc = dd_add(acc, dd_mul(DD{s.vh[vin + t + u], s.vl[vin + t + u]}, DD{next[u], 0.0}));
      }
    }
    if (c == a.d - 1 && j == 0) {
      oh[row0 + b] = acc.hi;
      ol[row0 + b] = acc.lo;
    } else {
      s.vh[vout + j] = acc.hi;
      s.vl[vout + j] = acc.lo;
    }
  }
}

TTD_FN void d3_init(const GatherSmem& s, int np, int R, int tid, int nth) {
  for (int b = tid; b < np; b += nth) {
    s.vh[b * R] = 1.0;
    s.vl[b * R] = 0.0;
  }
}

// Launch of one shape: P rows a block, `threads` threads (the rows' lanes,
// or more: those idle).
struct GatherPlan {
  int P, threads;
  long long blocks, smem;
};

GatherPlan gather_plan_of(long long B, int R, int d, int P, int threads) {
  return GatherPlan{P, threads, (B + P - 1) / (P < 1 ? 1 : P), gather_smem(P, R, d)};
}

// The rule, measured on an H100 (chip_smoke.py --qd-regimes times D3 in
// every plan at the defect's shapes; PERF.md): rows a block to spread B
// over the SMs, no more than a block's kThreads lanes hold; threads: the
// rows' lanes.
GatherPlan gather_plan(long long B, int R, int d) {
  long long P = (B + kSMs - 1) / kSMs;
  const long long lanes = kThreads / row_lanes(R);
  if (P > lanes) P = lanes;
  if (P < 1) P = 1;
  return gather_plan_of(B, R, d, (int)P, 32 * chain_warps((int)P, R));
}

bool gather_shape_ok(long long B, int d, int R, int N) {
  return B >= 1 && d >= 1 && R >= 1 && R <= kGatherRMax && N >= 1;
}

bool gather_plan_ok(const GatherPlan& p, int R) {
  return p.P >= 1 && p.threads <= kThreads && p.threads % 32 == 0 &&
         p.threads >= 32 * chain_warps(p.P, R) && p.blocks <= INT_MAX && p.smem <= kSmemMax;
}

// The terms of a lane's group at packed rank R (the kernel's kG): groups of
// kGatherGroup from that rank, single terms below it, where a group would
// only repeat its clamped loads (the harness above, on an H100: the
// rank-1 train at (390, 4) 5.5 us in single terms against 6.2 in groups of
// 8; the defect's rank-32 train at (226, 5) 12.4 in groups of 8, 16.1 in
// groups of 4, 24.2 in single terms).
TTD_HD int gather_group(int R) { return R < kGatherGroup ? 1 : kGatherGroup; }

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

// The chain body: the block's rows row0 .. row0 + np - 1; lanes 0..np-1 of
// warp 0 each add their row's terms in order from one half of the double
// buffer while warps 1.. compute the next chunk into the other half; one
// barrier a chunk.  Returns row tid's sum in lanes tid < np.  kTable: the
// rows' offsets from a table `off` the chain lanes fill first (D4; D1's, N =
// 1, need none).  rk, tfast: rank_of(a), terms_fastest(a).
template <bool kTable, typename Args>
__device__ __forceinline__ DD chain_sum(const Args& a, long long row0, int np, int P, int C,
                                        double* dsm, long long* off, int rk, bool tfast) {
  const int tid = threadIdx.x;
  if constexpr (kTable) {
    if (tid < kChainLanes) row_offsets(a, row0, np, off, tid, kChainLanes);
  }
  const int nch = (a.T + C - 1) / C;
  if (kTable) __syncthreads();
  DD acc{0.0, 0.0};
  for (int k = 0; k <= nch; ++k) {
    if (tid >= kChainLanes) {
      if (k < nch) {
        d1_produce<kTable>(a, off, row0, np, P, C, dsm, k, rk, tfast, tid - kChainLanes,
                           blockDim.x - kChainLanes);
      }
    } else if (tid < np && k > 0) {
      d1_chain(a, P, C, dsm, k - 1, tid, acc);
    }
    __syncthreads();
  }
  return acc;
}

// D1: the chain body, then each row's residual, the block's best and the
// grid's argmax.
__global__ void __launch_bounds__(kThreads)
dd_score_kernel(ScoreArgs a, int P, int C, double* __restrict__ out,
                long long* __restrict__ words) {
  extern __shared__ double dsm[];
  const long long row0 = (long long)blockIdx.x * P;
  const int np = (int)(a.B - row0 < P ? a.B - row0 : P), tid = threadIdx.x;
  const int rk = rank_of(a);
  const bool tfast = terms_fastest(a);
  const RowIn in = tid < np ? d1_row_in(a, row0 + tid) : RowIn{DD{0.0, 0.0}, false};
  const DD acc = chain_sum<false>(a, row0, np, P, C, dsm, nullptr, rk, tfast);
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

// D4, kDotChain: the chain body, each output stored by its chain lane; the
// outputs' offsets in a table after the chunks' buffer.
__global__ void __launch_bounds__(kThreads)
dd_dot_chain_kernel(DotArgs a, int P, int C, double* __restrict__ oh, double* __restrict__ ol) {
  extern __shared__ double dsm[];
  const long long o0 = (long long)blockIdx.x * P;
  const int np = (int)(a.B - o0 < P ? a.B - o0 : P), tid = threadIdx.x;
  long long* off = reinterpret_cast<long long*>(dsm + 4 * P * pitch(C));   // after the chunks
  const DD acc = chain_sum<true>(a, o0, np, P, C, dsm, off, rank_of(a), terms_fastest(a));
  if (tid < np) {
    oh[o0 + tid] = acc.hi;
    ol[o0 + tid] = acc.lo;
  }
}

// D4, kDotThread: a thread per output (its __restrict__ arguments let nvcc
// read x and y through the read-only path).
__global__ void __launch_bounds__(kThreads)
dd_dot_kernel(const double* __restrict__ xh, const double* __restrict__ xl,
              const double* __restrict__ yh, const double* __restrict__ yl, long long M,
              long long N, int T, long long xs0, long long xs1, long long xs2, long long ys0,
              long long ys1, long long ys2, double* __restrict__ oh, double* __restrict__ ol) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M * N) return;
  const long long i = e / N, j = e % N;
  const DD acc = d4_out(xh, xl, yh, yl, i * xs0 + j * xs1, i * ys0 + j * ys1, T, xs2, ys2);
  oh[e] = acc.hi;
  ol[e] = acc.lo;
}

// D3: the block's P rows through the cores (see above), in groups of kG
// terms.
template <int kG>
__global__ void __launch_bounds__(kThreads)
dd_gather_tt_kernel(GatherArgs a, int P, double* __restrict__ oh, double* __restrict__ ol) {
  extern __shared__ double dsm[];
  const long long row0 = (long long)blockIdx.x * P;
  const int np = (int)(a.B - row0 < P ? a.B - row0 : P), tid = threadIdx.x;
  const GatherSmem s = gather_smem_of(dsm, P, a.R, a.d);
  d3_load(a, s, row0, np, tid, blockDim.x);
  d3_init(s, np, a.R, tid, blockDim.x);
  __syncthreads();
  int r = s.rk[0], r2 = s.rk[1];
  double first[kG];
  d3_first<kG>(a, s, np, 0, r, r2, tid, first);
  for (int c = 0; c < a.d; ++c) {
    const int r3 = c + 1 < a.d ? s.rk[c + 2] : 0;
    if (c > 0) __syncthreads();   // v of core c complete
    d3_lane<kG>(a, s, row0, np, P, c, r, r2, r3, tid, first, oh, ol);
    r = r2;
    r2 = r3;
  }
}

// ---------------------------------------------------------------------------
// D2: the C-kind Ising integrand in dd, fused with its node / weight lookup
// (the dd variant of small_table_lookup_limbs, ttcross_tpu/ops/
// pallas_kernels.py:151, on the integrand of ttcross_tpu/apps/ising.py:
// 172-210): f = 2 / (v w) prod_i W_i with w = 1 + sum_k prod_{i<=k} x_i and
// v the same over the reversed row, each a scan of dd_mul / dd_add, then
// dd_div, then the weight product, in that file's order.  Any d; the (4, n)
// table (node hi, node lo, weight hi, weight lo) and the block's rows'
// indices staged in shared memory in one cp.async round trip.  An index
// outside [0, n) is clamped, as JAX's gather clamps.  Bound: operations,
// ~4d + 20 dd operations per row; but a dd operation is a short chain of
// dependent f64 operations, so a row's time is its critical path: the
// three scans are independent, and run on three lanes of one warp
// (ising_rows.cuh): the path is one scan and the tail.
// ---------------------------------------------------------------------------
#endif  // __CUDACC__

TTD_FN DD d2_at(const double* t, int n, int i) { return DD{t[i], t[n + i]}; }

// D2's row (ising_rows.cuh): the (4, n) table, hi and lo out.
struct D2Row {
  using T = DD;
  static constexpr int kTab = 4;

  // The lane of role `role`: 0 the forward scan's w, 1 the backward scan's
  // v, 2 the weight product, each from one in the plain version's order and
  // operand order (dd_mul(pk, x), dd_add(s, pk)); one loop for every role,
  // the weight lane's sum computed with the others' and dropped.  ri: the
  // row's d indices.
  static TTR_DEV DD lane(const double* tab, int n, const int32_t* ri, int d, int role) {
    const double* t = tab + (role == 2 ? 2 * n : 0);
    const DD one{1.0, 0.0};
    DD pk = one, s = one;
    for (int k = 0; k < d; ++k) {
      pk = dd_mul(pk, d2_at(t, n, clamp_index(ri[role == 1 ? d - 1 - k : k], n)));
      s = dd_add(s, pk);
    }
    return role == 2 ? pk : s;
  }

  static TTR_DEV DD tail(DD v, DD w, DD pw) {
    return dd_mul(dd_div(DD{2.0, 0.0}, dd_mul(v, w)), pw);
  }

  static TTR_DEV void store(const RowsOut& o, long long row, const DD& f) {
    o.p[0][row] = f.hi;
    o.p[1][row] = f.lo;
  }

#if defined(__CUDACC__)
  static __device__ __forceinline__ DD shfl(const DD& x, int src) {
    return DD{__shfl_sync(0xffffffffu, x.hi, src), __shfl_sync(0xffffffffu, x.lo, src)};
  }
#endif
};

#if defined(__CUDACC__)
__global__ void __launch_bounds__(kRowsThreads)
ising_c_dd_kernel(const double* __restrict__ tables, int n, const int32_t* __restrict__ ind,
                  long long B, int d, int P, RowsOut out) {
  extern __shared__ __align__(16) unsigned char d2sm[];
  rows_body<D2Row>(d2sm, tables, n, ind, B, d, P, out);
}

template <int kG>
cudaError_t gather_launch(const GatherArgs& a, const GatherPlan& p, double* oh, double* ol,
                          cudaStream_t st) {
  allow_smem(dd_gather_tt_kernel<kG>, p.smem);
  dd_gather_tt_kernel<kG><<<(unsigned)p.blocks, p.threads, p.smem, st>>>(a, p.P, oh, ol);
  return cudaGetLastError();
}

#else
// The chain body's block on the host: each chunk's products, then each chain
// lane's adds, in the kernel's order.  acc: np sums.
template <bool kTable, typename Args>
void host_chain_sum(const Args& a, long long row0, int np, int P, int C, double* buf, DD* acc) {
  long long off[2 * kChainLanes];
  if constexpr (kTable) row_offsets(a, row0, np, off, 0, 1);
  const int rk = rank_of(a);
  const bool tfast = terms_fastest(a);
  const int nch = (a.T + C - 1) / C;
  for (int g = 0; g < np; ++g) acc[g] = DD{0.0, 0.0};
  for (int k = 0; k <= nch; ++k) {
    if (k < nch) d1_produce<kTable>(a, off, row0, np, P, C, buf, k, rk, tfast, 0, 1);
    for (int g = 0; g < np && k > 0; ++g) d1_chain(a, P, C, buf, k - 1, g, acc[g]);
  }
}

// D3's call in plan p with groups of kG terms on the host: block after
// block, core after core, each lane's sums in turn.
template <int kG>
void host_d3(const GatherArgs& a, const GatherPlan& p, double* oh, double* ol) {
  std::vector<double> buf(p.smem / 8);
  const GatherSmem s = gather_smem_of(buf.data(), p.P, a.R, a.d);
  std::vector<double> first((size_t)p.threads * kG);
  for (long long row0 = 0; row0 < a.B; row0 += p.P) {
    const int np = (int)(a.B - row0 < p.P ? a.B - row0 : p.P);
    d3_load(a, s, row0, np, 0, 1);
    d3_init(s, np, a.R, 0, 1);
    for (int tid = 0; tid < p.threads; ++tid) {
      d3_first<kG>(a, s, np, 0, s.rk[0], s.rk[1], tid, &first[tid * kG]);
    }
    for (int c = 0; c < a.d; ++c) {
      const int r3 = c + 1 < a.d ? s.rk[c + 2] : 0;
      for (int tid = 0; tid < p.threads; ++tid) {
        d3_lane<kG>(a, s, row0, np, p.P, c, s.rk[c], s.rk[c + 1], r3, tid, &first[tid * kG], oh,
                    ol);
      }
    }
  }
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
  allow_smem(dd_score_kernel, p.smem);
  dd_score_kernel<<<(unsigned)p.blocks, p.threads, p.smem, st>>>(
      score_args(vh, vl, xh, xl, yh, yl, B, T, xsb, xst, ysb, yst, rank, mask_side, mask), p.P,
      p.C, out, words);
  return static_cast<int>(cudaGetLastError());
}

// D4 in the regime (regime, P, C): kDotChain (0 < P <= 32 outputs a block,
// chunks of C terms) or kDotThread (P threads a block, C unused), as
// ttd_dd_dot_plan gives it the shape or as the caller names it.  out (M, N)
// contiguous, hi and lo; strides in elements (any, 0 too).
int ttd_dot(const double* xh, const double* xl, const double* yh, const double* yl, long long M,
            long long N, int T, long long xs0, long long xs1, long long xs2, long long ys0,
            long long ys1, long long ys2, int regime, int P, int C, double* oh, double* ol,
            void* stream) {
  if (!dot_shape_ok(M, N, T)) return static_cast<int>(cudaErrorInvalidValue);
  const DotPlan p = dot_plan_of(M * N, regime, P, C);
  if (!dot_plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  const DotArgs a = dot_args(xh, xl, yh, yl, M, N, T, xs0, xs1, xs2, ys0, ys1, ys2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.regime == kDotChain) {
    allow_smem(dd_dot_chain_kernel, p.smem);
    dd_dot_chain_kernel<<<(unsigned)p.blocks, p.threads, p.smem, st>>>(a, p.P, p.C, oh, ol);
  } else {
    dd_dot_kernel<<<(unsigned)p.blocks, p.threads, 0, st>>>(xh, xl, yh, yl, M, N, T, xs0, xs1,
                                                            xs2, ys0, ys1, ys2, oh, ol);
  }
  return static_cast<int>(cudaGetLastError());
}

// D3 with P rows and `threads` threads a block, as ttd_dd_gather_plan gives
// them the shape or as the caller names them.  cores (d, R, N, R) f64
// contiguous, ranks d + 1 int32 on the device (every rank <= R <=
// kGatherRMax), ind (B, d) int32.
int ttd_gather_tt(const double* cores, const int32_t* ranks, int d, int R, int N,
                  const int32_t* ind, long long B, int P, int threads, double* oh, double* ol,
                  void* stream) {
  const GatherPlan p = gather_plan_of(B, R, d, P, threads);
  if (!gather_shape_ok(B, d, R, N) || !gather_plan_ok(p, R)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GatherArgs a{cores, ranks, d, R, N, ind, B};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(gather_group(R) == 1 ? gather_launch<1>(a, p, oh, ol, st)
                                               : gather_launch<kGatherGroup>(a, p, oh, ol, st));
}

// D2 with P rows a block, as ttd_dd_ising_plan gives them the shape or as
// the caller names them.  tables (4, n) f64: node hi, node lo, weight hi,
// weight lo; ind (B, d) int32, d >= 1.
int ttd_ising_c_integrand(const double* tables, int n, const int32_t* ind, long long B, int d,
                          int P, double* oh, double* ol, void* stream) {
  return rows_launch<D2Row>(ising_c_dd_kernel, tables, n, ind, B, d, P,
                            RowsOut{{oh, ol, nullptr, nullptr}}, stream);
}

int ttd_threads(void) { return kThreads; }

int ttd_gather_rmax(void) { return kGatherRMax; }

#else   // the host emulation: D1's, D2's, D3's and D4's functions in one host thread

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
  std::vector<double> buf(p.smem / 8);
  DD acc[kChainLanes];
  Best q = none();     // the blocks' best, in block order
  for (long long row0 = 0; row0 < B; row0 += P) {
    const int np = (int)(B - row0 < P ? B - row0 : P);
    host_chain_sum<false>(a, row0, np, P, C, buf.data(), acc);
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

// D4's whole call in the regime (regime, P, C), arguments as ttd_dot's
// (every pointer on the host): the chain regime block after block as D1's,
// the thread regime output after output.  Returns 0, or -1 for a shape or
// plan the card's entry point refuses.
int ttd_host_d4(const double* xh, const double* xl, const double* yh, const double* yl,
                long long M, long long N, int T, long long xs0, long long xs1, long long xs2,
                long long ys0, long long ys1, long long ys2, int regime, int P, int C,
                double* oh, double* ol) {
  if (!dot_shape_ok(M, N, T)) return -1;
  const DotPlan p = dot_plan_of(M * N, regime, P, C);
  if (!dot_plan_ok(p)) return -1;
  const DotArgs a = dot_args(xh, xl, yh, yl, M, N, T, xs0, xs1, xs2, ys0, ys1, ys2);
  if (p.regime == kDotThread) {
    for (long long e = 0; e < a.B; ++e) {
      const long long i = e / N, j = e % N;
      const DD r = d4_out(xh, xl, yh, yl, i * xs0 + j * xs1, i * ys0 + j * ys1, T, xs2, ys2);
      oh[e] = r.hi;
      ol[e] = r.lo;
    }
    return 0;
  }
  std::vector<double> buf(p.smem / 8);
  DD acc[kChainLanes];
  for (long long o0 = 0; o0 < a.B; o0 += P) {
    const int np = (int)(a.B - o0 < P ? a.B - o0 : P);
    host_chain_sum<true>(a, o0, np, P, C, buf.data(), acc);
    for (int g = 0; g < np; ++g) {
      oh[o0 + g] = acc[g].hi;
      ol[o0 + g] = acc[g].lo;
    }
  }
  return 0;
}

// D3's whole call with P rows and `threads` threads a block, arguments as
// ttd_gather_tt's (every pointer on the host): block after block, core
// after core, each lane's sums in turn.  Returns 0, or -1 for a shape or
// plan the card's entry point refuses.
int ttd_host_d3(const double* cores, const int32_t* ranks, int d, int R, int N,
                const int32_t* ind, long long B, int P, int threads, double* oh, double* ol) {
  const GatherPlan p = gather_plan_of(B, R, d, P, threads);
  if (!gather_shape_ok(B, d, R, N) || !gather_plan_ok(p, R)) return -1;
  const GatherArgs a{cores, ranks, d, R, N, ind, B};
  if (gather_group(R) == 1) {
    host_d3<1>(a, p, oh, ol);
  } else {
    host_d3<kGatherGroup>(a, p, oh, ol);
  }
  return 0;
}

// D2's whole call with P rows a block, arguments as ttd_ising_c_integrand's
// (every pointer on the host; ising_rows.cuh::rows_host).  Returns 0, or -1
// for a shape or plan the card's entry point refuses.
int ttd_host_d2(const double* tables, int n, const int32_t* ind, long long B, int d, int P,
                double* oh, double* ol) {
  return rows_host<D2Row>(tables, n, ind, B, d, P, RowsOut{{oh, ol, nullptr, nullptr}});
}

#endif  // __CUDACC__

// D2's launch for a shape (rows_plan): plan[0..3] = P, threads, blocks,
// shared bytes.  Returns 0, or -1 for a shape ttd_ising_c_integrand refuses.
int ttd_dd_ising_plan(long long B, int d, int n, long long* plan) {
  if (!rows_shape_ok(B, d, n, D2Row::kTab)) return -1;
  const RowsPlan p = rows_plan(B, d, n, D2Row::kTab);
  const long long v[4] = {p.P, p.threads, p.blocks, p.smem};
  for (int k = 0; k < 4; ++k) plan[k] = v[k];
  return 0;
}

// Whether D2 takes P rows a block at this shape (ttd_ising_c_integrand
// refuses the plan otherwise): 1 or 0.
int ttd_dd_ising_plan_ok(long long B, int d, int n, int P) {
  return rows_shape_ok(B, d, n, D2Row::kTab) &&
         rows_plan_ok(rows_plan_of(B, d, n, D2Row::kTab, P));
}

// D1's launch for a shape (score_plan): plan[0..4] = P, C, threads, blocks,
// shared bytes.  Returns 0, or -1 for a shape the entry point refuses.
int ttd_dd_score_plan(long long B, int T, long long* plan) {
  if (!score_shape_ok(B, T, 0)) return -1;
  const ScorePlan p = score_plan(B, T);
  const long long v[5] = {p.P, p.C, p.threads, p.blocks, p.smem};
  for (int k = 0; k < 5; ++k) plan[k] = v[k];
  return 0;
}

// D4's launch for a shape (dot_plan): plan[0..5] = regime, P, C, threads,
// blocks, shared bytes.  Returns 0, or -1 for a shape the entry point
// refuses.
int ttd_dd_dot_plan(long long M, long long N, int T, long long* plan) {
  if (!dot_shape_ok(M, N, T)) return -1;
  const DotPlan p = dot_plan(M, N, T);
  const long long v[6] = {p.regime, p.P, p.C, p.threads, p.blocks, p.smem};
  for (int k = 0; k < 6; ++k) plan[k] = v[k];
  return 0;
}

// D3's launch for a shape (gather_plan): plan[0..3] = P, threads, blocks,
// shared bytes.  Returns 0, or -1 for a shape the entry point refuses.
int ttd_dd_gather_plan(long long B, int d, int R, int N, long long* plan) {
  if (!gather_shape_ok(B, d, R, N)) return -1;
  const GatherPlan p = gather_plan(B, R, d);
  const long long v[4] = {p.P, p.threads, p.blocks, p.smem};
  for (int k = 0; k < 4; ++k) plan[k] = v[k];
  return 0;
}

// Whether D3 takes P rows and `threads` threads a block at this shape
// (ttd_gather_tt refuses the plan otherwise): 1 or 0.
int ttd_dd_gather_plan_ok(long long B, int d, int R, int N, int P, int threads) {
  return gather_shape_ok(B, d, R, N) && gather_plan_ok(gather_plan_of(B, R, d, P, threads), R);
}

}  // extern "C"
