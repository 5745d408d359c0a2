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
//   Q2 qd_score_*_kernel     qd residual vals - sum_t x y (pairwise tree) and
//                            the first index of max |e0|
//   Q3 qd_gather_tt_kernel   an f64 train at (B, d) indices, qd accumulation
//   Q4 qd_dot_*_kernel       the small qd product: qd_matmul's sequential
//                            k-loop or qd_vdot_axis's pairwise tree
//   Q5 qd_div_kernel         qd_div elementwise (no TPU counterpart: the JAX
//                            package divides with numpy on the host)
//
// Rounding.  Every step is written with __dadd_rn / __dsub_rn / __dmul_rn /
// __ddiv_rn, which nvcc never contracts into an FMA, in the operation order
// of ttcross_tpu_torch/ops/qd.py (Dekker's two_prod, the four bottom-up
// distill sweeps and the tail summed in order, qd_sum's tree with the odd
// middle term riding along, qd_matmul's k-loop).  So each kernel is bit for
// bit its plain PyTorch version on any input: a kernel chooses which thread
// computes a product or a sum, never which operands a qd_mul or qd_add sees
// or how the adds pair up.
//
// Host emulation.  Compiled without nvcc (-DTTQ_HOST, a host C++ compiler,
// -ffp-contract=off), the file gives host entry points ttq_host_* that run
// the kernels' own functions in one host thread: the block-level stages of
// Q1, Q2, Q3 and Q4 (every item of a stage in turn, the stages in the
// kernel's order, block after block, Q1's lanes through the tail with their
// neighbours' results as the shuffles give them, Q2's argmax over the
// blocks' best at the end).  The CPU tests hold that arithmetic and its
// bookkeeping to the plain versions where there is no card.
//
// What bounds them: f64 operations.  A qd multiply is 6 two_prods (17
// flops each), 5 products and the order-4 sum (5), and a distill of 17
// terms (4 x 16 two_sums of 6 flops, 13 adds): 508 flops; a qd add is a
// distill of 8 terms, 4 x 7 x 6 + 4 = 172 flops.  None runs on the f64
// tensor cores or fuses into an FMA, so the card's rate for them is its f64
// vector rate (33.5 TFLOP/s on the H100 SXM, counting an FMA as two: one
// plain operation a lane a cycle reaches half of it).  A qd operation is a
// chain of dependent operations (a qd add some 0.16 us on one thread, a qd
// multiply some 0.45 us), so a call with few outputs is bound by that chain,
// not by the rate, unless its sums are spread over threads:
//   - Q4 in three regimes, chosen from the shape alone (dot_plan): the
//     tree (qd_vdot_axis) always by the shared level-by-level tree below, a
//     block's threads over the leaves and each level's adds of its outputs
//     (critical path one multiply, one add and ceil(log2 T) - 1 adds, where
//     a thread per output walked T of each); the sequential sum of a
//     call with fewer than kChainOutputsMax outputs by a chain warp, one
//     lane per output adding the terms in order, while the other warps
//     compute the next chunk of products into the other half of a double
//     buffer (critical path T adds); above that, and for a tree longer than
//     kDotTreeSmem holds, a thread per output as before, which at
//     solve_core's 196,625 outputs already issues at the f64 pipes' rate.
//   - Q3: a block of rows; per core every leaf of every row's r x r2 grid
//     on its own thread, then the r2 trees of each row level by level, v
//     carried in shared memory: no thread bound to an absent column.
//   - Q2: a block of rows by the same shared tree, Q4's tree rule choosing
//     the rows a block (score_plan = dot_plan of B outputs), then a thread
//     per row for the residual; a tree longer than kDotTreeSmem holds keeps
//     a thread per row walking it depth first.
//   - Q5: a thread per quotient; its long division (4 qd_mul_f64, 4 qd_sub,
//     5 divides and a distill of 5 terms, 1,586 flops) is one dependent
//     chain of some 5 us, and the engine divides at most 3,575 values, so
//     the blocks spread a call's warps over the SMs' sub-partitions
//     (div_block).

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
#include <vector>
#define TTQ_FN static inline
#define TTQ_UNROLL
#define TTQ_ADD(a, b) ((a) + (b))
#define TTQ_SUB(a, b) ((a) - (b))
#define TTQ_MUL(a, b) ((a) * (b))
#define TTQ_DIV(a, b) ((a) / (b))
#define TTQ_ISNAN(a) std::isnan(a)
#endif

#include "ising_rows.cuh"   // Q1's body, launch, plan and host emulation, shared with D2

namespace {

constexpr double kSplit = 134217729.0;  // 2^27 + 1, Dekker's constant for binary64
constexpr int kThreads = 256;           // a block of Q2, Q3 and Q4
constexpr int kGatherRMax = 64;         // Q3: ranks up to this
constexpr int kTreeDepth = 16;          // the pairwise tree takes up to 2^16 terms
constexpr long long kChainOutputsMax = 23552;  // Q4 sequential: chains below this many outputs
constexpr int kChainLanes = 32;         // Q4 sequential: outputs of a block at most (a warp's lanes)
constexpr int kSMs = 132;               // the H100 SXM's SMs: Q4 spreads few outputs over them
constexpr int kDotTreeSmem = 200 * 1024;  // Q4 tree: a block's level-1 terms' bytes at most
constexpr int kGatherSmem = 72 * 1024;  // Q3: a block's shared memory at most (three blocks an SM)
constexpr int kFillBlocks = 3 * 132;    // Q3: blocks that fill the card (three on each SM)
constexpr int kDivDims = 4;             // Q5: outputs of up to this many axes

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

// The shared pairwise tree: qd_sum's pairing, level by level, over a set of
// trees of T leaves each in a buffer (shared memory on the card, a plain
// array on the host).  Limb k of tree g's position p is buf[k * ls + off(g,
// p)].  tree_leaves writes level 1 straight from the leaves (level 0 is never
// stored): position p < K_1 is qd_add(leaf(g, p), leaf(g, p + K_1)) when p <
// T - K_1, else leaf(g, p).  tree_levels then folds level l into level l + 1
// in place: position p < K_l - K_{l+1} becomes qd_add(p, p + K_{l+1}), the
// odd middle term stays (it reads positions >= K_{l+1} and writes below K_l
// - K_{l+1} <= K_{l+1}, so no position is both read and written within a
// level).  Tree g's sum ends at position 0.  The items (g, p) of a stage go
// to threads tid, tid + nth, ... with g fastest, and sync() ends each stage
// (__syncthreads on the card; on the host, nothing: one thread takes every
// item in turn).  Every qd_add sees the operands qd_sum gives it, so each
// sum is qd_sum's bit for bit.
TTQ_FN QD get_at(const double* buf, int ls, int o) {
  return QD{buf[o], buf[ls + o], buf[2 * ls + o], buf[3 * ls + o]};
}

TTQ_FN void put_at(double* buf, int ls, int o, const QD& v) {
  buf[o] = v.e0;
  buf[ls + o] = v.e1;
  buf[2 * ls + o] = v.e2;
  buf[3 * ls + o] = v.e3;
}

template <typename Leaf, typename Off, typename Sync>
TTQ_FN void tree_leaves(double* buf, int ls, int ntrees, int T, Leaf leaf, Off off, int tid,
                        int nth, Sync sync) {
  const int K1 = (T + 1) / 2, paired = T - K1;
  for (int it = tid; it < ntrees * K1; it += nth) {
    const int g = it % ntrees, p = it / ntrees;
    QD s = leaf(g, p);
    if (p < paired) s = qd_add(s, leaf(g, p + K1));
    put_at(buf, ls, off(g, p), s);
  }
  sync();
}

template <typename Off, typename Sync>
TTQ_FN void tree_levels(double* buf, int ls, int ntrees, int T, Off off, int tid, int nth,
                        Sync sync) {
  for (int K = (T + 1) / 2; K > 1;) {
    const int K2 = (K + 1) / 2, paired = K - K2;
    for (int it = tid; it < ntrees * paired; it += nth) {
      const int g = it % ntrees, p = it / ntrees;
      put_at(buf, ls, off(g, p),
             qd_add(get_at(buf, ls, off(g, p)), get_at(buf, ls, off(g, p + K2))));
    }
    sync();
    K = K2;
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

TTQ_FN QD q2_term(const ScoreArgs& a, long long row, int t) {
  return qd_mul(at(a.x, row * a.xsb + (long long)t * a.xst),
                at(a.y, row * a.ysb + (long long)t * a.yst));
}

TTQ_FN QD q2_finish(const ScoreArgs& a, long long row, const QD& sum) {
  return qd_sub(at(a.v, row), sum);
}

// The thread regime's row: the tree walked depth first on one thread.
TTQ_FN QD q2_row(const ScoreArgs& a, long long row) {
  return q2_finish(a, row, tree_sum(a.T, [&](int t) { return q2_term(a, row, t); }));
}

// Q4's output (i, j): sum_t x[i, j, t] y[i, j, t], by the tree (qd_vdot_axis)
// or from term 0 by qd_add of each next term in order (qd_matmul).
struct DotArgs {
  Limbs x, y;
  long long M, N;
  int T, tree;
  long long xs0, xs1, xs2, ys0, ys1, ys2;
};

// Term t of flat output o = i N + j.
TTQ_FN QD q4_term(const DotArgs& a, long long o, int t) {
  const long long i = o / a.N, j = o - i * a.N;
  return qd_mul(at(a.x, i * a.xs0 + j * a.xs1 + (long long)t * a.xs2),
                at(a.y, i * a.ys0 + j * a.ys1 + (long long)t * a.ys2));
}

// A thread's whole output: the tree walked depth first, or the chain.
template <bool kTree>
TTQ_FN QD q4_out(const DotArgs& a, long long o) {
  auto term = [&](int t) { return q4_term(a, o, t); };
  if (kTree) return tree_sum(a.T, term);
  if (a.T == 0) return QD{0.0, 0.0, 0.0, 0.0};
  QD acc = term(0);
  for (int t = 1; t < a.T; ++t) acc = qd_add(acc, term(t));
  return acc;
}

// Q5's output e: qd_div(x, y) at e's coordinates in the output's shape
// (kDivDims axes, the leading ones 1), each operand at its own strides (0
// along a broadcast axis), so a strided column or a broadcast pivot is read
// where it lies.
struct DivArgs {
  Limbs x, y;
  long long E;
  long long size[kDivDims], xs[kDivDims], ys[kDivDims];
};

TTQ_FN QD q5_out(const DivArgs& a, long long e) {
  long long ox = 0, oy = 0;
  TTQ_UNROLL
  for (int k = kDivDims - 1; k >= 0; --k) {
    const long long i = e % a.size[k];
    e /= a.size[k];
    ox += i * a.xs[k];
    oy += i * a.ys[k];
  }
  return qd_div(at(a.x, ox), at(a.y, oy));
}

// Q4's launch for one shape, from the shape alone.  regime kDotThread: a
// thread per output, P a block; kDotChain: P outputs a block, the
// chain warp's lanes 0..P-1 each adding its output's terms in order, the
// other threads - 32 computing chunks of C terms of every output; kDotTree:
// P outputs a block, C = K_1 = ceil(T / 2) level-1 terms each.
enum { kDotThread = 0, kDotChain = 1, kDotTree = 2 };
struct DotPlan {
  int regime, P, C, threads;
  long long blocks, smem;
};

DotPlan dot_plan_of(long long M, long long N, int T, int regime, int P, int C) {
  const long long E = M * N;
  DotPlan p{regime, P, 0, P, (E + P - 1) / P, 0};
  if (regime == kDotTree) {
    p.C = (T + 1) / 2;
    const long long items = (long long)P * p.C;
    p.threads = (int)(items < kThreads ? (items + 31) / 32 * 32 : kThreads);
    p.smem = 32 * items;
  } else if (regime == kDotChain) {
    p.C = C;
    const long long items = (long long)P * C;
    p.threads = 32 + (int)(items < kThreads - 32 ? (items + 31) / 32 * 32 : kThreads - 32);
    p.smem = 64 * items;
  }
  return p;
}

// The rule, measured on an H100 (chip_smoke.py --qd-regimes; PERF.md).  The
// tree: outputs of a block up to a block's kThreads level-1 terms, but no
// more than leave every SM a block (8 warps on one SM contend for its f64
// pipes: (1, 33, 33) in one block of 15 outputs 7.4 us, in 33 blocks 6.4).
// The sequential sum: chains below kChainOutputsMax outputs, a thread per
// output from there.  A thread per output takes T x ~1.1-1.5 us while each
// SM holds at most ~256 of them (its f64 pipes half idle), longer in
// proportion above; the chains E T x ~0.065 ns (the card's f64 rate, less
// the chain warp's adds in a row).  Measured crossover between E = 20,900
// (75 against 84 us at T = 55) and 23,540 (89 against 85); at 17,160 (T =
// 33) 47 against 54.  A chain block takes a warp of outputs once that
// leaves 66 blocks, fewer below (a power of two).  The threads' block,
// 256, 128 or 64, is the one that puts the fewest outputs on the busiest
// SM, the larger on a tie: (33, 2145, 33) 122 us in blocks of 64 or 128, 140
// in blocks of 256; (55, 1430, 55) 203 against 233; solve_core 457 in 256.
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

DotPlan dot_plan(long long M, long long N, int T, int tree) {
  const long long E = M * N;
  if (tree) {
    const int K1 = (T + 1) / 2;
    if (32LL * K1 > kDotTreeSmem) return dot_plan_of(M, N, T, kDotThread, thread_block(E), 0);
    const long long fill = K1 >= kThreads ? 1 : kThreads / K1, spread = (E + kSMs - 1) / kSMs;
    return dot_plan_of(M, N, T, kDotTree, (int)(fill < spread ? fill : spread), 0);
  }
  if (E >= kChainOutputsMax) return dot_plan_of(M, N, T, kDotThread, thread_block(E), 0);
  int P = 1;
  while (2 * P <= kChainLanes && 2 * P * (kSMs / 2) <= E) P *= 2;
  const int C = (kThreads - 32) / P;
  return dot_plan_of(M, N, T, kDotChain, P, T < 1 ? 1 : (T < C ? T : C));
}

// The tree regime's block: outputs o0 .. o0 + np - 1, each a tree over its T
// terms; level-1 terms at off(g, p) = p P + g (a stage's neighbouring threads
// on neighbouring words).  Returns nothing: the sums stay at position 0.
template <typename Sync>
TTQ_FN void q4_tree_block(const DotArgs& a, long long o0, int np, int P, double* buf, int tid,
                          int nth, Sync sync) {
  const int ls = P * ((a.T + 1) / 2);
  auto off = [&](int g, int p) { return p * P + g; };
  tree_leaves(buf, ls, np, a.T, [&](int g, int t) { return q4_term(a, o0 + g, t); }, off, tid,
              nth, sync);
  tree_levels(buf, ls, np, a.T, off, tid, nth, sync);
}

// Q2's tree block: rows row0 .. row0 + np - 1, as q4_tree_block's outputs;
// each row's sum ends at position g of buf (limb stride P ceil(T / 2)).
template <typename Sync>
TTQ_FN void q2_tree_block(const ScoreArgs& a, long long row0, int np, int P, double* buf, int tid,
                          int nth, Sync sync) {
  const int ls = P * ((a.T + 1) / 2);
  auto off = [&](int g, int p) { return p * P + g; };
  tree_leaves(buf, ls, np, a.T, [&](int g, int t) { return q2_term(a, row0 + g, t); }, off, tid,
              nth, sync);
  tree_levels(buf, ls, np, a.T, off, tid, nth, sync);
}

// The chain regime's stages.  Chunk k holds terms kC .. kC + C - 1 of each
// of the block's np outputs, in half k & 1 of the double buffer (position
// c of output g at (k & 1) C P + c P + g, limb stride 2 C P).
TTQ_FN void q4_produce(const DotArgs& a, long long o0, int np, int P, int C, double* buf, int k,
                       int tid, int nth) {
  const int t0 = k * C, len = a.T - t0 < C ? a.T - t0 : C, half = (k & 1) * C * P;
  for (int it = tid; it < np * len; it += nth) {
    const int g = it % np, c = it / np;
    put_at(buf, 2 * C * P, half + c * P + g, q4_term(a, o0 + g, t0 + c));
  }
}

TTQ_FN void q4_chain(const DotArgs& a, int P, int C, const double* buf, int k, int g, QD& acc) {
  const int t0 = k * C, len = a.T - t0 < C ? a.T - t0 : C, half = (k & 1) * C * P;
  for (int c = 0; c < len; ++c) {
    const QD v = get_at(buf, 2 * C * P, half + c * P + g);
    acc = t0 + c == 0 ? v : qd_add(acc, v);
  }
}

// Q3's block: rows row0 .. row0 + np - 1 of an f64 train at ind (B, d), qd
// accumulation (ttcross_tpu/ops/qd.py::qd_gather_tt).  Per core c, row b's
// next v'[j] = sum_{t < r} qd_mul(v_b[t], (G_c[t, i_{b,c}, j], 0, 0, 0)) by
// the shared tree.  Each leaf is qd_mul_f64(v_b[t], G_c[...]) (199 flops, not
// 508): with y's low limbs zero, qd_mul's 17 distill terms are qd_mul_f64's
// 7 in the same order with exact zeros between them, which two_sum passes
// through unchanged, so the two agree bit for bit (signed zeros, subnormals,
// inf and NaN too: tests/test_torch_qd_kernels.py::test_mul_by_f64_is_qd_mul
// over every combination of such limbs).  The np r2 trees (g = b r2 + j) at
// off(g, p) = b K R + p R + j (K = ceil(R / 2), R the padded rank); v in its
// own buffer (limb stride P R), carried from core to core.  Ends with each
// row's value at v_b[0].
template <typename Sync>
TTQ_FN void q3_block(const double* cores, const int32_t* ranks, int d, int R, int N,
                     const int32_t* ind, long long row0, int np, int P, double* buf, double* v,
                     int tid, int nth, Sync sync) {
  const int K = (R + 1) / 2, lsb = P * K * R, lsv = P * R;
  for (int b = tid; b < np; b += nth) put_at(v, lsv, b * R, QD{1.0, 0.0, 0.0, 0.0});
  sync();
  for (int c = 0; c < d; ++c) {
    const int r = ranks[c], r2 = ranks[c + 1];
    const double* core = cores + (long long)c * R * N * R;
    auto off = [&](int g, int p) {
      const int b = g / r2;
      return b * K * R + p * R + (g - b * r2);
    };
    auto leaf = [&](int g, int t) {
      const int b = g / r2, j = g - b * r2;
      int i = ind[(row0 + b) * d + c];
      i = i < 0 ? 0 : (i >= N ? N - 1 : i);
      return qd_mul_f64(get_at(v, lsv, b * R + t),
                        core[(long long)t * N * R + (long long)i * R + j]);
    };
    tree_leaves(buf, lsb, np * r2, r, leaf, off, tid, nth, sync);
    tree_levels(buf, lsb, np * r2, r, off, tid, nth, sync);
    for (int g = tid; g < np * r2; g += nth) {
      const int b = g / r2;
      put_at(v, lsv, b * R + (g - b * r2), get_at(buf, lsb, off(g, 0)));
    }
    sync();
  }
}

// Q3's rows per block: as many as kGatherSmem holds (at least one), no
// more than spread B over kFillBlocks blocks.
int gather_rows(int R, long long B) {
  const long long row_bytes = 32LL * ((R + 1) / 2 * R + R);
  long long P = kGatherSmem / row_bytes;
  const long long spread = (B + kFillBlocks - 1) / kFillBlocks;
  if (P > spread) P = spread;
  return (int)(P < 1 ? 1 : P);
}

long long gather_smem(int R, int P) { return 32LL * P * ((R + 1) / 2 * R + R); }

// Q1's row (ising_rows.cuh): f = 2 / (v w) prod_i W_i with w = 1 + sum_k
// prod_{i<=k} x_i and v the same over the reversed row
// (ttcross_tpu/apps/ising.py:246-278); tab: (8, n) node limbs e0..e3 then
// weight limbs e0..e3; the tail qd_mul(qd_div(2, qd_mul(v, w)), pw); out
// (4, B) limb-major.
TTQ_FN QD q1_at(const double* t, int n, int i) {
  return QD{t[i], t[n + i], t[2 * n + i], t[3 * n + i]};
}

struct Q1Row {
  using T = QD;
  static constexpr int kTab = 8;

  // The lane of role `role`: 0 the forward scan's w, 1 the backward scan's
  // v, 2 the weight product, each from one in the plain version's order and
  // operand order (qd_mul(pk, x), qd_add(s, pk)).  One loop for every role
  // (its table and column order from the role), so a warp's lanes run one
  // instruction stream; the weight lane's sum is computed with the others'
  // and dropped.  ri: the row's d indices, one outside [0, n) clamped.
  static TTR_DEV QD lane(const double* tab, int n, const int32_t* ri, int d, int role) {
    const double* t = tab + (role == 2 ? 4 * n : 0);
    const QD one{1.0, 0.0, 0.0, 0.0};
    QD pk = one, s = one;
    for (int k = 0; k < d; ++k) {
      pk = qd_mul(pk, q1_at(t, n, clamp_index(ri[role == 1 ? d - 1 - k : k], n)));
      s = qd_add(s, pk);
    }
    return role == 2 ? pk : s;
  }

  static TTR_DEV QD tail(const QD& v, const QD& w, const QD& pw) {
    return qd_mul(qd_div(QD{2.0, 0.0, 0.0, 0.0}, qd_mul(v, w)), pw);
  }

  static TTR_DEV void store(const RowsOut& o, long long row, const QD& r) {
    o.p[0][row] = r.e0;
    o.p[1][row] = r.e1;
    o.p[2][row] = r.e2;
    o.p[3][row] = r.e3;
  }

#if defined(__CUDACC__)
  static __device__ __forceinline__ QD shfl(const QD& x, int src) {
    return QD{__shfl_sync(0xffffffffu, x.e0, src), __shfl_sync(0xffffffffu, x.e1, src),
              __shfl_sync(0xffffffffu, x.e2, src), __shfl_sync(0xffffffffu, x.e3, src)};
  }
#endif
};

// NaN above every number, then the larger score, then the smaller index
// (torch.argmax's order).
TTQ_FN bool better(double as, long long ai, double bs, long long bi) {
  const bool an = TTQ_ISNAN(as), bn = TTQ_ISNAN(bs);
  if (an || bn) return an && (!bn || ai < bi);
  return as > bs || (as == bs && ai < bi);
}

struct Best {
  double score;
  long long idx;
};

TTQ_FN void keep(Best& b, const Best& o) {
  if (better(o.score, o.idx, b.score, b.idx)) b = o;
}

#if defined(__CUDACC__)
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
// (:281-290).  r[row] = vals[row] - qd_sum(x[row, :] y[row, :]) (4 limbs),
// then the first index of max |r.e0|.  Bound: operations, B T (qd multiply
// + qd add), but a thread walking its row's tree depth first waits on ~T
// dependent qd operations and keeps a stack frame a level in local memory,
// and ceil(B / 256) blocks leave most SMs idle at the engine's shapes.  Two
// kernels, the regime from score_plan (Q4's tree rule for B outputs of T
// terms): the shared tree, P rows a block (every leaf on its own thread, the
// levels folded in shared memory, then a thread per row for the residual);
// and, for a tree longer than the tree regime's shared memory, a thread per
// row walking it depth first.  Each block writes its best |r.e0| and index
// to the scratch words, and the last block to finish (by the counter in
// words[1], zeroed by the entry point on the stream for each launch) reduces
// them into words[0]; a grid of one block writes its best there directly.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void put_out(double* out, long long E, long long o, const QD& r) {
  out[o] = r.e0;
  out[E + o] = r.e1;
  out[2 * E + o] = r.e2;
  out[3 * E + o] = r.e3;
}

// The grid's best from each block's (valid in its thread 0; every thread of
// the block calls it).  words: the index; with more than one block, then
// the counter (zero at the launch) and the blocks' scores and indices.
__device__ void grid_argmax(Best b, long long* words) {
  const unsigned nb = gridDim.x;
  if (nb == 1) {
    if (threadIdx.x == 0) words[0] = b.idx;
    return;
  }
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

// kDotThread: a thread per row, the tree walked depth first.
__global__ void __launch_bounds__(kThreads)
qd_score_kernel(ScoreArgs a, double* __restrict__ out, long long* __restrict__ words) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  Best b{-INFINITY, LLONG_MAX};
  if (row < a.B) {
    const QD r = q2_row(a, row);
    put_out(out, a.B, row, r);
    b = Best{fabs(r.e0), row};
  }
  grid_argmax(block_reduce(b), words);
}

// kDotTree: the block's P rows by the shared tree, then a thread per row.
__global__ void __launch_bounds__(kThreads)
qd_score_tree_kernel(ScoreArgs a, int P, double* __restrict__ out, long long* __restrict__ words) {
  extern __shared__ double qsm[];
  const long long row0 = (long long)blockIdx.x * P;
  const int np = (int)(a.B - row0 < P ? a.B - row0 : P);
  q2_tree_block(a, row0, np, P, qsm, threadIdx.x, blockDim.x, [] { __syncthreads(); });
  const int ls = P * ((a.T + 1) / 2);
  Best b{-INFINITY, LLONG_MAX};
  for (int g = threadIdx.x; g < np; g += blockDim.x) {
    const QD r = q2_finish(a, row0 + g, get_at(qsm, ls, g));
    put_out(out, a.B, row0 + g, r);
    keep(b, Best{fabs(r.e0), row0 + g});
  }
  grid_argmax(block_reduce(b), words);
}

// ---------------------------------------------------------------------------
// Q4: a small qd product with strides.  out[i, j] = sum_t x[i, j, t]
// y[i, j, t], out (4, M, N) contiguous, x and y any strided views (a GEMM A @
// B is x = A broadcast over j, y = B broadcast over i).  It serves
// qd_matmul (tree = 0: apply_*_slice, solve_core, the value chain's
// products) and qd_vdot_axis (tree = 1: _extend_inverses, the value chain's
// weight contraction, qd_contract, refine_dd).  Bound: operations, M N T (qd
// multiply + qd add).  Three kernels, one launch a call, the regime from
// dot_plan.
// ---------------------------------------------------------------------------

// kDotThread: a thread per output; kTree only for a tree longer than the
// tree regime's shared memory (the depth-first walk, one frame a level).
template <bool kTree>
__global__ void __launch_bounds__(kThreads) qd_dot_kernel(DotArgs a, double* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long E = a.M * a.N;
  if (e >= E) return;
  put_out(out, E, e, q4_out<kTree>(a, e));
}

// kDotChain: lanes 0..np-1 of warp 0 each add their output's terms in order
// from one half of the double buffer while warps 1.. compute the next chunk
// into the other half; one barrier a chunk.
__global__ void __launch_bounds__(kThreads)
qd_dot_chain_kernel(DotArgs a, int P, int C, double* __restrict__ out) {
  extern __shared__ double qsm[];
  const long long E = a.M * a.N, o0 = (long long)blockIdx.x * P;
  const int np = (int)(E - o0 < P ? E - o0 : P), tid = threadIdx.x;
  const int nch = (a.T + C - 1) / C;
  QD acc{0.0, 0.0, 0.0, 0.0};
  for (int k = 0; k <= nch; ++k) {
    if (tid >= 32) {
      if (k < nch) q4_produce(a, o0, np, P, C, qsm, k, tid - 32, blockDim.x - 32);
    } else if (tid < np && k > 0) {
      q4_chain(a, P, C, qsm, k - 1, tid, acc);
    }
    __syncthreads();
  }
  if (tid < np) put_out(out, E, o0 + tid, acc);
}

// kDotTree: the block's P outputs by the shared tree.
__global__ void __launch_bounds__(kThreads)
qd_dot_tree_kernel(DotArgs a, int P, double* __restrict__ out) {
  extern __shared__ double qsm[];
  const long long E = a.M * a.N, o0 = (long long)blockIdx.x * P;
  const int np = (int)(E - o0 < P ? E - o0 : P);
  q4_tree_block(a, o0, np, P, qsm, threadIdx.x, blockDim.x, [] { __syncthreads(); });
  const int ls = P * ((a.T + 1) / 2);
  for (int g = threadIdx.x; g < np; g += blockDim.x) put_out(out, E, o0 + g, get_at(qsm, ls, g));
}

// ---------------------------------------------------------------------------
// Q3: qd_gather_tt, an f64 train at (B, d) indices with qd accumulation
// (ttcross_tpu/ops/qd.py:384-403), the qd defect integrand's cost
// (ttcross_tpu/cross/defect.py:115-184).  The cores come packed, (d, R, N,
// R) zero-padded, the ranks on the device.  P rows a block (gather_rows),
// q3_block's stages over all kThreads threads: per core the np r r2 leaves
// (a core element feeds one leaf, so it is read once, from the L2, along j),
// the np r2 trees, v' into v.  Bound: operations, B sum_c r_{c+1} (r_c qd
// multiplies + r_c - 1 qd adds).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
qd_gather_tt_kernel(const double* __restrict__ cores, const int32_t* __restrict__ ranks, int d,
                    int R, int N, const int32_t* __restrict__ ind, long long B, int P,
                    double* __restrict__ out) {
  extern __shared__ double qsm[];
  const long long row0 = (long long)blockIdx.x * P;
  const int np = (int)(B - row0 < P ? B - row0 : P);
  double* v = qsm + 4 * P * ((R + 1) / 2) * R;
  q3_block(cores, ranks, d, R, N, ind, row0, np, P, qsm, v, threadIdx.x, blockDim.x,
           [] { __syncthreads(); });
  for (int b = threadIdx.x; b < np; b += blockDim.x) {
    put_out(out, B, row0 + b, get_at(v, P * R, b * R));
  }
}

// ---------------------------------------------------------------------------
// Q1: the C-kind Ising integrand in qd, fused with its node / weight lookup
// (the qd variant of small_table_lookup_limbs, ttcross_tpu/ops/
// pallas_kernels.py:151, on the integrand of ttcross_tpu/apps/ising.py:
// 246-278).  Any d; the (8, n) table and the block's rows' indices staged
// in shared memory in one cp.async round trip.  Bound: operations, per row
// 3d qd multiplies, 2d qd adds, one qd multiply, one qd divide and one more
// multiply (at d = 3 8,206 f64 operations); but a call of 65-3,575 rows puts
// at most one warp on an SM sub-partition, so a warp's sequence of
// operations is its time.  The row's three scans are independent: on three
// lanes of one warp (ising_rows.cuh) they cost what one costs, and a row's
// sequence falls to one scan and the tail (4,642 at d = 3).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kRowsThreads)
ising_c_qd_kernel(const double* __restrict__ tables, int n, const int32_t* __restrict__ ind,
                  long long B, int d, int P, RowsOut out) {
  extern __shared__ __align__(16) unsigned char q1sm[];
  rows_body<Q1Row>(q1sm, tables, n, ind, B, d, P, out);
}

// ---------------------------------------------------------------------------
// Q5: qd_div elementwise, a thread per quotient (ops/qd.py::qd_div, the
// Hida-Li-Bailey long division; the qd engine's new column factor over its
// pivot and the bordered inverse's new column, refine_dd's elimination).
// Bound: operations, E x 1,586 flops; but at the engine's 1-3,575 quotients
// a call is one quotient's dependent chain, whatever the rate.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) qd_div_kernel(DivArgs a, double* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.E) return;
  put_out(out, a.E, e, q5_out(a, e));
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

// A shape ttq_dot takes, and a plan that launches at it.
bool dot_shape_ok(long long M, long long N, int T, int tree) {
  return M >= 1 && N >= 1 && T >= (tree ? 1 : 0) && T <= (1 << kTreeDepth) &&
         M * N <= (long long)INT_MAX * kThreads;
}

bool dot_plan_ok(int tree, const DotPlan& p) {
  const long long smem_max = 227 * 1024;
  if (p.blocks > INT_MAX) return false;
  if (p.regime == kDotThread) return p.P >= 32 && p.P <= kThreads && p.P % 32 == 0;
  if (p.regime == kDotTree) return tree && p.P >= 1 && p.smem <= smem_max;
  return p.regime == kDotChain && !tree && p.P >= 1 && p.P <= kChainLanes && p.C >= 1 &&
         p.smem <= smem_max;
}

// Q2's launch: Q4's tree rule for B outputs of T terms (kDotTree, or
// kDotThread for a tree longer than kDotTreeSmem holds), with two changes
// measured on an H100 (chip_smoke.py --qd-regimes; PERF.md): a call whose
// level-1 terms fit one block's threads is one block, with no step across
// blocks ((201, 1) 5.1 us in one block against 8.1-9.9 in 2-201); and full
// blocks take more rows until the grid is one wave of two blocks an SM (a
// tree block of 256 threads at 98 registers: two fit an SM; (3575, 54) 19.6
// us at 14 rows a block against 24.5 at 9), within kDotTreeSmem.
DotPlan score_plan(long long B, int T) {
  const long long K1 = (T + 1) / 2;
  if (B * K1 <= kThreads) return dot_plan_of(1, B, T, kDotTree, (int)B, 0);
  const DotPlan p = dot_plan(1, B, T, 1);
  if (p.regime != kDotTree || p.threads < kThreads || p.blocks <= 2 * kSMs) return p;
  const long long wave = (B + 2 * kSMs - 1) / (2 * kSMs), fit = kDotTreeSmem / (32 * K1);
  return dot_plan_of(1, B, T, kDotTree, (int)(wave < fit ? wave : fit), 0);
}

bool score_shape_ok(long long B, int T) { return dot_shape_ok(1, B, T, 1); }

bool score_plan_ok(const DotPlan& p) { return p.regime != kDotChain && dot_plan_ok(1, p); }

// Q5's block for E quotients: 32, 64, 128 or 256 threads, the one that puts
// the fewest warps on the busiest SM sub-partition (a block's warps spread
// over its SM's four), the larger on a tie.  A quotient is one dependent
// chain (5.2-5.5 us), so a call takes one chain's time while no
// sub-partition holds two warps, whatever the block.  Measured on an H100
// (chip_smoke.py --qd-regimes, tune_qd_div; PERF.md): at E = 1-8,448
// quotients blocks of 32, 64 and 128 within 0.2 us of each other, 128 the
// least from 1,024 up (3,575: 5.42 us against 5.52 in 32 and 6.64 in 256,
// whose 8 warps pair up on a sub-partition); at 33,792 and 10^5, with
// every SM full, 256 the least (6.80 / 13.12 against 6.89 / 13.34 in 128).
int div_block(long long E) {
  int best = kThreads;
  long long load = 0;
  for (int b = kThreads; b >= 32; b /= 2) {
    const long long blocks = (E + b - 1) / b;
    const long long warps = (blocks + kSMs - 1) / kSMs * (b / 32), l = (warps + 3) / 4;
    if (load == 0 || l < load) {
      best = b;
      load = l;
    }
  }
  return best;
}

bool div_shape_ok(long long E) { return E >= 1 && E <= (long long)INT_MAX * 32; }

bool div_block_ok(int threads) {
  return threads >= 32 && threads <= kThreads && threads % 32 == 0;
}

DivArgs div_args(const double* const* x, const double* const* y, const long long* size,
                 const long long* xs, const long long* ys) {
  DivArgs a{limbs_of(x), limbs_of(y), 1, {}, {}, {}};
  for (int k = 0; k < kDivDims; ++k) {
    a.size[k] = size[k];
    a.xs[k] = xs[k];
    a.ys[k] = ys[k];
    a.E *= size[k];
  }
  return a;
}

}  // namespace

extern "C" {

#if defined(__CUDACC__)
// Q2 in the plan (regime, P) that ttq_score_plan gives the shape, or another
// the caller names (the card tests and the tuning launch every plan).
// vals/x/y: host arrays of the 4 limb pointers; x and y strided (B, T)
// views, element (b, t) at b * s?b + t * s?t; T >= 1.  out: 4B doubles
// (limb-major).  words: 2 + 2 * blocks eight-byte words on the device, the
// index first; with more than one block the counter after it is zeroed
// here, on the stream, before the launch.
int ttq_score_residual_argmax(const double* const* vals, const double* const* x,
                              const double* const* y, long long B, int T, long long xsb,
                              long long xst, long long ysb, long long yst, int regime, int P,
                              double* out, long long* words, void* stream) {
  const DotPlan p = dot_plan_of(1, B, T, regime, P, 0);
  if (!score_shape_ok(B, T) || !score_plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.blocks > 1) {
    const cudaError_t err = cudaMemsetAsync(words + 1, 0, sizeof(long long), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const ScoreArgs a = score_args(vals, x, y, B, T, xsb, xst, ysb, yst);
  const unsigned blocks = (unsigned)p.blocks;
  if (p.regime == kDotThread) {
    qd_score_kernel<<<blocks, p.threads, 0, st>>>(a, out, words);
  } else {
    allow_smem(qd_score_tree_kernel, p.smem);
    qd_score_tree_kernel<<<blocks, p.threads, p.smem, st>>>(a, p.P, out, words);
  }
  return static_cast<int>(cudaGetLastError());
}

// Q4's launch in the plan p (checked by ttq_dot).
int launch_dot(const DotArgs& a, const DotPlan& p, double* out, cudaStream_t st) {
  const unsigned blocks = (unsigned)p.blocks;
  if (p.regime == kDotThread) {
    if (a.tree) {
      qd_dot_kernel<true><<<blocks, p.threads, 0, st>>>(a, out);
    } else {
      qd_dot_kernel<false><<<blocks, p.threads, 0, st>>>(a, out);
    }
  } else if (p.regime == kDotChain) {
    allow_smem(qd_dot_chain_kernel, p.smem);
    qd_dot_chain_kernel<<<blocks, p.threads, p.smem, st>>>(a, p.P, p.C, out);
  } else {
    allow_smem(qd_dot_tree_kernel, p.smem);
    qd_dot_tree_kernel<<<blocks, p.threads, p.smem, st>>>(a, p.P, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Q4 in the regime (regime, P, C) that ttq_dot_plan gives the shape, or
// another the caller names (C is the chain's chunk, ignored by the other
// regimes; the card tests and the tuning of kChainOutputsMax launch every
// regime at one shape).  out (4, M, N) contiguous; strides in elements;
// tree: 1 for the pairwise tree (T >= 1), 0 for the sequential sum (T >= 0).
int ttq_dot(const double* const* x, const double* const* y, long long M, long long N, int T,
            long long xs0, long long xs1, long long xs2, long long ys0, long long ys1,
            long long ys2, int tree, int regime, int P, int C, double* out, void* stream) {
  const DotPlan p = dot_plan_of(M, N, T, regime, P, C);
  if (!dot_shape_ok(M, N, T, tree) || !dot_plan_ok(tree, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_dot(dot_args(x, y, M, N, T, xs0, xs1, xs2, ys0, ys1, ys2, tree), p, out,
                    static_cast<cudaStream_t>(stream));
}

// Q3 with `rows` rows and `threads` threads a block (the rule: ttq_gather_rows
// and kThreads; the card tests and the tuning launch others).  cores (d, R,
// N, R) f64 contiguous, ranks d + 1 int32 on the device (every rank <= R <=
// kGatherRMax), ind (B, d) int32; out 4B doubles.
int ttq_gather_tt(const double* cores, const int32_t* ranks, int d, int R, int N,
                  const int32_t* ind, long long B, int rows, int threads, double* out,
                  void* stream) {
  const long long smem = gather_smem(R, rows);
  if (B < 1 || d < 1 || R < 1 || R > kGatherRMax || rows < 1 || threads < 32 ||
      threads > kThreads || threads % 32 != 0 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  allow_smem(qd_gather_tt_kernel, smem);
  const unsigned blocks = (unsigned)((B + rows - 1) / rows);
  qd_gather_tt_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cores, ranks, d, R, N, ind, B, rows, out);
  return static_cast<int>(cudaGetLastError());
}

// Q1 with P rows a block, as ttq_q1_plan gives them the shape or as the
// caller names them.  tables (8, n) f64: node limbs e0..e3, weight limbs
// e0..e3; ind (B, d) int32, d >= 1; out 4B doubles.
int ttq_ising_c_integrand(const double* tables, int n, const int32_t* ind, long long B, int d,
                          int P, double* out, void* stream) {
  return rows_launch<Q1Row>(ising_c_qd_kernel, tables, n, ind, B, d, P,
                            RowsOut{{out, out + B, out + 2 * B, out + 3 * B}}, stream);
}

// Q5 with `threads` a block (the rule: ttq_div_plan's, div_block; the card
// tests and the tuning launch others).  x, y: host arrays of the 4 limb
// pointers; size: the output's kDivDims axes (the leading ones 1), xs / ys
// each operand's strides in elements along them (0 where it is broadcast);
// out (4, E) contiguous, E the product of size.
int ttq_div(const double* const* x, const double* const* y, const long long* size,
            const long long* xs, const long long* ys, int threads, double* out, void* stream) {
  const DivArgs a = div_args(x, y, size, xs, ys);
  if (!div_shape_ok(a.E) || !div_block_ok(threads)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (unsigned)((a.E + threads - 1) / threads);
  qd_div_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a, out);
  return static_cast<int>(cudaGetLastError());
}

int ttq_threads(void) { return kThreads; }

int ttq_rows_threads(void) { return kRowsThreads; }

int ttq_gather_rmax(void) { return kGatherRMax; }

int ttq_tree_max(void) { return 1 << kTreeDepth; }

int ttq_div_dims(void) { return kDivDims; }

#else   // the host emulation: the kernels' functions in one host thread

// Q2's whole call in the plan (regime, P), arguments as
// ttq_score_residual_argmax's (every pointer on the host): block after
// block, each stage's items in turn, the stages in the kernel's order, then
// the grid's argmax over the blocks' best.  out: (4, B) limb-major; *index:
// the flat argmax.  Returns 0, or -1 for a shape or plan the card's entry
// point refuses.
int ttq_host_q2(const double* const* vals, const double* const* x, const double* const* y,
                long long B, int T, long long xsb, long long xst, long long ysb, long long yst,
                int regime, int P, double* out, long long* index) {
  const DotPlan p = dot_plan_of(1, B, T, regime, P, 0);
  if (!score_shape_ok(B, T) || !score_plan_ok(p)) return -1;
  const ScoreArgs a = score_args(vals, x, y, B, T, xsb, xst, ysb, yst);
  std::vector<double> buf(p.smem / 8 + 1);
  std::vector<Best> parts;
  for (long long row0 = 0; row0 < B; row0 += p.P) {
    const int np = (int)(B - row0 < p.P ? B - row0 : p.P);
    if (regime == kDotTree) q2_tree_block(a, row0, np, p.P, buf.data(), 0, 1, [] {});
    Best b{-INFINITY, LLONG_MAX};
    for (int g = 0; g < np; ++g) {
      const long long row = row0 + g;
      const QD r = regime == kDotTree ? q2_finish(a, row, get_at(buf.data(), p.P * p.C, g))
                                      : q2_row(a, row);
      out[row] = r.e0;
      out[B + row] = r.e1;
      out[2 * B + row] = r.e2;
      out[3 * B + row] = r.e3;
      keep(b, Best{std::fabs(r.e0), row});
    }
    parts.push_back(b);
  }
  Best q{-INFINITY, LLONG_MAX};
  for (const Best& b : parts) keep(q, b);
  *index = q.idx;
  return 0;
}

// Q4's whole call in a regime (arguments as ttq_dot's): block after
// block, each stage's items in turn, the stages in the kernel's order.  out
// (4, M, N) limb-major.  Returns 0, or -1 for a shape or plan the card's
// entry point refuses.
int ttq_host_q4(const double* const* x, const double* const* y, long long M, long long N, int T,
                long long xs0, long long xs1, long long xs2, long long ys0, long long ys1,
                long long ys2, int tree, int regime, int P, int C, double* out) {
  const DotPlan p = dot_plan_of(M, N, T, regime, P, C);
  if (!dot_shape_ok(M, N, T, tree) || !dot_plan_ok(tree, p)) return -1;
  const DotArgs a = dot_args(x, y, M, N, T, xs0, xs1, xs2, ys0, ys1, ys2, tree);
  const long long E = M * N;
  auto store = [&](long long o, const QD& r) {
    out[o] = r.e0;
    out[E + o] = r.e1;
    out[2 * E + o] = r.e2;
    out[3 * E + o] = r.e3;
  };
  auto nosync = [] {};
  std::vector<double> buf(p.smem / 8 + 1);
  for (long long o0 = 0; o0 < E; o0 += p.P) {
    const int np = (int)(E - o0 < p.P ? E - o0 : p.P);
    if (regime == kDotThread) {
      for (int g = 0; g < np; ++g) {
        store(o0 + g, tree ? q4_out<true>(a, o0 + g) : q4_out<false>(a, o0 + g));
      }
    } else if (regime == kDotTree) {
      q4_tree_block(a, o0, np, p.P, buf.data(), 0, 1, nosync);
      for (int g = 0; g < np; ++g) store(o0 + g, get_at(buf.data(), p.P * ((T + 1) / 2), g));
    } else {
      const int nch = (T + p.C - 1) / p.C;
      std::vector<QD> acc(np, QD{0.0, 0.0, 0.0, 0.0});
      for (int k = 0; k <= nch; ++k) {
        if (k < nch) q4_produce(a, o0, np, p.P, p.C, buf.data(), k, 0, 1);
        for (int g = 0; g < np && k > 0; ++g) q4_chain(a, p.P, p.C, buf.data(), k - 1, g, acc[g]);
      }
      for (int g = 0; g < np; ++g) store(o0 + g, acc[g]);
    }
  }
  return 0;
}

// Q3's whole call, P rows a block (arguments as ttq_gather_tt's, the ranks
// on the host).
void ttq_host_q3(const double* cores, const int32_t* ranks, int d, int R, int N,
                 const int32_t* ind, long long B, int P, double* out) {
  std::vector<double> smem(gather_smem(R, P) / 8);
  double* v = smem.data() + 4 * P * ((R + 1) / 2) * R;
  for (long long row0 = 0; row0 < B; row0 += P) {
    const int np = (int)(B - row0 < P ? B - row0 : P);
    q3_block(cores, ranks, d, R, N, ind, row0, np, P, smem.data(), v, 0, 1, [] {});
    for (int b = 0; b < np; ++b) {
      const QD r = get_at(v, P * R, b * R);
      out[row0 + b] = r.e0;
      out[B + row0 + b] = r.e1;
      out[2 * B + row0 + b] = r.e2;
      out[3 * B + row0 + b] = r.e3;
    }
  }
}

// qd_mul(x[k], (g[k], 0, 0, 0)) and qd_mul_f64(x[k], g[k]) for k < n: x 4
// limb pointers, out_full / out_f64 (4, n) limb-major.
void ttq_host_mul_by_f64(const double* const* x, const double* g, long long n, double* out_full,
                         double* out_f64) {
  const Limbs l = limbs_of(x);
  for (long long k = 0; k < n; ++k) {
    const QD a = qd_mul(at(l, k), QD{g[k], 0.0, 0.0, 0.0}), b = qd_mul_f64(at(l, k), g[k]);
    const double fa[4] = {a.e0, a.e1, a.e2, a.e3}, fb[4] = {b.e0, b.e1, b.e2, b.e3};
    for (int q = 0; q < 4; ++q) {
      out_full[q * n + k] = fa[q];
      out_f64[q * n + k] = fb[q];
    }
  }
}

// Q5's whole call with `threads` a block, arguments as ttq_div's
// (every pointer on the host): block after block, each thread's quotient
// in turn.  out (4, E) limb-major.  Returns 0, or -1 for a shape or block
// the card's entry point refuses.
int ttq_host_q5(const double* const* x, const double* const* y, const long long* size,
                const long long* xs, const long long* ys, int threads, double* out) {
  const DivArgs a = div_args(x, y, size, xs, ys);
  if (!div_shape_ok(a.E) || !div_block_ok(threads)) return -1;
  for (long long e0 = 0; e0 < a.E; e0 += threads) {
    for (long long e = e0; e < a.E && e < e0 + threads; ++e) {
      const QD r = q5_out(a, e);
      out[e] = r.e0;
      out[a.E + e] = r.e1;
      out[2 * a.E + e] = r.e2;
      out[3 * a.E + e] = r.e3;
    }
  }
  return 0;
}

// Q1's whole call with P rows a block, arguments as ttq_ising_c_integrand's
// (every pointer on the host; ising_rows.cuh::rows_host); out (4, B)
// limb-major.  Returns 0, or -1 for a shape or plan the card's entry point
// refuses.
int ttq_host_q1(const double* tables, int n, const int32_t* ind, long long B, int d, int P,
                double* out) {
  return rows_host<Q1Row>(tables, n, ind, B, d, P,
                          RowsOut{{out, out + B, out + 2 * B, out + 3 * B}});
}

#endif  // __CUDACC__

// Q1's launch for a shape (rows_plan): plan[0..3] = P, threads, blocks,
// shared bytes.  Returns 0, or -1 for a shape ttq_ising_c_integrand refuses.
int ttq_q1_plan(long long B, int d, int n, long long* plan) {
  if (!rows_shape_ok(B, d, n, Q1Row::kTab)) return -1;
  const RowsPlan p = rows_plan(B, d, n, Q1Row::kTab);
  const long long v[4] = {p.P, p.threads, p.blocks, p.smem};
  for (int k = 0; k < 4; ++k) plan[k] = v[k];
  return 0;
}

// Whether Q1 takes P rows a block at this shape (ttq_ising_c_integrand
// refuses the plan otherwise): 1 or 0.
int ttq_q1_plan_ok(long long B, int d, int n, int P) {
  return rows_shape_ok(B, d, n, Q1Row::kTab) &&
         rows_plan_ok(rows_plan_of(B, d, n, Q1Row::kTab, P));
}

// Q4's launch for a shape (dot_plan): plan[0..5] = regime (0 a thread per
// output, 1 chain, 2 tree), P, C, threads, blocks, shared bytes.  Returns
// 0, or -1 for a shape ttq_dot refuses.
int ttq_dot_plan(long long M, long long N, int T, int tree, long long* plan) {
  if (!dot_shape_ok(M, N, T, tree)) return -1;
  const DotPlan p = dot_plan(M, N, T, tree);
  const long long v[6] = {p.regime, p.P, p.C, p.threads, p.blocks, p.smem};
  for (int k = 0; k < 6; ++k) plan[k] = v[k];
  return 0;
}

// Q2's launch for a shape (score_plan), plan[0..5] as ttq_dot_plan's
// (regime 0 a thread per row, 2 tree).  Returns 0, or -1 for a shape
// ttq_score_residual_argmax refuses.
int ttq_score_plan(long long B, int T, long long* plan) {
  if (!score_shape_ok(B, T)) return -1;
  const DotPlan p = score_plan(B, T);
  const long long v[6] = {p.regime, p.P, p.C, p.threads, p.blocks, p.smem};
  for (int k = 0; k < 6; ++k) plan[k] = v[k];
  return 0;
}

// Q3's rows per block for (R, B) (gather_rows).
int ttq_gather_rows(int R, long long B) { return gather_rows(R, B); }

// Q5's launch for E quotients: plan[0..1] = threads (div_block), blocks.
// Returns 0, or -1 for a count ttq_div refuses.
int ttq_div_plan(long long E, long long* plan) {
  if (!div_shape_ok(E)) return -1;
  plan[0] = div_block(E);
  plan[1] = (E + plan[0] - 1) / plan[0];
  return 0;
}

}  // extern "C"
