// The body, launch, plan and host emulation of the two fused C-kind Ising
// integrands of the dd and qd tiers: D2 (csrc/dd_kernels.cu) and Q1
// (csrc/qd_kernels.cu).  Included by both; compiled by nvcc for the card and
// by a host C++ compiler for their host emulation (-DTTD_HOST / -DTTQ_HOST).
//
// A row f = 2 / (v w) prod_c W_c runs three independent scans over its d
// columns: the forward prefix products and their sum w, the backward ones
// and their sum v, the weight product.  With a row per thread a call issues
// the three one after the other; their sum is the row's whole sequence of
// operations, and the card's batches (65-3,575 rows) put at most one warp on
// an SM sub-partition, so a warp's sequence is the call's time.
//
// Design.  A row takes a group of kRowsLanes = 3 lanes of one warp: lane 0
// the forward scan, lane 1 the backward one, lane 2 the weight product (10
// rows a warp; lanes 30 and 31 hold no row).  The lanes of a warp run one
// instruction stream, so the three scans cost what one costs; then lane 0
// takes v and the weight product from its neighbours by __shfl_sync and
// runs the tail.  Before its one barrier a block copies the table and its
// rows' (rows, d) int32 indices into shared memory in one cp.async round
// trip (16-byte chunks), so no scan waits on a global load.
//
// Each file gives a row type Row with the element type T, its table's rows
// kTab and its lane, tail, shfl and store (D2Row, Q1Row); rows_body,
// rows_launch and rows_host below are the kernel's body, its launch and its
// host emulation for any of them.

#pragma once

#include <climits>
#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#define TTR_HD __host__ __device__ __forceinline__
#define TTR_DEV __device__ __forceinline__   // a row type's member functions (static TTR_DEV)
#else
#include <vector>
#define TTR_HD static inline
#define TTR_DEV inline
#endif

namespace {

constexpr int kRowsWarps = 4;                // warps of a block at most
constexpr int kRowsLanes = 3;                // lanes a row: forward, backward, weights
constexpr int kRowsAWarp = 32 / kRowsLanes;  // rows a warp
constexpr int kRowsThreads = 32 * kRowsWarps;
constexpr long long kRowsSmemMax = 227 * 1024;   // shared memory one block may use
constexpr int kStaticSmem = 48 * 1024;  // dynamic shared memory above this needs an opt-in

// Bytes the 16-byte chunks covering `bytes` bytes at a 4-byte aligned
// address take, at most.
TTR_HD long long span16(long long bytes) { return (bytes + 30) / 16 * 16; }

// Copies [src, src + bytes) into dst (16-byte aligned) as the 16-byte chunks
// that cover it, thread tid of nth taking chunks tid, tid + nth, ... (each
// chunk holds at least one of the range's bytes, so it lies in the range's
// allocation); on the card by cp.async, to be waited for before the barrier.
// Returns src's offset in dst, in bytes.
TTR_HD int stage_chunks(unsigned char* dst, const void* src, long long bytes, int tid, int nth) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src), base = a & ~uintptr_t(15);
  const int off = (int)(a - base);
  const long long chunks = (off + bytes + 15) >> 4;
  for (long long j = tid; j < chunks; j += nth) {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(dst + 16 * j))),
                 "l"(reinterpret_cast<const void*>(base + 16 * j)));
#else
    std::memcpy(dst + 16 * j, reinterpret_cast<const void*>(base + 16 * j), 16);
#endif
  }
  return off;
}

// A block's staged inputs: the (rows_tab, n) f64 table and its rows'
// indices, row g's at ix + g d.
struct RowsStage {
  const double* tab;
  const int32_t* ix;
};

// Shared memory: the table's chunks, then the indices' (span16 each).
TTR_HD RowsStage stage_rows(unsigned char* sm, const double* tables, int rows_tab, int n,
                            const int32_t* ind, long long row0, int np, int d, int tid,
                            int nth) {
  const long long tbytes = 8LL * rows_tab * n;
  const int toff = stage_chunks(sm, tables, tbytes, tid, nth);
  unsigned char* isb = sm + span16(tbytes);
  const int ioff = stage_chunks(isb, ind + row0 * d, 4LL * np * d, tid, nth);
  return RowsStage{reinterpret_cast<const double*>(sm + toff),
                   reinterpret_cast<const int32_t*>(isb + ioff)};
}

TTR_HD int clamp_index(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

// Thread tid's place: lane k of row g's group, k its role (0 forward, 1
// backward, 2 weights), whether g is a row of the block (else g = 0, a row
// whose indices are staged, its result unused), and whether its warp holds
// any (a warp of none returns at once, whole, so no shuffle misses a lane).
struct RowsLane {
  int g, k;
  bool on, live;
};

TTR_HD RowsLane rows_lane(int tid, int np) {
  const int lane = tid & 31, slot = lane / kRowsLanes, k = lane - slot * kRowsLanes;
  const int g0 = (tid >> 5) * kRowsAWarp, g = g0 + slot;
  const bool on = slot < kRowsAWarp && g < np;
  return RowsLane{on ? g : 0, k, on, g0 < np};
}

// The launch of one shape: P rows a block.
struct RowsPlan {
  int P, threads;
  long long blocks, smem;
};

// threads: the warps P rows take (more than a block's kRowsWarps: refused).
TTR_HD RowsPlan rows_plan_of(long long B, int d, int n, int rows_tab, int P) {
  const long long p = P < 1 ? 1 : P, warps = (p + kRowsAWarp - 1) / kRowsAWarp;
  return RowsPlan{P, 32 * (int)(warps <= kRowsWarps ? warps : kRowsWarps + 1), (B + p - 1) / p,
                  span16(8LL * rows_tab * n) + span16(4LL * p * d)};
}

TTR_HD bool rows_shape_ok(long long B, int d, int n, int rows_tab) {
  return B >= 1 && d >= 1 && n >= 1 && 8LL * rows_tab * n <= kStaticSmem &&
         rows_plan_of(B, d, n, rows_tab, 1).smem <= kRowsSmemMax;
}

TTR_HD bool rows_plan_ok(const RowsPlan& p) {
  return p.P >= 1 && p.threads <= kRowsThreads && p.blocks <= INT_MAX && p.smem <= kRowsSmemMax;
}

// The rule, measured on an H100 (chip_smoke.py --qd-regimes times one to
// four warps' rows a block at the paths' shapes; PERF.md): kRowsWarps
// warps' rows a block, no more than B nor than the shared memory holds.  A
// block's warps go to its SM's four sub-partitions, so up to 132 blocks (the
// H100's SMs) every warp issues alone, as with a warp a block, and the
// fewer blocks stage the table fewer times: D2 at (226, 5, 65) 3.90 us in 6
// blocks of 4 warps against 4.17 in 23 of one, Q1 at (1089, 3, 33) 9.26
// against 9.66; more blocks than SMs put two warps on a sub-partition: Q1 at
// (3575, 3, 65) in 149 blocks of 24 rows 13.4 against 9.5 in 112.
TTR_HD RowsPlan rows_plan(long long B, int d, int n, int rows_tab) {
  long long P = (long long)kRowsWarps * kRowsAWarp;
  if (P > B) P = B;
  const long long fit = (kRowsSmemMax - span16(8LL * rows_tab * n) - 30) / (4LL * d);
  if (P > fit) P = fit;
  return rows_plan_of(B, d, n, rows_tab, (int)(P < 1 ? 1 : P));
}

// The row's outputs: limb k of row r at p[k][r].
struct RowsOut {
  double* p[4];
};

#if defined(__CUDACC__)
template <typename Kernel>
void allow_smem(Kernel kernel, long long smem) {
  if (smem > kStaticSmem) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
}

// A block of P rows: the staging, one barrier, each lane's scan, lane 0's
// tail with its neighbours' results.
template <class Row>
__device__ __forceinline__ void rows_body(unsigned char* sm, const double* __restrict__ tables,
                                          int n, const int32_t* __restrict__ ind, long long B,
                                          int d, int P, const RowsOut& out) {
  const long long row0 = (long long)blockIdx.x * P;
  const int np = (int)(B - row0 < P ? B - row0 : P), tid = threadIdx.x;
  const RowsStage s = stage_rows(sm, tables, Row::kTab, n, ind, row0, np, d, tid, blockDim.x);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const RowsLane l = rows_lane(tid, np);
  if (!l.live) return;
  const typename Row::T r = Row::lane(s.tab, n, s.ix + l.g * d, d, l.k);
  const int first = (tid & 31) - l.k;   // the group's lane 0
  const typename Row::T v = Row::shfl(r, first + 1), pw = Row::shfl(r, first + 2);
  if (l.on && l.k == 0) Row::store(out, row0 + l.g, Row::tail(v, r, pw));
}

// The entry points' launch of `kernel` (a __global__ that runs rows_body<Row>)
// with P rows a block; cudaErrorInvalidValue for a shape or plan it refuses.
template <class Row, typename Kernel>
int rows_launch(Kernel kernel, const double* tables, int n, const int32_t* ind, long long B,
                int d, int P, const RowsOut& out, void* stream) {
  const RowsPlan p = rows_plan_of(B, d, n, Row::kTab, P);
  if (!rows_shape_ok(B, d, n, Row::kTab) || !rows_plan_ok(p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  allow_smem(kernel, p.smem);
  kernel<<<(unsigned)p.blocks, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      tables, n, ind, B, d, P, out);
  return static_cast<int>(cudaGetLastError());
}
#else
// The whole call on the host with P rows a block (every pointer on the
// host): block after block, the staging (the same 16-byte chunks), then
// every thread's lane in turn, then every group's lane 0 with its
// neighbours' results (the shuffles' lanes) through the tail.  Returns 0, or
// -1 for a shape or plan the card's entry point refuses.
template <class Row>
int rows_host(const double* tables, int n, const int32_t* ind, long long B, int d, int P,
              const RowsOut& out) {
  const RowsPlan p = rows_plan_of(B, d, n, Row::kTab, P);
  if (!rows_shape_ok(B, d, n, Row::kTab) || !rows_plan_ok(p)) return -1;
  std::vector<double> smem(p.smem / 8);
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem.data());
  std::vector<typename Row::T> lanes(p.threads);
  for (long long row0 = 0; row0 < B; row0 += P) {
    const int np = (int)(B - row0 < P ? B - row0 : P);
    const RowsStage s = stage_rows(sm, tables, Row::kTab, n, ind, row0, np, d, 0, 1);
    for (int tid = 0; tid < p.threads; ++tid) {
      const RowsLane l = rows_lane(tid, np);
      if (l.live) lanes[tid] = Row::lane(s.tab, n, s.ix + l.g * d, d, l.k);
    }
    for (int tid = 0; tid < p.threads; ++tid) {
      const RowsLane l = rows_lane(tid, np);
      const int warp = tid & ~31, first = (tid & 31) - l.k;
      if (l.on && l.k == 0) {
        Row::store(out, row0 + l.g, Row::tail(lanes[warp + ((first + 1) & 31)], lanes[tid],
                                              lanes[warp + ((first + 2) & 31)]));
      }
    }
  }
  return 0;
}
#endif  // __CUDACC__

}  // namespace
