// Hand-written Hopper (sm_90a) kernels of ttcross_tpu_torch.
//
// Built by ttcross_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c
// and linked with csrc/dd_kernels.cu's object into one shared library with
// a plain C interface, loaded with ctypes by
// ttcross_tpu_torch/ops/kernels.py.  Every entry point launches on the
// stream it is given, allocates nothing (the Python wrapper allocates
// outputs and scratch with torch.empty) and returns cudaGetLastError().
// The launch geometry (grid, block, cluster, shared memory) is chosen by
// ops/kernels.py::_plan and passed in; the kernels derive their walk over
// the matrix from gridDim and blockDim.
//
// Every kernel is a template on its scalar type S and is built for float64
// and float32 (the cross's f32 tier), each with its own entry point (the
// f32 ones end in _f32).  An instantiation computes in S throughout: the
// H100 has native FP64, so the f32 scoring and the f32 limb split of the
// TPU kernels (Mosaic has no f64) are not carried over to the f64 ones, and
// the f32 ones round as the JAX package's f32 tier does.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads per block of kernel B
constexpr int kReduceThreads = 1024;

// The fused Ising integrand: a row per thread up to kRowsDMax variables
// (blocks of kRowsThreads rows), else a row per warp up to kWarpDMax.
constexpr int kRowsThreads = 128;
constexpr int kRowsDMax = 8;
constexpr int kWarpDMax = 1024;
constexpr int kWarpThreadsMax = 256;

constexpr int kFiberThreadsMax = 512;  // block size bound of the fiber kernels

// The f32 2-D path: a SIMT tile kernel (FFMA; Hopper's f32 tensor-core path
// is TF32, which rounds the inputs).  kSimtThreads threads as 16 x 16, each
// scoring a 4 x 4 micro-tile of a kSBM x kSBN tile, R walked in chunks of
// kSKC staged in shared memory.
constexpr int kSimtThreads = 256;
constexpr int kSBM = 64;
constexpr int kSBN = 64;
constexpr int kSKC = 16;

// 2-D path tiles: a block step scores a kBM x kBN tile of (M, K); R is
// walked in chunks of kKC (zero-padded to the MMA depth of 8).  The +4
// pitches put the 16 lanes of a half-warp on 16 distinct 8-byte bank
// pairs for the A and B fragment loads.  vals and mask rows are copied as
// the 16-byte chunks that cover them, so their tile rows have room for an
// offset of up to 8 (vals) or 15 (mask) bytes.
constexpr int kTileThreads = 512;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kKC = 32;
constexpr int kStages = 3;        // depth of the cp.async ring
constexpr int kAP = kKC + 4;      // colf tile pitch (doubles)
constexpr int kBP = kBN + 4;      // rowf tile pitch (doubles)
constexpr int kVP = kBN + 4;      // vals tile pitch (doubles; 16-byte rows)
constexpr int kVChunks = (kBN * 8 + 16) / 16;  // 16-byte chunks per vals row
constexpr int kMP = 80;                        // mask tile pitch (bytes)
constexpr int kMChunks = (kBN + 16) / 16;      // 16-byte chunks per mask row
constexpr int kTileSmem =
    kStages * ((kBM * kAP + kKC * kBP + kBM * kVP) * (int)sizeof(double) + kBM * kMP);

// ---------------------------------------------------------------------------
// Kernel A: masked |residual| argmax.
//
// Replaces ttcross_tpu/ops/pallas_kernels.py::score_residual_argmax (the
// Pallas body _kernel at :39-59, pl.pallas_call at :105).  For
// vals (M, K), colf (M, R), rowf (R, K) and mask (M, K) it returns the flat
// index, the score and the signed residual of
//     argmax_f  mask[f] ? |vals[f] - (colf @ rowf)[f]| : -1
// with ties broken toward the SMALLER flat index (jnp.argmax / torch.argmax
// semantics; the TPU kernel took the last) and NaN ranking above every
// number, as torch.argmax does.  better() is a total order on (score,
// index), so every reduction tree gives the same answer: the result is
// deterministic, and no atomics are used.
//
// Two paths, picked by the shape:
//
// * Fibers (K = 1: a rook column pass, M = 1: a row pass; the main path's
//   (1950, 1) and (1, 1950) at R = 30).  ~60k FMAs and ~0.5 MB: launch and
//   memory latency are the whole cost, so the design is about latency.
//   ONE launch: a thread block cluster of up to 16 blocks (one per 128
//   elements on the main path) walks the fiber; each warp writes its best
//   to the scratch buffer and arrives on the cluster barrier, and rank 0's
//   first warp alone waits there, then reduces the partials and writes the
//   result.  The block copies its tile's factor into shared memory with
//   cp.async, every copy in flight at once; a column pass's rows of colf
//   (R contiguous doubles each) are one contiguous range, copied as 16-byte
//   chunks by neighbouring threads, instead of each thread walking its own
//   240-byte row.  Each element's sum is acc = fma(colf[m, r], rowf[r, k],
//   acc) for r = 0..R-1 in order from 0.0, then vals - acc: the bits of the
//   earlier two-pass kernel, so the cross takes the same pivots.
//
// * 2-D (M > 1 and K > 1: the full-pivoting superblock, (1950, 1950) at
//   R = 30).  Bounded by device memory: 9 bytes of vals and mask per
//   element against 2R flops (at R = 32: 7 flop/byte, below the ~20
//   flop/byte where 67 TFLOP/s of f64 tensor cores and 3.35 TB/s meet).
//   colf @ rowf runs on the f64 tensor cores (mma.sync m16n8k8 DMMA), so
//   the FMA pipe no longer limits it; a persistent grid (one block of 16
//   warps per SM) walks 64 x 64 tiles, and cp.async copies the next two
//   tiles' vals, mask, colf and rowf into a three-stage shared-memory ring
//   while the current tile is multiplied and scored.  TMA is not used: it
//   needs 16-byte row strides, which an odd K does not give.  What limits
//   it is instruction issue (copies, fragments, epilogue), so the copies
//   use fixed per-thread assignments and the epilogue compares integer
//   keys.  The per-block partials are reduced by a second, one-block
//   launch (score_final_kernel): at these shapes a call takes tens of
//   microseconds, against ~2 for that launch.  The DMMA sum runs in another
//   order than the fiber path's FMA chain; scores agree with the plain
//   version (cuBLAS) to ~1e-15 relative, and chip_smoke.py holds them to
//   1e-12.
// ---------------------------------------------------------------------------

template <typename S>
struct Best {
  S score;
  long long idx;
  S resid;
};

__device__ __forceinline__ double fma_s(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float fma_s(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double abs_s(double x) { return fabs(x); }
__device__ __forceinline__ float abs_s(float x) { return fabsf(x); }

template <typename S>
__device__ __forceinline__ bool better(S as, long long ai, S bs, long long bi) {
  const bool an = isnan(as), bn = isnan(bs);
  if (an || bn) return an && (!bn || ai < bi);
  return as > bs || (as == bs && ai < bi);
}

template <typename S>
__device__ __forceinline__ Best<S> warp_reduce(Best<S> b) {
  for (int off = 16; off > 0; off >>= 1) {
    const S os = __shfl_down_sync(0xffffffffu, b.score, off);
    const long long oi = __shfl_down_sync(0xffffffffu, b.idx, off);
    const S orr = __shfl_down_sync(0xffffffffu, b.resid, off);
    if (better(os, oi, b.score, b.idx)) {
      b.score = os;
      b.idx = oi;
      b.resid = orr;
    }
  }
  return b;
}

// Reduces over the block; the result is valid in thread 0.  blockDim.x is
// a multiple of 32 and at most 1024.
template <typename S>
__device__ Best<S> block_reduce(Best<S> b) {
  __shared__ S s_score[32];
  __shared__ long long s_idx[32];
  __shared__ S s_resid[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  b = warp_reduce(b);
  if (lane == 0) {
    s_score[warp] = b.score;
    s_idx[warp] = b.idx;
    s_resid[warp] = b.resid;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    if (lane < nwarps) {
      b = Best<S>{s_score[lane], s_idx[lane], s_resid[lane]};
    } else {
      b = Best<S>{-INFINITY, LLONG_MAX, S(0)};
    }
    b = warp_reduce(b);
  }
  return b;
}

template <typename S>
__device__ __forceinline__ void keep(Best<S>& b, S sc, long long f, S res) {
  if (better(sc, f, b.score, b.idx)) b = Best<S>{sc, f, res};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// One element of S: an 8-byte or a 4-byte copy.
__device__ __forceinline__ void cp_async_s(double* dst, const double* src) { cp_async8(dst, src); }
__device__ __forceinline__ void cp_async_s(float* dst, const float* src) { cp_async4(dst, src); }

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Fibers.  COL: K = 1, the fiber runs down colf's rows; else M = 1, along
// rowf's columns.  L is the fiber's length.  score_fiber_tiles is the walk
// that the single-fiber kernel and the kernel batched over bonds share: the
// calling block takes the fiber's tiles of blockDim.x elements first,
// first + step, ... and each thread returns the best of its elements.
// Dynamic shared memory: the tile's factor, then the R-vector that every
// element shares (rowf for COL, colf otherwise).  The factor is, for COL,
// blockDim.x rows of colf as they lie in memory (pitch R, from a 16-byte
// boundary), else R rows of blockDim.x columns of rowf.  Every copy of a
// tile is issued at once with cp.async (no register round trip), so the
// tile waits for one memory latency, not R of them.  kPer16 elements
// fill a 16-byte chunk; a COL tile's copy may start up to kPer16 - 1
// elements before its first row and end as many after its last, which the
// vector's offset leaves room for.
template <bool COL, typename S>
__device__ __forceinline__ Best<S> score_fiber_tiles(const S* __restrict__ vals,
                                                     const S* __restrict__ colf,
                                                     const S* __restrict__ rowf,
                                                     const uint8_t* __restrict__ mask,
                                                     long long L, int R, long long first,
                                                     long long step, S* fiber_s) {
  constexpr int kPer16 = 16 / (int)sizeof(S);
  const int t = threadIdx.x;
  const int T = blockDim.x;
  S* tile_f = fiber_s;
  S* vec = fiber_s + (COL ? T * R + 2 * kPer16 - 2 : T * R);
  const S* vsrc = COL ? rowf : colf;
  for (int r = t; r < R; r += T) cp_async_s(vec + r, vsrc + r);

  const long long ntiles = (L + T - 1) / T;
  Best<S> b{-INFINITY, LLONG_MAX, S(0)};
  for (long long tile = first; tile < ntiles; tile += step) {
    const long long e0 = tile * T;
    const int n = (int)min((long long)T, L - e0);
    const long long f = e0 + t;
    if (tile != first) __syncthreads();  // the previous tile has been consumed
    int off = 0;  // COL: elements between the tile's first 16-byte chunk and its first row
    if (COL) {
      // n rows of colf are one contiguous range, copied raw (pitch R) as the
      // 16-byte chunks that cover it: neighbouring threads on neighbouring
      // chunks, each chunk holding at least one byte of the range
      const uintptr_t src = reinterpret_cast<uintptr_t>(colf + e0 * R);
      const uintptr_t base = src & ~uintptr_t(15);
      off = (int)((src - base) / sizeof(S));
      const int chunks = (off + n * R + kPer16 - 1) / kPer16;
      for (int j = t; j < chunks; j += T) {
        cp_async16(tile_f + kPer16 * j, reinterpret_cast<const void*>(base + 16 * j));
      }
    } else if (t < n) {
      for (int r = 0; r < R; ++r) cp_async_s(tile_f + r * T + t, rowf + (long long)r * L + f);
    }
    cp_async_commit();
    S v = S(0);
    bool on = false;
    if (t < n) {  // in flight with the copies
      v = vals[f];
      on = mask[f] != 0;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (t < n) {
      S acc = S(0);
      if (COL && R <= 32) {
        // the main path's rank: unrolled in full, so every shared load can
        // be issued ahead of the chain (the row pass reads faster without)
        const S* a = tile_f + off + t * R;
#pragma unroll
        for (int r = 0; r < 32; ++r)
          if (r < R) acc = fma_s(a[r], vec[r], acc);
      } else if (COL) {
        const S* a = tile_f + off + t * R;
#pragma unroll 6
        for (int r = 0; r < R; ++r) acc = fma_s(a[r], vec[r], acc);
      } else {
#pragma unroll 6
        for (int r = 0; r < R; ++r) acc = fma_s(vec[r], tile_f[r * T + t], acc);
      }
      const S res = v - acc;
      keep(b, on ? abs_s(res) : S(-1), f, res);
    }
  }
  return b;
}

// One fiber.  The grid is one cluster of at most 16 blocks; its blocks take
// the tiles in turn (rank, rank + C, ...).  The scratch buffer holds one
// partial per warp of the cluster.
template <bool COL, typename S>
__global__ void __launch_bounds__(kFiberThreadsMax)
score_fiber_kernel(const S* __restrict__ vals,
                   const S* __restrict__ colf,
                   const S* __restrict__ rowf,
                   const uint8_t* __restrict__ mask, long long L, int R,
                   S* __restrict__ part_score, long long* __restrict__ part_idx,
                   S* __restrict__ part_resid, long long* __restrict__ out_idx,
                   S* __restrict__ out_score,
                   S* __restrict__ out_resid) {
  extern __shared__ __align__(16) unsigned char fiber_raw[];
  S* fiber_s = reinterpret_cast<S*>(fiber_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int t = threadIdx.x;
  const int T = blockDim.x;
  Best<S> b = score_fiber_tiles<COL, S>(vals, colf, rowf, mask, L, R, rank, C, fiber_s);
  const unsigned nparts = C * (T >> 5);
  b = warp_reduce(b);
  if ((t & 31) == 0) {
    const unsigned i = rank * (T >> 5) + (t >> 5);
    part_score[i] = b.score;
    part_idx[i] = b.idx;
    part_resid[i] = b.resid;
  }
  // release: the warps' partials are visible to whoever acquires the barrier
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  if (rank != 0 || t >= 32) return;
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  Best<S> q{-INFINITY, LLONG_MAX, S(0)};
  for (unsigned i = t; i < nparts; i += 32) {
    keep(q, __ldcg(part_score + i), __ldcg(part_idx + i), __ldcg(part_resid + i));
  }
  q = warp_reduce(q);
  if (t == 0) {
    *out_idx = q.idx;
    *out_score = q.score;
    *out_resid = q.resid;
  }
}

// P fibers in one launch, the all-bonds (jacobi) sweeps' shape: 254 or 1022
// bonds, each a fiber of R * N = 170 elements at R = 10.  JAX computes it
// per bond with XLA ops in f32 and recomputes the chosen pivot in f64
// (ttcross_tpu/cross/engine_jacobi.py:237-251, 269-282); here it is kernel
// A's fiber walk, so the residual returned is the pivot in S.  What bounds
// it: bytes, 15.2 KB per bond read once at f64 (3.9 MB at 254 bonds, ~1.2
// us at 3.35 TB/s), under a launch's own floor.  A fiber this short wants
// no cluster: one block per bond walks the bond's tiles with
// score_fiber_tiles (the single-fiber kernel's staging and FMA order, so
// the two agree bit for bit) and reduces them alone.  Bond p reads vals
// and mask at p * L, its L x R (COL) or 1 x R factor of colf and its R x 1
// or R x L (row fiber) factor of rowf, and writes out_idx[p],
// out_score[p], out_resid[p].
template <bool COL, typename S>
__global__ void __launch_bounds__(kFiberThreadsMax)
score_fiber_batched_kernel(const S* __restrict__ vals,
                           const S* __restrict__ colf,
                           const S* __restrict__ rowf,
                           const uint8_t* __restrict__ mask, long long L, int R,
                           long long* __restrict__ out_idx,
                           S* __restrict__ out_score,
                           S* __restrict__ out_resid) {
  extern __shared__ __align__(16) unsigned char fiber_raw[];
  S* fiber_s = reinterpret_cast<S*>(fiber_raw);
  const long long p = blockIdx.x;
  Best<S> b = score_fiber_tiles<COL, S>(vals + p * L, colf + p * (COL ? L * R : (long long)R),
                                        rowf + p * (COL ? (long long)R : R * L), mask + p * L,
                                        L, R, 0, 1, fiber_s);
  b = block_reduce(b);
  if (threadIdx.x == 0) {
    out_idx[p] = b.idx;
    out_score[p] = b.score;
    out_resid[p] = b.resid;
  }
}

// D = A B + D for one 16 x 8 x 8 f64 tile on the tensor cores.  Fragments
// (PTX ISA, mma.m16n8k8 .f64), with g = lane / 4 and q = lane % 4:
// a = A[g][q], A[g+8][q], A[g][q+4], A[g+8][q+4]; b = B[q][g], B[q+4][g];
// d = D[g][2q .. 2q+1], D[g+8][2q .. 2q+1].
__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[4], const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The 2-D path.  A persistent grid: block b takes tiles b, b + gridDim.x,
// ... of the ceil(M/kBM) x ceil(K/kBN) tiles (row-major), and each tile
// takes ceil(R/kKC) chunks of R: the block's "items" are (tile, chunk)
// pairs, and the copies of the next kStages - 1 items are in flight while
// item i is computed.  One barrier per item: after it, item i has landed
// and item i - 1 is consumed, so its slots are refilled then.  Sixteen warps as 4 x 4, each a 16 x 16 sub-tile
// (2 x 2 DMMA tiles).  colf/rowf elements outside the matrix or past R are
// zero, so the padded depth adds nothing; vals and mask rows are copied as
// the 16-byte chunks that hold at least one of the row's bytes (such a
// chunk lies in the same allocation), at the row address's offset in its
// chunk.  Edge elements are copied or not, and never read.  Tile and item
// counts fit in 32 bits (_plan checks), so no 64-bit division runs per
// tile.  The epilogue ranks an element by an integer key: 0 if masked,
// else the bits of |residual| (which order like the values) plus one, with
// every NaN made the same largest key; ties go to the smaller flat index.
// A thread's 8 elements of a tile are reduced as a tree, then compared
// with its running best.
__device__ __forceinline__ void ring_next(int& tl, int& kc, int& slot, int& vslot, int nk) {
  slot = slot + 1 == kStages ? 0 : slot + 1;
  if (++kc == nk) {
    kc = 0;
    ++tl;
    vslot = vslot + 1 == kStages ? 0 : vslot + 1;
  }
}

__global__ void __launch_bounds__(kTileThreads, 1)
score_dmma_kernel(const double* __restrict__ vals,
                  const double* __restrict__ colf,
                  const double* __restrict__ rowf,
                  const uint8_t* __restrict__ mask, long long M, long long K,
                  int R, double* __restrict__ part_score,
                  long long* __restrict__ part_idx,
                  double* __restrict__ part_resid) {
  extern __shared__ __align__(16) unsigned char tile_s[];
  double* As = reinterpret_cast<double*>(tile_s);  // [kStages][kBM][kAP]
  double* Bs = As + kStages * kBM * kAP;           // [kStages][kKC][kBP]
  double* Vs = Bs + kStages * kKC * kBP;           // [kStages][kBM][kVP]
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + kStages * kBM * kVP);  // [kStages][kBM][kMP]

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp >> 2) * 16;  // warp's first row in the tile
  const int wn = (warp & 3) * 16;   // ... and first column
  const int ntk = (int)((K + kBN - 1) / kBN);
  const int ntiles = (int)((M + kBM - 1) / kBM) * ntk;
  const int nk = max(1, (R + kKC - 1) / kKC);  // R = 0: one chunk of zeros
  const int mine = (int)blockIdx.x < ntiles ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int nitems = mine * nk;

  // Fixed per-thread copy assignments (kTileThreads = 512): colf tile
  // column ac of rows ai + 16 k, rowf tile column bc of rows bi + 8 k,
  // vals row vi chunks vj + 8 k, mask row t / 5 chunk t % 5.
  const int ac = t % kKC, ai = t / kKC;
  const int bc = t % kBN, bi = t / kBN;
  const int vi = t / 8, vj = t % 8;
  auto load = [&](int tl, int kc, int slot, int vslot) {
    const int tile = (int)blockIdx.x + tl * (int)gridDim.x;
    const int tm = tile / ntk;
    const long long m0 = (long long)tm * kBM, k0 = (long long)(tile - tm * ntk) * kBN;
    const int r0 = kc * kKC;
    double* A = As + slot * kBM * kAP;
    double* B = Bs + slot * kKC * kBP;
    const double* ca = colf + (m0 + ai) * R + r0 + ac;
    if (m0 + kBM <= M && r0 + kKC <= R) {
#pragma unroll
      for (int k = 0; k < kBM * kKC / kTileThreads; ++k) {
        cp_async8(A + (ai + 16 * k) * kAP + ac, ca + 16 * k * R);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kBM * kKC / kTileThreads; ++k) {
        if (m0 + ai + 16 * k < M && r0 + ac < R) {
          cp_async8(A + (ai + 16 * k) * kAP + ac, ca + 16 * k * R);
        } else {
          A[(ai + 16 * k) * kAP + ac] = 0.0;
        }
      }
    }
    const double* rb = rowf + (long long)(r0 + bi) * K + k0 + bc;
    if (k0 + kBN <= K && r0 + kKC <= R) {
#pragma unroll
      for (int k = 0; k < kKC * kBN / kTileThreads; ++k) {
        cp_async8(B + (bi + 8 * k) * kBP + bc, rb + 8 * k * K);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kKC * kBN / kTileThreads; ++k) {
        if (r0 + bi + 8 * k < R && k0 + bc < K) {
          cp_async8(B + (bi + 8 * k) * kBP + bc, rb + 8 * k * K);
        } else {
          B[(bi + 8 * k) * kBP + bc] = 0.0;
        }
      }
    }
    if (kc == 0 && m0 + vi < M) {
      const int width = (int)min((long long)kBN, K - k0);
      double* V = Vs + vslot * kBM * kVP + vi * kVP;
      const uintptr_t row = reinterpret_cast<uintptr_t>(vals + (m0 + vi) * K + k0);
      const uintptr_t base = row & ~uintptr_t(15), end = row + 8 * width;
#pragma unroll
      for (int j = vj; j < kVChunks; j += 8) {
        if (base + 16 * j < end) {
          cp_async16(V + 2 * j, reinterpret_cast<const void*>(base + 16 * j));
        }
      }
      if (t < kBM * kMChunks && m0 + t / kMChunks < M) {
        const int i = t / kMChunks, j = t % kMChunks;
        const uintptr_t mrow = reinterpret_cast<uintptr_t>(mask + (m0 + i) * K + k0);
        const uintptr_t chunk = (mrow & ~uintptr_t(15)) + 16 * j;
        if (chunk < mrow + width) {
          cp_async16(Ms + vslot * kBM * kMP + i * kMP + 16 * j,
                     reinterpret_cast<const void*>(chunk));
        }
      }
    }
  };

  unsigned long long bkey = 0;  // this thread's best: key, flat index, residual
  long long bidx = LLONG_MAX;
  double bres = 0.0;
  double acc[2][4];  // per n-tile j: rows g and g + 8, columns 2q and 2q + 1
  int ltl = 0, lkc = 0, lslot = 0, lvslot = 0;  // the next item to load
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < nitems) {
      load(ltl, lkc, lslot, lvslot);
      ring_next(ltl, lkc, lslot, lvslot, nk);
    }
    cp_async_commit();
  }
  int tl = 0, kc = 0, slot = 0, vslot = 0;  // the item computed
  for (int it = 0; it < nitems; ++it) {
    cp_async_wait<kStages - 2>();  // item it has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and item it - 1 is consumed
    if (it + kStages - 1 < nitems) {  // refill item it - 1's slots
      load(ltl, lkc, lslot, lvslot);
      ring_next(ltl, lkc, lslot, lvslot, nk);
    }
    cp_async_commit();  // possibly empty: keeps the count of groups in flight exact
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0;
    }
    const double* A = As + slot * kBM * kAP;
    const double* B = Bs + slot * kKC * kBP;
    const int ksteps = (min(kKC, R - kc * kKC) + 7) / 8;
    for (int ks = 0; ks < ksteps; ++ks) {
      const double* Ak = A + (wm + g) * kAP + 8 * ks + q;
      const double a[4] = {Ak[0], Ak[8 * kAP], Ak[4], Ak[8 * kAP + 4]};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const double* Bk = B + (8 * ks + q) * kBP + wn + 8 * j + g;
        const double bb[2] = {Bk[0], Bk[4 * kBP]};
        dmma16(acc[j], a, bb);
      }
    }
    if (kc == nk - 1) {  // the tile's product is complete: score it
      const int tile = (int)blockIdx.x + tl * (int)gridDim.x;
      const int tm = tile / ntk;
      const long long m0 = (long long)tm * kBM, k0 = (long long)(tile - tm * ntk) * kBN;
      const double* V = Vs + vslot * kBM * kVP;
      const uint8_t* Mk = Ms + vslot * kBM * kMP;
      // keys of the 8 elements, in increasing flat order: rows i, columns
      // (j, c); an element outside the matrix gets key 0 and is never
      // preferred to an element inside (which has a smaller position)
      unsigned long long key[8];
      double res[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm + 8 * i + g;
        const long long f0 = (m0 + row) * K + k0;
        const double* Vr = V + row * kVP + (int)((reinterpret_cast<uintptr_t>(vals + f0) >> 3) & 1);
        const uint8_t* Mr = Mk + row * kMP + (int)(reinterpret_cast<uintptr_t>(mask + f0) & 15);
        const bool in_row = m0 + row < M;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = wn + 8 * j + 2 * q + c;
            const int e = 4 * i + 2 * j + c;
            key[e] = 0;
            res[e] = 0.0;
            if (in_row && k0 + col < K) {
              res[e] = Vr[col] - acc[j][2 * i + c];
              if (Mr[col]) {
                const unsigned long long ab = __double_as_longlong(fabs(res[e]));
                key[e] = (ab > 0x7ff0000000000000ull ? 0x7ff8000000000000ull : ab) + 1;
              }
            }
          }
        }
      }
      int pos[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) pos[e] = e;
#pragma unroll
      for (int w = 1; w < 8; w *= 2) {  // pairwise; the right one wins only if larger
#pragma unroll
        for (int e = 0; e < 8; e += 2 * w) {
          if (key[e + w] > key[e]) {
            key[e] = key[e + w];
            res[e] = res[e + w];
            pos[e] = pos[e + w];
          }
        }
      }
      const int p = pos[0];
      const int row = wm + 8 * (p >> 2) + g, col = wn + 8 * ((p >> 1) & 1) + 2 * q + (p & 1);
      if (m0 + row < M && k0 + col < K) {
        const long long f = (m0 + row) * K + k0 + col;
        if (key[0] > bkey || (key[0] == bkey && f < bidx)) {
          bkey = key[0];
          bidx = f;
          bres = res[0];
        }
      }
    }
    ring_next(tl, kc, slot, vslot, nk);
  }
  Best<double> b{-INFINITY, LLONG_MAX, 0.0};
  if (bidx != LLONG_MAX) b = Best<double>{bkey ? fabs(bres) : -1.0, bidx, bres};
  b = block_reduce(b);
  if (t == 0) {
    part_score[blockIdx.x] = b.score;
    part_idx[blockIdx.x] = b.idx;
    part_resid[blockIdx.x] = b.resid;
  }
}

template <typename S>
__global__ void __launch_bounds__(kReduceThreads)
score_final_kernel(const S* __restrict__ part_score,
                   const long long* __restrict__ part_idx,
                   const S* __restrict__ part_resid, long long nparts,
                   long long* __restrict__ out_idx,
                   S* __restrict__ out_score,
                   S* __restrict__ out_resid) {
  Best<S> b{-INFINITY, LLONG_MAX, S(0)};
  for (long long i = threadIdx.x; i < nparts; i += blockDim.x) {
    keep(b, part_score[i], part_idx[i], part_resid[i]);
  }
  b = block_reduce(b);
  if (threadIdx.x == 0) {
    *out_idx = b.idx;
    *out_score = b.score;
    *out_resid = b.resid;
  }
}

// The 2-D path in f32 (full pivoting on the f32 tier).  No DMMA for f32 and
// no TF32 (it rounds the inputs), so colf @ rowf runs on the FMA pipe: a
// persistent grid, block b taking tiles b, b + gridDim.x, ... of the
// row-major grid of kSBM x kSBN tiles; 16 x 16 threads, each a 4 x 4
// micro-tile of rows ty + 16 i and columns tx + 16 j (neighbouring threads
// on neighbouring columns, so the epilogue's vals and mask reads coalesce).
// R is staged kSKC at a time in shared memory (colf transposed).  Each
// element's sum is acc = fmaf(colf[m, r], rowf[r, k], acc) for r = 0..R-1
// from 0, the fiber path's order, so the two paths give the same bits.  A
// correct, simple kernel: the f32 tier's main path runs rook fibers.  The
// per-block partials go to score_final_kernel, as the DMMA path's do.
__global__ void __launch_bounds__(kSimtThreads)
score_simt_kernel(const float* __restrict__ vals, const float* __restrict__ colf,
                  const float* __restrict__ rowf, const uint8_t* __restrict__ mask,
                  long long M, long long K, int R, float* __restrict__ part_score,
                  long long* __restrict__ part_idx, float* __restrict__ part_resid) {
  __shared__ float As[kSKC][kSBM + 4];  // colf chunk, transposed: As[r][m]
  __shared__ float Bs[kSKC][kSBN + 4];  // rowf chunk: Bs[r][k]
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const long long ntk = (K + kSBN - 1) / kSBN;
  const long long ntiles = ((M + kSBM - 1) / kSBM) * ntk;
  Best<float> b{-INFINITY, LLONG_MAX, 0.f};
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long m0 = (tile / ntk) * kSBM, k0 = (tile % ntk) * kSBN;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int r0 = 0; r0 < R; r0 += kSKC) {
      const int kc = min(kSKC, R - r0);
      __syncthreads();  // the previous chunk has been consumed
      for (int e = t; e < kSBM * kSKC; e += kSimtThreads) {
        const int m = e / kSKC, r = e % kSKC;
        As[r][m] = (m0 + m < M && r < kc) ? colf[(m0 + m) * R + r0 + r] : 0.f;
      }
      for (int e = t; e < kSKC * kSBN; e += kSimtThreads) {
        const int r = e / kSBN, k = e % kSBN;
        Bs[r][k] = (k0 + k < K && r < kc) ? rowf[(long long)(r0 + r) * K + k0 + k] : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < kc; ++r) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[r][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[r][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long k = k0 + tx + 16 * j;
        if (m < M && k < K) {
          const long long f = m * K + k;
          const float res = vals[f] - acc[i][j];
          keep(b, mask[f] ? fabsf(res) : -1.f, f, res);
        }
      }
    }
  }
  b = block_reduce(b);
  if (t == 0) {
    part_score[blockIdx.x] = b.score;
    part_idx[blockIdx.x] = b.idx;
    part_resid[blockIdx.x] = b.resid;
  }
}

template <bool COL, typename S>
cudaError_t launch_fiber(const S* vals, const S* colf, const S* rowf,
                         const uint8_t* mask, long long L, int R, int blocks,
                         int threads, int smem, S* part_score, long long* part_idx,
                         S* part_resid, long long* out_idx, S* out_score,
                         S* out_resid, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;  // the grid is one cluster
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, score_fiber_kernel<COL, S>, vals, colf, rowf, mask, L,
                            R, part_score, part_idx, part_resid, out_idx, out_score,
                            out_resid);
}

// ---------------------------------------------------------------------------
// Kernel B: small-table lookup.
//
// Replaces ttcross_tpu/ops/pallas_kernels.py::small_table_lookup_limbs (the
// Pallas body _lookup_kernel at :127-148, pl.pallas_call at :191):
//     out[l, e] = tables[l, ind[e]]   (0 where ind[e] is outside [0, n))
// for L small tables at once, f64 or f32.  The Ising integrand no longer
// calls it: its lookup runs inside the fused integrand kernel below.  The
// TPU kernel selected three f32 limbs by an unrolled compare-select loop;
// here the tables sit in shared memory and each thread gathers its element
// directly, so the result is the table entry itself, bit for bit.
//
// What bounds it: memory.  Each element reads a 4-byte index and writes
// sizeof(S)*L bytes; the table reads hit shared memory.  A grid-stride loop
// keeps the block count bounded so that the table is staged a bounded
// number of times.
// ---------------------------------------------------------------------------

template <typename S>
__global__ void __launch_bounds__(kThreads)
lookup_kernel(const S* __restrict__ tables, int L, int n,
              const int32_t* __restrict__ ind, long long E,
              S* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char tab_raw[];
  S* tab_s = reinterpret_cast<S*>(tab_raw);
  for (int e = threadIdx.x; e < L * n; e += blockDim.x) tab_s[e] = tables[e];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += stride) {
    const int i = ind[e];
    const bool ok = i >= 0 && i < n;
    for (int l = 0; l < L; ++l) {
      out[(long long)l * E + e] = ok ? tab_s[l * n + i] : S(0);
    }
  }
}

// ---------------------------------------------------------------------------
// The Ising integrand, fused: kernel B's redesign for Hopper.
//
// Replaces, on the integrand's path, ttcross_tpu/ops/pallas_kernels.py::
// small_table_lookup_limbs (the Pallas body _lookup_kernel at :127-148,
// pl.pallas_call at :191) together with the elementwise chain of
// ttcross_tpu/apps/ising.py::ising_integrand (:50-90) that consumed its
// output.  For ind (B, d) int32 and the (2, n) table of nodes and weights,
// row b has x_k = nodes[ind[b, k]] and w_k = weights[ind[b, k]] (both 0
// where the index is outside [0, n)), P_0 = 1 and P_k = P_{k-1} x_k, and
//     S = sum_k P_k,   Q = sum_k x_k x_{k+1} ... x_d,
//     a = prod_{i<j} ((P_j - P_i) / (P_j + P_i))^2   (den0 where P_j + P_i = 0),
//     out[b] = 2 a / ((1 + Q)(1 + S)) prod_k w_k
// with the a-term for kinds D and E only and the b-term 1/((1+Q)(1+S)) for
// C and D only (C: 2b, D: 2ab, E: 2a).  den0 is the plain version's: 0 at
// d <= 96, where it masks a (d+1) x (d+1) ratio table, 1 above, where it
// loops over columns.
//
// What bounds it: at the headline's (1950, 5), the launch.  The kernel reads
// 39 KB of indices and 1 KB of tables and writes 15.6 KB (0.017 us at
// 3.35 TB/s) and takes one launch's ~1.8 us on an H100.  At C_256's
// (100584, 255) the index reads, 103 MB, bound it at ~31 us.  The TPU
// kernel kept its (B, d, n) one-hot out of HBM; this one keeps the
// looked-up nodes and weights out of it as well: they never leave
// registers, and one launch writes one f64 per row, where kernel B wrote
// (2, B, d) f64 and ~12 eager launches read it back.
//
// Design.  The table sits in shared memory as (node, weight) pairs, one
// 16-byte load per lookup, copied with cp.async in the same batch as the
// indices, so a block waits for one memory round trip.
// * d <= kRowsDMax (the headline's d = 5): a row per thread, blocks of
//   kRowsThreads rows.  The block's rows are one contiguous range of
//   indices, copied as the 16-byte chunks that cover it (a d = 5 row read
//   by each thread from device memory would stride 20 bytes across the
//   warp); a thread reads its row from shared memory (stride d words:
//   conflict-free for odd d) and keeps x and P in registers, the loops
//   unrolled to kRowsDMax.  Every product and sum runs in the plain
//   version's order: prefix products left to right, suffix products right
//   to left, sums in index order, the pairs (i, j) row by row.
// * d > kRowsDMax (long chains, to kWarpDMax: C_1024 has d = 1023): a row
//   per warp.  The warp copies its row's indices with 16-byte cp.async;
//   each lane then walks a contiguous segment of them, left to right for
//   its prefix products and their sum, right to left for its suffix
//   products and theirs, and one multiplicative warp scan each way (shfl)
//   gives the product of the segments before (after) it, which scales its
//   sums.  A first version scanned every chunk of 32 variables instead,
//   ~100 f64 shuffles per row at d = 255 against ~30 now: 150 against
//   92 us at C_256's shape on an H100 (700 W).  A grid-stride variant that
//   copied each warp's next row while it evaluated the current one was no
//   faster (91 us), so what is left is not memory latency but the
//   instructions per row (two shared-memory lookups per variable, the
//   shuffles).  For D and E the warp keeps P in shared memory and splits
//   the O(d^2) pairs over its lanes by column j (each lane: the product
//   over i < j, as the plain version's column loop), reduced as a product.
//   The scans and reductions round in another order than the plain
//   version: within ~1e-14 for C at d = 255, ~1e-12 for D and E at
//   d ~ 100 (products of ~d^2/2 ratios of nearby prefix products).
// ---------------------------------------------------------------------------

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kKindC = 1, kKindD = 2, kKindE = 3;

// The (node, weight) pair of S: double2, or float2 for the f32 tier (an
// 8-byte load per lookup).
template <typename S>
struct PairOf;
template <>
struct PairOf<double> {
  using type = double2;
};
template <>
struct PairOf<float> {
  using type = float2;
};
template <typename S>
using Pair = typename PairOf<S>::type;

// Bytes of the table's n pairs in shared memory, rounded up to 16 so that
// what follows it starts on a 16-byte boundary.
template <typename S>
__host__ __device__ constexpr int table_bytes(int n) {
  return (n * (int)sizeof(Pair<S>) + 15) / 16 * 16;
}

// Copies the n (node, weight) pairs of tables (2, n) into tab, one
// cp.async per value, spread over the block.
template <typename S>
__device__ __forceinline__ void stage_pairs(Pair<S>* tab, const S* tables, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    cp_async_s(&tab[i].x, tables + i);
    cp_async_s(&tab[i].y, tables + n + i);
  }
}

// Copies the ints [src, src + count) to dst (16-byte aligned) as the
// 16-byte chunks that cover them, thread t of T taking chunks t, t + T, ...
// (each chunk holds at least one of the range's bytes, so it lies in the
// same allocation).  Returns the offset of src's first int in dst.
__device__ __forceinline__ int copy_ints(int32_t* dst, const int32_t* src, long long count,
                                         int t, int T) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t base = a & ~uintptr_t(15);
  const int off = (int)((a - base) >> 2);
  const long long chunks = (off + count + 3) >> 2;
  for (long long j = t; j < chunks; j += T) {
    cp_async16(dst + 4 * j, reinterpret_cast<const void*>(base + 16 * j));
  }
  return off;
}

template <typename S>
__device__ __forceinline__ Pair<S> lookup_pair(const Pair<S>* tab, int n, int i) {
  if (i >= 0 && i < n) return tab[i];
  Pair<S> z;
  z.x = S(0);
  z.y = S(0);
  return z;
}

template <typename S>
__device__ __forceinline__ S warp_sum(S v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

template <typename S>
__device__ __forceinline__ S warp_prod(S v) {
  for (int o = 16; o > 0; o >>= 1) v *= __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// The product of v over the lanes before this one (UP) or after it (else),
// 1 for the first (last) lane: an inclusive Hillis-Steele scan, shifted.
template <bool UP, typename S>
__device__ __forceinline__ S scan_exclusive_prod(S v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const S y = UP ? __shfl_up_sync(kFullMask, v, o) : __shfl_down_sync(kFullMask, v, o);
    if (UP ? lane >= o : lane + o < 32) v = UP ? y * v : v * y;
  }
  const S e = UP ? __shfl_up_sync(kFullMask, v, 1) : __shfl_down_sync(kFullMask, v, 1);
  return (UP ? lane == 0 : lane == 31) ? S(1) : e;
}

// The plain version's last steps: f = 2; f *= a; f /= (v * wv); f * prod w.
template <int KIND, typename S>
__device__ __forceinline__ S integrand_value(S a, S q, S s, S wp) {
  S f = S(2);
  if (KIND != kKindC) f = f * a;
  if (KIND != kKindE) f = f / ((S(1) + q) * (S(1) + s));
  return f * wp;
}

// A row per thread, d <= kRowsDMax.  Dynamic shared memory: n pairs.
template <int KIND, typename S>
__global__ void __launch_bounds__(kRowsThreads)
integrand_rows_kernel(const S* __restrict__ tables, int n,
                      const int32_t* __restrict__ ind, long long B, int d, S den0,
                      S* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char ising_raw[];
  Pair<S>* ising_s = reinterpret_cast<Pair<S>*>(ising_raw);
  __shared__ __align__(16) int32_t rows_s[kRowsThreads * kRowsDMax + 4];
  const int t = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * kRowsThreads;
  const int rows = (int)min((long long)kRowsThreads, B - b0);
  stage_pairs<S>(ising_s, tables, n);
  const int off = copy_ints(rows_s, ind + b0 * d, (long long)rows * d, t, kRowsThreads);
  cp_async_commit();
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (t >= rows) return;
  const int32_t* r = rows_s + off + t * d;

  S x[kRowsDMax], P[kRowsDMax + 1];
  S s = S(0), wp = S(1);
  P[0] = S(1);
#pragma unroll
  for (int k = 0; k < kRowsDMax; ++k) {
    x[k] = S(1);
    P[k + 1] = P[k];
    if (k < d) {
      const Pair<S> e = lookup_pair<S>(ising_s, n, r[k]);
      x[k] = e.x;
      P[k + 1] = P[k] * e.x;
      s += P[k + 1];
      wp *= e.y;
    }
  }
  S q = S(0);
  if (KIND != kKindE) {
    S c = S(1);
#pragma unroll
    for (int k = kRowsDMax - 1; k >= 0; --k) {
      if (k < d) {
        c *= x[k];
        q += c;
      }
    }
  }
  S a = S(1);
  if (KIND != kKindC) {
#pragma unroll
    for (int i = 0; i < kRowsDMax; ++i) {
#pragma unroll
      for (int j = i + 1; j <= kRowsDMax; ++j) {
        if (j <= d) {
          const S num = P[j] - P[i], den = P[j] + P[i];
          const S ratio = den == S(0) ? den0 : num / den;
          a *= ratio * ratio;
        }
      }
    }
  }
  out[b0 + t] = integrand_value<KIND, S>(a, q, s, wp);
}

// A row per warp, kRowsDMax < d <= kWarpDMax.  Dynamic shared memory: the n
// pairs (table_bytes), then per warp the row's indices (ipitch ints) and
// P (ppitch elements of S, a 16-byte multiple);
// ops/kernels.py::_integrand_plan sizes it with the same pitches.
template <int KIND, typename S>
__global__ void __launch_bounds__(kWarpThreadsMax)
integrand_warps_kernel(const S* __restrict__ tables, int n,
                       const int32_t* __restrict__ ind, long long B, int d, S den0,
                       S* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char ising_raw[];
  Pair<S>* ising_s = reinterpret_cast<Pair<S>*>(ising_raw);
  constexpr int kPer16 = 16 / (int)sizeof(S);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ipitch = 4 * ((d + 6) / 4);                   // room for the row at any offset in its first chunk
  const int ppitch = kPer16 * ((d + kPer16) / kPer16);    // P_0..P_d, a 16-byte multiple
  int32_t* ibuf = reinterpret_cast<int32_t*>(ising_raw + table_bytes<S>(n)) +
                  warp * (ipitch + ppitch * (int)sizeof(S) / 4);
  S* Pw = reinterpret_cast<S*>(ibuf + ipitch);
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  stage_pairs<S>(ising_s, tables, n);
  int off = 0;
  if (row < B) off = copy_ints(ibuf, ind + row * d, d, lane, 32);
  cp_async_commit();
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (row >= B) return;
  const int32_t* r = ibuf + off;
  // lane l takes the segment [k0, k1) of seg variables; seg is odd, so the
  // lanes' index reads (stride seg words) fall in distinct banks
  const int seg = ((d + 31) / 32) | 1;
  const int k0 = min(d, lane * seg), k1 = min(d, k0 + seg);

  // prefix products: the segment's own, left to right, then times the
  // product of the segments before it (an exclusive warp scan)
  S lp = S(1), ls = S(0), wp = S(1);
  for (int k = k0; k < k1; ++k) {
    const Pair<S> e = lookup_pair<S>(ising_s, n, r[k]);
    lp *= e.x;
    ls += lp;
    wp *= e.y;
    if (KIND != kKindC) Pw[k + 1] = lp;
  }
  S carry = scan_exclusive_prod<true>(lp, lane);
  const S s = warp_sum(carry * ls);
  if (KIND != kKindC) {
    for (int k = k0; k < k1; ++k) Pw[k + 1] *= carry;
    if (lane == 0) Pw[0] = S(1);
  }
  // suffix products: the segment's own, right to left, then times the
  // product of the segments after it
  S q = S(0);
  if (KIND != kKindE) {
    S rp = S(1), rs = S(0);
    for (int k = k1 - 1; k >= k0; --k) {
      rp *= lookup_pair<S>(ising_s, n, r[k]).x;
      rs += rp;
    }
    carry = scan_exclusive_prod<false>(rp, lane);
    q = warp_sum(carry * rs);
  }
  S a = S(1);
  if (KIND != kKindC) {
    __syncwarp();  // every lane's P_k is in shared memory
    for (int j = 1 + lane; j <= d; j += 32) {
      const S pj = Pw[j];
      S col = S(1);
      for (int i = 0; i < j; ++i) {
        const S pi = Pw[i];
        const S num = pj - pi, den = pj + pi;
        const S ratio = den == S(0) ? den0 : num / den;
        col *= ratio * ratio;
      }
      a *= col;
    }
    a = warp_prod(a);
  }
  wp = warp_prod(wp);
  if (lane == 0) out[row] = integrand_value<KIND, S>(a, q, s, wp);
}

template <int KIND, typename S>
void launch_integrand(int path, int blocks, int threads, int smem, cudaStream_t s,
                      const S* tables, int n, const int32_t* ind, long long B, int d,
                      S den0, S* out) {
  if (path == 0) {
    integrand_rows_kernel<KIND, S><<<blocks, threads, smem, s>>>(tables, n, ind, B, d, den0, out);
  } else {
    integrand_warps_kernel<KIND, S><<<blocks, threads, smem, s>>>(tables, n, ind, B, d, den0, out);
  }
}

// The entry points' bodies, one per scalar type (extern "C" below).
template <typename S>
cudaError_t configure(int fiber_smem) {
  cudaError_t err = cudaFuncSetAttribute(
      score_fiber_kernel<true, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, fiber_smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(score_fiber_kernel<false, S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, fiber_smem);
  }
  if (err == cudaSuccess) {  // clusters of up to 16 blocks
    err = cudaFuncSetAttribute(score_fiber_kernel<true, S>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(score_fiber_kernel<false, S>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(score_fiber_batched_kernel<true, S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, fiber_smem);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(score_fiber_batched_kernel<false, S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, fiber_smem);
  }
  return err;
}

template <typename S>
int score_residual_argmax(const S* vals, const S* colf, const S* rowf, const uint8_t* mask,
                          long long M, long long K, int R, int path, int blocks, int threads,
                          int smem, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 8-byte words: [index, score, residual, partials]; a score or a residual
  // of S sits at the start of its word
  long long* words = static_cast<long long*>(scratch);
  long long* out_idx = words;
  S* out_score = reinterpret_cast<S*>(words + 1);
  S* out_resid = reinterpret_cast<S*>(words + 2);
  const long long nparts = path == 2 ? blocks : (long long)blocks * (threads / 32);
  S* part_score = reinterpret_cast<S*>(words + 3);
  long long* part_idx = words + 3 + nparts;
  S* part_resid = reinterpret_cast<S*>(words + 3 + 2 * nparts);
  if (path == 0 || path == 1) {
    const cudaError_t err =
        path == 0 ? launch_fiber<true, S>(vals, colf, rowf, mask, M, R, blocks, threads, smem,
                                          part_score, part_idx, part_resid, out_idx,
                                          out_score, out_resid, s)
                  : launch_fiber<false, S>(vals, colf, rowf, mask, K, R, blocks, threads, smem,
                                           part_score, part_idx, part_resid, out_idx,
                                           out_score, out_resid, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (sizeof(S) == 8) {
    score_dmma_kernel<<<blocks, threads, smem, s>>>(vals, colf, rowf, mask, M, K, R,
                                                    part_score, part_idx, part_resid);
  } else {
    score_simt_kernel<<<blocks, threads, 0, s>>>(vals, colf, rowf, mask, M, K, R,
                                                 part_score, part_idx, part_resid);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rthreads =
      blocks >= kReduceThreads ? kReduceThreads : (blocks + 31) / 32 * 32;
  score_final_kernel<S><<<1, rthreads, 0, s>>>(part_score, part_idx, part_resid, blocks,
                                               out_idx, out_score, out_resid);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int score_residual_argmax_batched(const S* vals, const S* colf, const S* rowf,
                                  const uint8_t* mask, long long P, long long L, int R, int col,
                                  int threads, int smem, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 1 || P > INT_MAX || threads % 32 != 0 || threads < 32 || threads > kFiberThreadsMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 8-byte words: the P indices, then the P scores, then the P residuals
  // (of S, packed from the start of their block of P words)
  long long* words = static_cast<long long*>(out);
  long long* out_idx = words;
  S* out_score = reinterpret_cast<S*>(words + P);
  S* out_resid = reinterpret_cast<S*>(words + 2 * P);
  if (col) {
    score_fiber_batched_kernel<true, S><<<(unsigned)P, threads, smem, s>>>(
        vals, colf, rowf, mask, L, R, out_idx, out_score, out_resid);
  } else {
    score_fiber_batched_kernel<false, S><<<(unsigned)P, threads, smem, s>>>(
        vals, colf, rowf, mask, L, R, out_idx, out_score, out_resid);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int small_table_lookup(const S* tables, int L, int n, const int32_t* ind, long long E, S* out,
                       int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(S) * (size_t)L * (size_t)n;
  lookup_kernel<S><<<blocks, kThreads, smem, s>>>(tables, L, n, ind, E, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int ising_integrand(const S* tables, int n, const int32_t* ind, long long B, int d, int kind,
                    int path, int blocks, int threads, int smem, double den0, S* out,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || (path == 0 ? d > kRowsDMax || threads != kRowsThreads
                          : d > kWarpDMax || threads % 32 != 0 || threads > kWarpThreadsMax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const S z = static_cast<S>(den0);
  switch (kind) {
    case kKindC:
      launch_integrand<kKindC, S>(path, blocks, threads, smem, s, tables, n, ind, B, d, z, out);
      break;
    case kKindD:
      launch_integrand<kKindD, S>(path, blocks, threads, smem, s, tables, n, ind, B, d, z, out);
      break;
    case kKindE:
      launch_integrand<kKindE, S>(path, blocks, threads, smem, s, tables, n, ind, B, d, z, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Allows the kernels of the current device their largest shared memory
// (fiber_smem bytes for the fiber kernels of both scalar types, the most
// _plan asks for, and kTileSmem for the 2-D DMMA kernel) and the fiber
// kernels clusters of up to 16 blocks.  Call once per device before
// launching.
int ttc_configure(int fiber_smem) {
  cudaError_t err = configure<double>(fiber_smem);
  if (err == cudaSuccess) err = configure<float>(fiber_smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(score_dmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
  }
  return static_cast<int>(err);
}

// vals/colf/rowf f64 row-major, mask one byte per element.  path 0: column
// fiber (K = 1), 1: row fiber (M = 1), each one cluster of `blocks` blocks;
// 2: the 2-D kernel on `blocks` blocks, then score_final_kernel.  scratch
// holds 8-byte words: [index, score, residual] of the result, then the
// partials (one per warp of a fiber's cluster, one per block of the 2-D
// grid): their scores, their indices, their residuals.
int ttc_score_residual_argmax(const double* vals, const double* colf,
                              const double* rowf, const uint8_t* mask,
                              long long M, long long K, int R, int path,
                              int blocks, int threads, int smem, void* scratch,
                              void* stream) {
  return score_residual_argmax<double>(vals, colf, rowf, mask, M, K, R, path, blocks, threads,
                                       smem, scratch, stream);
}

// The same in f32: the 2-D path is score_simt_kernel (kSimtThreads threads,
// no dynamic shared memory); a score and a residual are f32 at the start of
// their 8-byte words.
int ttc_score_residual_argmax_f32(const float* vals, const float* colf,
                                  const float* rowf, const uint8_t* mask,
                                  long long M, long long K, int R, int path,
                                  int blocks, int threads, int smem, void* scratch,
                                  void* stream) {
  return score_residual_argmax<float>(vals, colf, rowf, mask, M, K, R, path, blocks, threads,
                                      smem, scratch, stream);
}

// Kernel A for P fibers of length L at once: vals and mask (P, L), colf
// (P, L, R) and rowf (P, R) for column fibers (col != 0), colf (P, R) and
// rowf (P, R, L) for row fibers.  One block of `threads` threads per bond
// with `smem` bytes of dynamic shared memory; out holds 8-byte words, the
// P indices, then the P scores, then the P residuals.
int ttc_score_residual_argmax_batched(const double* vals, const double* colf,
                                      const double* rowf, const uint8_t* mask,
                                      long long P, long long L, int R, int col,
                                      int threads, int smem, void* out, void* stream) {
  return score_residual_argmax_batched<double>(vals, colf, rowf, mask, P, L, R, col, threads,
                                               smem, out, stream);
}

// The same in f32: the P scores are f32 packed from the start of the P
// words that follow the indices, the P residuals from the start of the
// next P.
int ttc_score_residual_argmax_batched_f32(const float* vals, const float* colf,
                                          const float* rowf, const uint8_t* mask,
                                          long long P, long long L, int R, int col,
                                          int threads, int smem, void* out, void* stream) {
  return score_residual_argmax_batched<float>(vals, colf, rowf, mask, P, L, R, col, threads,
                                              smem, out, stream);
}

// tables (L, n) f64, ind E int32 elements, out (L, E) f64; blocks of
// kThreads with L*n*8 bytes of dynamic shared memory (at most 48 KB).
int ttc_small_table_lookup(const double* tables, int L, int n,
                           const int32_t* ind, long long E, double* out,
                           int blocks, void* stream) {
  return small_table_lookup<double>(tables, L, n, ind, E, out, blocks, stream);
}

// The same in f32: L*n*4 bytes of dynamic shared memory.
int ttc_small_table_lookup_f32(const float* tables, int L, int n,
                               const int32_t* ind, long long E, float* out,
                               int blocks, void* stream) {
  return small_table_lookup<float>(tables, L, n, ind, E, out, blocks, stream);
}

// tables (2, n) f64, ind (B, d) int32, out B f64; kind 1/2/3 for C/D/E.
// path 0: integrand_rows_kernel (d <= kRowsDMax, threads = kRowsThreads),
// 1: integrand_warps_kernel (d <= kWarpDMax, threads a multiple of 32, at
// most kWarpThreadsMax); `smem` bytes of dynamic shared memory, as
// ops/kernels.py::_integrand_plan gives them.  den0 is the ratio taken
// where P_j + P_i = 0.
int ttc_ising_integrand(const double* tables, int n, const int32_t* ind, long long B,
                        int d, int kind, int path, int blocks, int threads, int smem,
                        double den0, double* out, void* stream) {
  return ising_integrand<double>(tables, n, ind, B, d, kind, path, blocks, threads, smem, den0,
                                 out, stream);
}

// The same in f32: tables (2, n) f32, out B f32, the whole chain in f32.
int ttc_ising_integrand_f32(const float* tables, int n, const int32_t* ind, long long B,
                            int d, int kind, int path, int blocks, int threads, int smem,
                            double den0, float* out, void* stream) {
  return ising_integrand<float>(tables, n, ind, B, d, kind, path, blocks, threads, smem, den0,
                                out, stream);
}

int ttc_threads_per_block(void) { return kThreads; }

int ttc_tile_threads(void) { return kTileThreads; }

int ttc_tile_smem(void) { return kTileSmem; }

int ttc_simt_threads(void) { return kSimtThreads; }

int ttc_integrand_rows_threads(void) { return kRowsThreads; }

int ttc_integrand_rows_d_max(void) { return kRowsDMax; }

int ttc_integrand_warp_d_max(void) { return kWarpDMax; }

}  // extern "C"
