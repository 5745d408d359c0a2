// Hand-written Hopper (sm_90a) kernels of ttcross_tpu_torch.
//
// Built by ttcross_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes by
// ttcross_tpu_torch/ops/kernels.py.  Every entry point launches on the
// stream it is given, allocates nothing (the Python wrapper allocates
// outputs and scratch with torch.empty) and returns cudaGetLastError().
//
// Both kernels compute in float64: the H100 has native FP64, so the f32
// scoring and the f32 limb split of the TPU kernels (Mosaic has no f64)
// are not carried over.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block of both kernels
constexpr int kRChunk = 8;     // rows of rowf staged in shared memory at once
constexpr int kTile = 64;      // 2-D case: a block scores a kTile x kTile tile
constexpr int kMicro = 4;      // ... each thread kMicro x kMicro elements of it
constexpr int kRTile = 16;     // ... with kRTile values of r staged per step
constexpr int kReduceThreads = 1024;

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
// number, as torch.argmax does.
//
// What bounds it: at the rook-fiber shapes of the main path ((1950, 1) and
// (1, 1950) with R = 30) the work is ~60k FMAs, so launch and memory
// latency are the whole cost.  At a full-pivoting superblock (1950 x 1950,
// ~114 M FMAs) and larger it is the f64 FMA pipe fed from shared memory:
// the 2-D kernel register-tiles 4 x 4 elements per thread so that each
// shared load feeds two FMAs; at (8192, 8192, R=32) it reaches ~20 % of
// the f64 peak and ~30 % of the memory bandwidth (PERF.md), and DMMA/TMA
// are later work.  The design keeps the residual out of device memory:
// pass 1 forms it in registers (R looped, colf/rowf staged in shared
// memory in chunks of r so any R fits), scores it and reduces each block
// to one (score, index, residual) partial; pass 2 reduces the partials in
// one block.  No atomics: the result is deterministic.
// ---------------------------------------------------------------------------

struct Best {
  double score;
  long long idx;
  double resid;
};

__device__ __forceinline__ bool better(double as, long long ai, double bs,
                                       long long bi) {
  const bool an = isnan(as), bn = isnan(bs);
  if (an || bn) return an && (!bn || ai < bi);
  return as > bs || (as == bs && ai < bi);
}

__device__ __forceinline__ Best warp_reduce(Best b) {
  for (int off = 16; off > 0; off >>= 1) {
    const double os = __shfl_down_sync(0xffffffffu, b.score, off);
    const long long oi = __shfl_down_sync(0xffffffffu, b.idx, off);
    const double orr = __shfl_down_sync(0xffffffffu, b.resid, off);
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
__device__ Best block_reduce(Best b) {
  __shared__ double s_score[32];
  __shared__ long long s_idx[32];
  __shared__ double s_resid[32];
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
      b = Best{s_score[lane], s_idx[lane], s_resid[lane]};
    } else {
      b = Best{-INFINITY, LLONG_MAX, 0.0};
    }
    b = warp_reduce(b);
  }
  return b;
}

// Fibers (K = 1 or M = 1).  Block (blockIdx.x, blockIdx.y) covers columns
// [bx*tk, bx*tk + tk) and rows [by*tm, by*tm + tm) with tm = kThreads / tk;
// thread t takes element (t / tk, t % tk) of that tile.  The wrapper picks
// tk = 1 for a column fiber (K = 1) and kThreads for a row fiber (M = 1),
// so no thread idles.  Each element's sum runs over r = 0..R-1 in order.
__global__ void __launch_bounds__(kThreads)
score_partial_kernel(const double* __restrict__ vals,
                     const double* __restrict__ colf,
                     const double* __restrict__ rowf,
                     const uint8_t* __restrict__ mask, long long M,
                     long long K, int R, int tk, double* __restrict__ part_score,
                     long long* __restrict__ part_idx,
                     double* __restrict__ part_resid) {
  __shared__ double rowf_s[kRChunk * kThreads];
  const int t = threadIdx.x;
  const int tm = kThreads / tk;
  const long long m = (long long)blockIdx.y * tm + t / tk;
  const long long k0 = (long long)blockIdx.x * tk;
  const long long k = k0 + t % tk;
  const bool inside = m < M && k < K;

  double acc = 0.0;
  for (int r0 = 0; r0 < R; r0 += kRChunk) {
    const int rc = min(kRChunk, R - r0);
    __syncthreads();  // the previous chunk has been consumed
    for (int e = t; e < kRChunk * tk; e += kThreads) {
      const int rr = e / tk;
      const long long kg = k0 + e % tk;
      rowf_s[e] = (rr < rc && kg < K) ? rowf[(long long)(r0 + rr) * K + kg] : 0.0;
    }
    __syncthreads();
    if (inside) {
      const double* crow = colf + m * R + r0;
#pragma unroll
      for (int rr = 0; rr < kRChunk; ++rr) {
        if (rr < rc) acc = fma(crow[rr], rowf_s[rr * tk + t % tk], acc);
      }
    }
  }

  Best b{-INFINITY, LLONG_MAX, 0.0};
  if (inside) {
    const long long f = m * K + k;
    const double res = vals[f] - acc;
    b = Best{mask[f] ? fabs(res) : -1.0, f, res};
  }
  b = block_reduce(b);
  if (t == 0) {
    const long long bid = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    part_score[bid] = b.score;
    part_idx[bid] = b.idx;
    part_resid[bid] = b.resid;
  }
}

// The 2-D case (M > 1 and K > 1).  A block of 16 x 16 threads scores a
// kTile x kTile tile; thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j (i, j < kMicro) in registers.  Each step stages a kTile x kRTile
// slab of colf and a kRTile x kTile slab of rowf in shared memory, after
// which every thread does kMicro^2 FMAs per 2 kMicro shared loads (the
// fiber kernel does one FMA per load).  Each element's sum still runs over
// r = 0..R-1 in order, so both kernels give the same residual bits.
__global__ void __launch_bounds__(kThreads)
score_partial_tiled_kernel(const double* __restrict__ vals,
                           const double* __restrict__ colf,
                           const double* __restrict__ rowf,
                           const uint8_t* __restrict__ mask, long long M,
                           long long K, int R, double* __restrict__ part_score,
                           long long* __restrict__ part_idx,
                           double* __restrict__ part_resid) {
  constexpr int kSide = kTile / kMicro;  // 16 threads per tile side
  __shared__ double colf_s[kTile][kRTile + 1];  // +1: rows start on new banks
  __shared__ double rowf_s[kRTile][kTile];
  const int t = threadIdx.x;
  const int tx = t % kSide;
  const int ty = t / kSide;
  const long long mb = (long long)blockIdx.y * kTile;
  const long long kb = (long long)blockIdx.x * kTile;

  double acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0;

  for (int r0 = 0; r0 < R; r0 += kRTile) {
    __syncthreads();  // the previous slabs have been consumed
    for (int e = t; e < kTile * kRTile; e += kThreads) {
      const long long m = mb + e / kRTile;
      const int rc = r0 + e % kRTile;
      colf_s[e / kRTile][e % kRTile] = (m < M && rc < R) ? colf[m * R + rc] : 0.0;
      const long long k = kb + e % kTile;
      const int rr = r0 + e / kTile;
      rowf_s[e / kTile][e % kTile] = (k < K && rr < R) ? rowf[(long long)rr * K + k] : 0.0;
    }
    __syncthreads();
    const int rn = min(kRTile, R - r0);
    for (int r = 0; r < rn; ++r) {
      double a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = colf_s[ty + kSide * i][r];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) b[j] = rowf_s[r][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
  }

  Best b{-INFINITY, LLONG_MAX, 0.0};
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const long long m = mb + ty + kSide * i;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const long long k = kb + tx + kSide * j;
      if (m < M && k < K) {
        const long long f = m * K + k;
        const double res = vals[f] - acc[i][j];
        const double sc = mask[f] ? fabs(res) : -1.0;
        if (better(sc, f, b.score, b.idx)) b = Best{sc, f, res};
      }
    }
  }
  b = block_reduce(b);
  if (t == 0) {
    const long long bid = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    part_score[bid] = b.score;
    part_idx[bid] = b.idx;
    part_resid[bid] = b.resid;
  }
}

__global__ void __launch_bounds__(kReduceThreads)
score_final_kernel(const double* __restrict__ part_score,
                   const long long* __restrict__ part_idx,
                   const double* __restrict__ part_resid, long long nparts,
                   long long* __restrict__ out_idx,
                   double* __restrict__ out_score,
                   double* __restrict__ out_resid) {
  Best b{-INFINITY, LLONG_MAX, 0.0};
  for (long long i = threadIdx.x; i < nparts; i += blockDim.x) {
    if (better(part_score[i], part_idx[i], b.score, b.idx)) {
      b = Best{part_score[i], part_idx[i], part_resid[i]};
    }
  }
  b = block_reduce(b);
  if (threadIdx.x == 0) {
    *out_idx = b.idx;
    *out_score = b.score;
    *out_resid = b.resid;
  }
}

// ---------------------------------------------------------------------------
// Kernel B: small-table lookup.
//
// Replaces ttcross_tpu/ops/pallas_kernels.py::small_table_lookup_limbs (the
// Pallas body _lookup_kernel at :127-148, pl.pallas_call at :191):
//     out[l, e] = tables[l, ind[e]]   (0 where ind[e] is outside [0, n))
// for L small f64 tables at once (the Ising integrand looks up its nodes
// and weights with one launch).  The TPU kernel selected three f32 limbs by
// an unrolled compare-select loop; here the tables sit in shared memory and
// each thread gathers its element directly, so the result is the f64 table
// entry itself, bit for bit.
//
// What bounds it: memory.  Each element reads a 4-byte index and writes
// 8*L bytes; the table reads hit shared memory.  A grid-stride loop keeps
// the block count bounded so that the table is staged a bounded number of
// times.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
lookup_kernel(const double* __restrict__ tables, int L, int n,
              const int32_t* __restrict__ ind, long long E,
              double* __restrict__ out) {
  extern __shared__ double tab_s[];
  for (int e = threadIdx.x; e < L * n; e += blockDim.x) tab_s[e] = tables[e];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += stride) {
    const int i = ind[e];
    const bool ok = i >= 0 && i < n;
    for (int l = 0; l < L; ++l) {
      out[(long long)l * E + e] = ok ? tab_s[l * n + i] : 0.0;
    }
  }
}

}  // namespace

extern "C" {

// vals/colf/rowf f64 row-major, mask one byte per element; the grid is
// (gx, gy) blocks of kThreads, of score_partial_kernel with column tile tk
// for a fiber, of score_partial_tiled_kernel (kTile x kTile) when tk = 0;
// part_* hold gx*gy partials; out_* one element each.
int ttc_score_residual_argmax(const double* vals, const double* colf,
                              const double* rowf, const uint8_t* mask,
                              long long M, long long K, int R, int tk, int gx,
                              int gy, double* part_score, long long* part_idx,
                              double* part_resid, long long* out_idx,
                              double* out_score, double* out_resid,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tk == 0) {
    score_partial_tiled_kernel<<<dim3(gx, gy), kThreads, 0, s>>>(
        vals, colf, rowf, mask, M, K, R, part_score, part_idx, part_resid);
  } else {
    score_partial_kernel<<<dim3(gx, gy), kThreads, 0, s>>>(
        vals, colf, rowf, mask, M, K, R, tk, part_score, part_idx, part_resid);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // one warp per 32 partials, up to kReduceThreads
  const long long nparts = (long long)gx * gy;
  const int threads = (int)(nparts >= kReduceThreads ? kReduceThreads : (nparts + 31) / 32 * 32);
  score_final_kernel<<<1, threads, 0, s>>>(
      part_score, part_idx, part_resid, nparts, out_idx, out_score, out_resid);
  return static_cast<int>(cudaGetLastError());
}

// tables (L, n) f64, ind E int32 elements, out (L, E) f64; blocks of
// kThreads with L*n*8 bytes of dynamic shared memory (at most 48 KB).
int ttc_small_table_lookup(const double* tables, int L, int n,
                           const int32_t* ind, long long E, double* out,
                           int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(double) * (size_t)L * (size_t)n;
  lookup_kernel<<<blocks, kThreads, smem, s>>>(tables, L, n, ind, E, out);
  return static_cast<int>(cudaGetLastError());
}

int ttc_threads_per_block(void) { return kThreads; }

int ttc_tile(void) { return kTile; }

}  // extern "C"
