// Alternative designs of D3 (dd_gather_tt_fused), kept to be timed against
// the kernel that ships (ttcross_tpu_torch/csrc/dd_kernels.cu) by
// tools/d3_variants.py on an H100.  Nothing of the package uses them.
//
// Each computes dd_gather_tt bit for bit as the shipped kernel does: per
// core c and row b, v'[j] = sum_t dd_mul(v[t], (G_c[t, i_c, j], 0)) for t <
// r_c in order from (0, 0), the full dd_mul of the plain version; only
// which thread computes a product, and where its operands wait, differ.
//
//   kCol     the earlier kernel: a thread per column j of a row (W = 32 or 64
//            threads a row), each loading G_c[t, i, j] inside its sum, P
//            rows a block; with kAhead > 0 each thread loads its column's
//            next kAhead values while it adds the current ones.
//   kLanes   the rows' slices G_c[:, i_b, :] staged in shared memory by
//            cp.async a core ahead; a lane per column forms its products
//            from there and adds them.
//   kTurns   the slices staged as in kLanes; every thread of the block forms
//            the core's products into shared memory, then after a barrier
//            a lane per column adds its column's r products in order.
//   kShipped the shipped kernel (dd_gather_tt_kernel) with groups of G terms
//            (1, 2, 4 or 8).
//
// And the first D4 kernel, a thread per output (d4v_dot_first), to time
// beside the shipped thread regime.
//   kPipe    a chain lane per column (P warps) adds chunk k of C terms
//            from shared memory while producer warps form chunk k + 1 (a
//            double buffer, one barrier a chunk); the producers read G from
//            slices staged by cp.async a core ahead (kStage) or straight
//            from global memory.
//
// kLanes, kTurns and kPipe take ranks up to 32 (a lane per column).

#include "../ttcross_tpu_torch/csrc/dd_kernels.cu"

namespace {

enum { kCol = 0, kLanes = 1, kTurns = 2, kPipe = 3, kShipped = 4 };

struct VArgs {
  const double* __restrict__ cores;
  const int32_t* __restrict__ ranks;
  int d, R, N;
  const int32_t* __restrict__ ind;
  long long B;
};

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The np rows' slices of core c (ranks r, r2) into S[b][t][j] (pitch R x
// R), by threads tid of nth, one 8-byte cp.async each; one commit group.
__device__ void stage(const VArgs& a, double* S, const int* ix, int np, int c, int r, int r2,
                      int tid, int nth) {
  const long long step = (long long)a.N * a.R;
  const double* core = a.cores + (long long)c * a.R * step;
  const int n = r * r2;
  for (int k = tid; k < np * n; k += nth) {
    const int b = k / n, rem = k - b * n, t = rem / r2, j = rem - t * r2;
    cp_async8(S + (b * a.R + t) * a.R + j, core + t * step + (long long)ix[b * a.d + c] * a.R + j);
  }
  cp_async_commit();
}

__device__ void load_ix(const VArgs& a, int* ix, long long row0, int np, int tid, int nth) {
  for (int k = tid; k < np * a.d; k += nth) {
    const int i = a.ind[row0 * a.d + k];
    ix[k] = i < 0 ? 0 : (i >= a.N ? a.N - 1 : i);
  }
}

// The earlier kernel (W threads a row, blockDim.x / W rows a block), with
// kAhead > 0: the column's values loaded kAhead terms ahead of the adds.
template <int kAhead>
__global__ void __launch_bounds__(kThreads)
col_kernel(VArgs a, double* __restrict__ oh, double* __restrict__ ol, int W) {
  __shared__ double v[2][2][kThreads];
  const int j = threadIdx.x % W, rb = threadIdx.x / W;
  const long long row = (long long)blockIdx.x * (blockDim.x / W) + rb;
  const bool live = row < a.B;
  const int base = rb * W;
  v[0][0][base + j] = j == 0 ? 1.0 : 0.0;
  v[0][1][base + j] = 0.0;
  __syncthreads();
  int cur = 0;
  for (int c = 0; c < a.d; ++c) {
    const int r = a.ranks[c], r2 = a.ranks[c + 1];
    if (live && j < r2) {
      int i = a.ind[row * a.d + c];
      i = i < 0 ? 0 : (i >= a.N ? a.N - 1 : i);
      const long long step = (long long)a.N * a.R;
      const double* g = a.cores + (long long)c * a.R * step + (long long)i * a.R + j;
      DD acc{0.0, 0.0};
      if constexpr (kAhead == 0) {
        for (int t = 0; t < r; ++t) {
          const DD x{v[cur][0][base + t], v[cur][1][base + t]};
          acc = dd_add(acc, dd_mul(x, DD{g[t * step], 0.0}));
        }
      } else if (r > 0) {
        double next[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) next[u] = g[(u < r ? u : r - 1) * step];
        for (int t = 0; t < r; t += kAhead) {
          double now[kAhead];
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            now[u] = next[u];
            const int tn = t + kAhead + u;
            next[u] = g[(tn < r ? tn : r - 1) * step];
          }
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            if (t + u < r) {
              const DD x{v[cur][0][base + t + u], v[cur][1][base + t + u]};
              acc = dd_add(acc, dd_mul(x, DD{now[u], 0.0}));
            }
          }
        }
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

// Shared memory of kLanes / kTurns / kPipe for P rows: v hi, lo [2][P][R];
// the slices [2][P][R][R] (kStage); the products hi, lo ([P][R][32] for
// kTurns, [2][P][C][32] for kPipe); the indices [P][d] as ints.
struct VSmem {
  double *vh, *vl, *S, *ph, *pl;
  int* ix;
};

__host__ __device__ inline long long products_of(int variant, int P, int R, int C) {
  return variant == kTurns ? (long long)P * R * 32 : (variant == kPipe ? 2LL * P * C * 32 : 0);
}

__host__ __device__ inline long long vsmem_bytes(int variant, bool stage, int P, int R, int d,
                                                 int C) {
  return 8 * (4LL * P * R + (stage ? 2LL * P * R * R : 0) + 2 * products_of(variant, P, R, C)) +
         4LL * P * d;
}

__device__ VSmem vsmem_of(double* base, int variant, bool stage, int P, int R, int C) {
  VSmem s;
  s.vh = base;
  s.vl = base + 2 * P * R;
  s.S = base + 4 * P * R;
  s.ph = s.S + (stage ? 2 * P * R * R : 0);
  s.pl = s.ph + products_of(variant, P, R, C);
  s.ix = reinterpret_cast<int*>(s.pl + products_of(variant, P, R, C));
  return s;
}

// kLanes / kTurns: P rows a block; lanes (b, j) = the first 32 P threads.
template <int kVariant>
__global__ void __launch_bounds__(1024)
staged_kernel(VArgs a, int P, double* __restrict__ oh, double* __restrict__ ol) {
  extern __shared__ double dsm[];
  const int R = a.R, tid = threadIdx.x, nth = blockDim.x;
  const long long row0 = (long long)blockIdx.x * P;
  const int np = (int)(a.B - row0 < P ? a.B - row0 : P);
  const VSmem s = vsmem_of(dsm, kVariant, true, P, R, 0);
  load_ix(a, s.ix, row0, np, tid, nth);
  for (int b = tid; b < np; b += nth) {
    s.vh[b * R] = 1.0;
    s.vl[b * R] = 0.0;
  }
  __syncthreads();
  stage(a, s.S, s.ix, np, 0, a.ranks[0], a.ranks[1], tid, nth);
  cp_async_wait_all();
  __syncthreads();
  const int b = tid >> 5, j = tid & 31;
  for (int c = 0; c < a.d; ++c) {
    const int r = a.ranks[c], r2 = a.ranks[c + 1];
    const double* S = s.S + (c & 1) * P * R * R;
    if (c + 1 < a.d) stage(a, s.S + ((c + 1) & 1) * P * R * R, s.ix, np, c + 1, r2, a.ranks[c + 2],
                           tid, nth);
    const int vin = (c & 1) * P * R, vout = ((c + 1) & 1) * P * R;
    DD acc{0.0, 0.0};
    if constexpr (kVariant == kLanes) {
      if (b < np && j < r2) {
        for (int t = 0; t < r; ++t) {
          acc = dd_add(acc, dd_mul(DD{s.vh[vin + b * R + t], s.vl[vin + b * R + t]},
                                   DD{S[(b * R + t) * R + j], 0.0}));
        }
      }
    } else {
      const int n = r * r2;
      for (int k = tid; k < np * n; k += nth) {
        const int pb = k / n, rem = k - pb * n, t = rem / r2, pj = rem - t * r2;
        const DD p = dd_mul(DD{s.vh[vin + pb * R + t], s.vl[vin + pb * R + t]},
                            DD{S[(pb * R + t) * R + pj], 0.0});
        s.ph[(pb * R + t) * 32 + pj] = p.hi;
        s.pl[(pb * R + t) * 32 + pj] = p.lo;
      }
      __syncthreads();
      if (b < np && j < r2) {
        for (int t = 0; t < r; ++t) {
          acc = dd_add(acc, DD{s.ph[(b * R + t) * 32 + j], s.pl[(b * R + t) * 32 + j]});
        }
      }
    }
    if (b < np && j < r2) {
      if (c == a.d - 1) {
        if (j == 0) {
          oh[row0 + b] = acc.hi;
          ol[row0 + b] = acc.lo;
        }
      } else {
        s.vh[vout + b * R + j] = acc.hi;
        s.vl[vout + b * R + j] = acc.lo;
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

// kPipe: chain lanes (b, j) = the first 32 P threads, producers the rest.
template <bool kStage>
__global__ void __launch_bounds__(1024)
pipe_kernel(VArgs a, int P, int C, double* __restrict__ oh, double* __restrict__ ol) {
  extern __shared__ double dsm[];
  const int R = a.R, tid = threadIdx.x, nth = blockDim.x, nchain = 32 * P;
  const int ptid = tid - nchain, nprod = nth - nchain;
  const long long row0 = (long long)blockIdx.x * P;
  const int np = (int)(a.B - row0 < P ? a.B - row0 : P);
  const VSmem s = vsmem_of(dsm, kPipe, kStage, P, R, C);
  load_ix(a, s.ix, row0, np, tid, nth);
  for (int b = tid; b < np; b += nth) {
    s.vh[b * R] = 1.0;
    s.vl[b * R] = 0.0;
  }
  __syncthreads();
  if constexpr (kStage) {
    stage(a, s.S, s.ix, np, 0, a.ranks[0], a.ranks[1], tid, nth);
    cp_async_wait_all();
    __syncthreads();
  }
  const int b = tid >> 5, j = tid & 31;
  const long long step = (long long)a.N * R;
  const int chunk = P * C * 32;
  for (int c = 0; c < a.d; ++c) {
    const int r = a.ranks[c], r2 = a.ranks[c + 1];
    const double* S = s.S + (c & 1) * P * R * R;
    const double* core = a.cores + (long long)c * R * step;
    if (kStage && ptid >= 0 && c + 1 < a.d) {
      stage(a, s.S + ((c + 1) & 1) * P * R * R, s.ix, np, c + 1, r2, a.ranks[c + 2], ptid, nprod);
    }
    const int vin = (c & 1) * P * R, vout = ((c + 1) & 1) * P * R;
    const int nk = (r + C - 1) / C, n = C * r2;
    DD acc{0.0, 0.0};
    for (int k = 0; k <= nk; ++k) {
      if (ptid >= 0) {
        if (k < nk) {   // chunk k: products (b, t, j), t = k C + u, into half k & 1
          double* ph = s.ph + (k & 1) * chunk;
          double* pl = s.pl + (k & 1) * chunk;
          for (int q = ptid; q < np * n; q += nprod) {
            const int pb = q / n, rem = q - pb * n, u = rem / r2, pj = rem - u * r2;
            const int t = k * C + u;
            if (t < r) {
              const long long gi = t * step + (long long)s.ix[pb * a.d + c] * R + pj;
              const double g = kStage ? S[(pb * R + t) * R + pj] : __ldg(core + gi);
              const DD p = dd_mul(DD{s.vh[vin + pb * R + t], s.vl[vin + pb * R + t]}, DD{g, 0.0});
              ph[(pb * C + u) * 32 + pj] = p.hi;
              pl[(pb * C + u) * 32 + pj] = p.lo;
            }
          }
        }
      } else if (k > 0 && b < np && j < r2) {   // chunk k - 1, in order
        const double* ph = s.ph + ((k - 1) & 1) * chunk;
        const double* pl = s.pl + ((k - 1) & 1) * chunk;
        const int m = r - (k - 1) * C < C ? r - (k - 1) * C : C;
        for (int u = 0; u < m; ++u) {
          acc = dd_add(acc, DD{ph[(b * C + u) * 32 + j], pl[(b * C + u) * 32 + j]});
        }
      }
      __syncthreads();
    }
    if (ptid < 0 && b < np && j < r2) {
      if (c == a.d - 1) {
        if (j == 0) {
          oh[row0 + b] = acc.hi;
          ol[row0 + b] = acc.lo;
        }
      } else {
        s.vh[vout + b * R + j] = acc.hi;
        s.vl[vout + b * R + j] = acc.lo;
      }
    }
    if constexpr (kStage) cp_async_wait_all();
    __syncthreads();
  }
}

// The first D4 kernel as it was in its file (a thread per output), to
// time beside the shipped thread regime built from the same source tree.
__global__ void __launch_bounds__(kThreads)
first_dd_dot_kernel(const double* __restrict__ xh, const double* __restrict__ xl,
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

template <typename Kernel>
int launch_with(Kernel kernel, long long smem) {
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kStaticSmem) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  return 0;
}

}  // namespace

extern "C" {

// One call of `variant` with P rows and `threads` threads a block (kCol:
// threads = P W; kPipe: 32 P chain lanes and threads - 32 P producers, C
// terms a chunk; ahead: kCol's kAhead, 0, 4 or 8, or kShipped's group, 1,
// 2, 4 or 8; stage for kPipe: 0 or 1).
int d3v_gather_tt(int variant, int ahead, int stage_slices, const double* cores,
                  const int32_t* ranks, int d, int R, int N, const int32_t* ind, long long B,
                  int P, int threads, int C, double* oh, double* ol, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const VArgs a{cores, ranks, d, R, N, ind, B};
  if (B < 1 || d < 1 || P < 1 || threads < 32 || threads > 1024 || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = (unsigned)((B + P - 1) / P);
  if (variant == kShipped) {   // the shipped kernel in groups of `ahead` terms
    const GatherPlan p = gather_plan_of(B, R, d, P, threads);
    if (!gather_shape_ok(B, d, R, N) || !gather_plan_ok(p, R)) return (int)cudaErrorInvalidValue;
    const GatherArgs g{cores, ranks, d, R, N, ind, B};
    switch (ahead) {
      case 1: return static_cast<int>(gather_launch<1>(g, p, oh, ol, st));
      case 2: return static_cast<int>(gather_launch<2>(g, p, oh, ol, st));
      case 4: return static_cast<int>(gather_launch<4>(g, p, oh, ol, st));
      case 8: return static_cast<int>(gather_launch<8>(g, p, oh, ol, st));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant == kCol) {
    const int W = R <= 32 ? 32 : 64;
    if (R > 64 || threads != P * W || threads > kThreads) return (int)cudaErrorInvalidValue;
    if (ahead == 0) col_kernel<0><<<blocks, threads, 0, st>>>(a, oh, ol, W);
    else if (ahead == 4) col_kernel<4><<<blocks, threads, 0, st>>>(a, oh, ol, W);
    else if (ahead == 8) col_kernel<8><<<blocks, threads, 0, st>>>(a, oh, ol, W);
    else return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
  }
  if (R > 32 || threads < 32 * P || (variant == kPipe && (threads == 32 * P || C < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool staged = variant != kPipe || stage_slices != 0;
  const long long smem = vsmem_bytes(variant, staged, P, R, d, C);
  int rc = 0;
  if (variant == kLanes) {
    if ((rc = launch_with(staged_kernel<kLanes>, smem)) != 0) return rc;
    staged_kernel<kLanes><<<blocks, threads, smem, st>>>(a, P, oh, ol);
  } else if (variant == kTurns) {
    if ((rc = launch_with(staged_kernel<kTurns>, smem)) != 0) return rc;
    staged_kernel<kTurns><<<blocks, threads, smem, st>>>(a, P, oh, ol);
  } else if (variant == kPipe && staged) {
    if ((rc = launch_with(pipe_kernel<true>, smem)) != 0) return rc;
    pipe_kernel<true><<<blocks, threads, smem, st>>>(a, P, C, oh, ol);
  } else if (variant == kPipe) {
    if ((rc = launch_with(pipe_kernel<false>, smem)) != 0) return rc;
    pipe_kernel<false><<<blocks, threads, smem, st>>>(a, P, C, oh, ol);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The first D4 kernel in blocks of 256 (its launch), arguments as
// ttd_dot's.
int d4v_dot_first(const double* xh, const double* xl, const double* yh, const double* yl,
                long long M, long long N, int T, long long xs0, long long xs1, long long xs2,
                long long ys0, long long ys1, long long ys2, double* oh, double* ol,
                void* stream) {
  const unsigned blocks = (unsigned)((M * N + kThreads - 1) / kThreads);
  first_dd_dot_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xh, xl, yh, yl, M, N, T, xs0, xs1, xs2, ys0, ys1, ys2, oh, ol);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
