#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ttcross_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the check: build, kernels, main path
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of
                                     # one steady headline run, of the
                                     # steady long-chain runs, of the long
                                     # chain's parts per call, of the MVN
                                     # runs, of a maxvol sweep's parts and
                                     # of the capped and the f32 C_6 runs
    python3 chip_smoke.py --parent DIR   # also times the kernels and the
                                     # integrand of another checkout (e.g.
                                     # the parent commit, unpacked with git
                                     # archive) against this one's, in
                                     # turns, in one process

Phases, each printing its result as it goes:
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. build the CUDA kernels from ttcross_tpu_torch/csrc/ with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (and larger ones), with both times per
     call (CUDA events, median of 20), the device-only time and kernels
     per call (torch.profiler), the bound (bytes over 3.35 TB/s or f64
     flops over 67 TFLOP/s, whichever is larger) and its share, and for
     kernel B the one PyTorch call that computes the same gather; a rook
     pass's kernel-A call must be one kernel; then the wrappers' host time
     per call; the fused Ising integrand (kernel B's redesign) against its
     plain version at the headline's batch shapes (C, D and E at d = 5)
     and at the long chain's (C_256 without the chain: fibers (43180, 255)
     and lottery (13716, 255); the init batches of C_256 and C_1024), one
     kernel per call; kernel B at every shape the chain's lift gives it
     (C_256 and C_1024); kernel A batched
     over bonds at the long chain's shapes (254 and 1022 bonds, fibers of
     170, R = 10; half of the bonds fully masked) against its plain version
     and, bit for bit, against one single-fiber launch per bond; kernel A
     and kernel B at every shape the MVN / COS path gives them (mvn_shapes:
     the rook fibers at ranks 20, 26 and 8, the lottery and init batches,
     the maxvol fiber crosses (26000, 6) and (43940, 6)); and the f32
     instantiation of every kernel (f32_cases) at the shapes the f32 runs
     of phase 14 give it, and kernel A's 2-D path (the SIMT kernel), the
     batched kernel A and the integrand's warp path at the f64 phase's;
  4. the main path: the f64 cross on the Ising C_6 integrand at rank 24
     with oversample=6 (bench.py's headline configuration) on the card,
     twice with key 0 (first and steady time; the kernels' launch counts
     of the first run: kernel A and the fused integrand must have
     launched, at shapes that phase 3 held; the standalone lookup, off this
     path, is reported), then keys 1-7; the digits against the analytic
     C_6; the rounding of each key's rank-30 train on the card against
     the same rounding on the host; and a small C_5 cross on the card
     against the same cross on the CPU, with rook and with full pivoting
     (kernel A's 2-D path);
  5. the greedy (no oversample) C_6 cross, holding its state on the card;
  6. the long chain: the Ising C_256 cross at rank 10, n = 17, with
     sweep_mode="jacobi-rb" and chain=p.chain (bench.py's long-chain
     configuration, d = 255), first and steady call and keys 0-7, its
     state and carried chain states on the card, the batched kernel A and
     kernel B (the chain's lift) launched; then jacobi-rb without the
     chain (the fused integrand on (43180, 255) batches), jacobi with it,
     and C_1024 (d = 1023), each over keys 0-7 against its own digit
     floors; every run's launches by
     shape, each a shape that phase 3 held against the plain version;
  7. the MVN / COS option-pricing path at the sizes of the reference's
     test programs: the MVN pdf at d = 6, n = 65, rank 20, greedy, with oversample=6 and
     with refine_sweeps=2 (alternating maxvol), each over keys 0-7 against
     its digit floors, and with the weighted lottery; the rank-20 train
     contracted against complex128 weights; the basket's characteristic
     function against the rho = 0.5 goldens and its COS density; the COS
     coefficient tensor with accchk over 2^14 samples; stdnorm at d = 10;
     a serialization round trip through the reference's 'TT' stream; and a
     small MVN cross on the card against the CPU.  Kernel B (the node
     lookup) and kernel A must have launched, at shapes that phase 3 held;
  8. the headline exactly as bench.py runs it, cross(..., oversample=6,
     host_reeval=True), keys 0-7 against the headline's floors, beside the
     device-only train of each key from phase 4: its n_evals are the device
     run's plus the skeleton's samples, evaluated by one fused-integrand
     launch at the skeleton's batch (held like phase 3's shapes once the
     run has shown it);
  9. the 4-lane mvn_d6 family of bench.py's mvn_family_batch (cross_batch,
     rank 20, corr 0.2-0.6), first and steady, then each lane's single
     cross() with its lane_key: lanes equal to their single runs, the worst
     lane above its floor, kernel B once per lane-batched integrand step and
     kernel A batched over the lanes, launches of the batch against a single
     run's;
 10. the Greeks of drivers/crs_greeks.py (d = 6, n = 65, rank 14): a cross at
     rho0, its frozen skeleton, torch.func.grad of the skeleton value against
     a central difference, and the torch.func.vmap rho sweep of values and
     Greeks against the pointwise ones;
 11. the capped and chunked C_6 (rank 24, rank_chunks=[4, ..., 24],
     rank_caps=[16, 24, 24, 16]) over keys 0-7, each key's padded ratio and
     digits held; rank_chunks="auto" and the uncapped run at key 0 beside it;
     the per-bond, per-chunk shapes held as phase 3 holds its own;
 12. stdnorm_d10 with and without adaptive=True: n_evals, digits, walls,
     and adaptive sweeps under torch's sync debug mode set to raise;
 13. quantics: exp(x) sin(6 pi x) on 2^20 points, greedy (the plateau) and
     with refine_sweeps=1 (< 1e-12 at x = i/64), exp's Riemann sum, a 2-D
     Gaussian;
 14. the f32 tier: C_6 (rank 24) in float32 over keys 0-7 and mvn_d6 greedy
     in float32, through the kernels' f32 instantiations only;
 15. the dd tier (csrc/dd_kernels.cu's kernels D1-D4): cross_dd on Ising C_4
     exactly as bench.py's ising_c4_dd_tier (n = 33, rank 16; keys 0-7,
     first and steady), C_4 at n = 65, rank 32 (the dd arithmetic limit),
     C_6 at n = 65, rank 48, the defect-corrected C_6 (ranks 32, 48) and
     stdnorm_d4 (rank 6), each against its digit floor (DD_FLOORS); a small
     cross_dd (C_4, n = 17, rank 8) on the card equal to the same run on the
     CPU, values, pivots and ranks; two dd sweeps and a defect-integrand call
     under torch's sync debug mode set to raise; every dd kernel held bit for
     bit against its plain version at every shape these runs launched it
     at, with device time, kernels per call, bound (f64 vector flops) and
     host time per call;
 16. the distributed engines (ttcross_tpu_torch/parallel/), their ranks
     spawned by this script (parallel/launch.py): one NCCL rank's
     cross_parallel of bench.py's parallel line (C_32, n = 16, rank 8) and
     of the long chain (C_256 jacobi-rb + chain) against cross() fed the
     same uniforms; two gloo ranks on cuda:0 (NCCL refuses two ranks on one
     card) for C_32 sequential and jacobi-rb and the long chain over keys
     0-3, both ranks one result, key 0 equal to two ranks on the CPU;
     cross_dd_parallel at ising_c4_dd_tier, pcontract of the chf family,
     accchk(mesh=) and cross_batch(mesh=) of the 4-lane mvn_d6 family; and
     cross_batch(sweep_mode="jacobi") of that family, each lane its single
     jacobi run.  Every rank's launches are held as phase 3 holds its
     shapes;
 17. the qd tier (csrc/qd_kernels.cu's kernels Q1-Q4): cross_qd on Ising C_4
     at n = 65, rank 55 (the JAX package's 64.2-digit record configuration;
     digits, wall, n_evals, launches, host reads per bond visit, the card's
     busy share from one profiled run), bench.py's stdnorm_d4_qd_engine
     (ranks 1, 9,666 evaluations, >= 60 digits), cross_defect_corrected_qd at
     drivers/crs_ising_qd.py's defaults, cross_qd_parallel with two spawned
     workers on the card equal to two on the CPU, refine_dd on the JAX
     package's two test cases and a small cross_qd against the CPU; every qd
     kernel held bit for bit against its plain version at every shape these
     runs launched it at, with device time, bound and host time at the
     shape of each path that holds the most work;
 18. the host libraries, the mp tier and the drivers: both native libraries
     built with g++ (seconds) and the MPFR ABI self-test;
     ising_cross_mp_native at bench.py's ising_c4_mp120_native equal to the
     CPU run; cross_mp and cross_mp_parallel (two spawned workers) equal to
     the JAX package's CPU runs, string for string; the eight drivers of
     ttcross_tpu_torch/drivers/ in process on the card (digits held to their
     CPU floors, walls, launches per kernel), the dd / qd drivers' kernels
     launched and held at every shape; the mp tier launches nothing.
The line before the last is the kernels' JSON summary, one entry for every
(kernel, shape) that the C_6 headline, the C_256 long chain, each
configuration of phase 7 and phases 8-16 launched at (an f32 launch's entry
named <kernel>_f32), with that run's launches at the shape beside phase 3's
error, times and bound there, and one entry for every (qd kernel, path) of
phases 17-18 (its launches on the path, the shapes held, the times and bound
at the path's heaviest shape), and phase 18's dd / qd drivers' paths
beside them; the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero.
It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

KERNEL_SOURCE = "ttcross_tpu_torch/csrc/kernels.cu"
DD_KERNEL_SOURCE = "ttcross_tpu_torch/csrc/dd_kernels.cu"
QD_KERNEL_SOURCE = "ttcross_tpu_torch/csrc/qd_kernels.cu"
MAIN_PATH_KERNELS = ("score_residual_argmax", "ising_integrand_fused")
LONG_CHAIN_KERNELS = ("score_residual_argmax_batched", "small_table_lookup")
LONG_CHAIN = dict(n=17, max_rank=10, accuracy=500 * 2.2e-16, pivoting=1)
# The long chain's digits over the lottery key, from CPU runs of both
# packages over keys 0-7 at each configuration (C_m, n = 17, rank 10;
# PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_jacobi.py m mode
# chain|plain prints them).  Port / JAX package, whose hunt ranks residuals
# in f32, as minimum, median, maximum:
#   C_256  jacobi-rb + chain  11.37 12.02 12.57 / 9.81 10.58 11.08
#   C_256  jacobi-rb, plain   11.37 12.01 12.57 / 9.81 10.58 11.08
#   C_256  jacobi + chain     10.62 11.61 12.51 / 9.35 10.04 11.17
#   C_1024 jacobi-rb + chain  11.25 12.01 13.27 / 10.03 10.66 11.14
# The card draws the port's uniforms, so every configuration is run over
# keys 0-7 and held near the port's CPU runs: the median at most 0.7 below
# the port's CPU median, and each key above the JAX package's median.
LC_FLOORS = {  # (m, mode, chain): (median of keys 0-7, each key)
    (256, "jacobi-rb", True): (11.3, 10.5),
    (256, "jacobi-rb", False): (11.3, 10.5),
    (256, "jacobi", True): (10.9, 10.0),
    (1024, "jacobi-rb", True): (11.3, 10.6),
}
LC_EVALS_MAX = 215_323      # the C++ twin's evals at C_256 (baseline/measured.json)
BATCHED_RTOL = 1e-14        # batched kernel A vs its plain version, of the largest residual
HEADLINE = dict(m=6, n=64, max_rank=24, accuracy=500 * 2.2e-16, pivoting=1)
# The digits are a random variable over the lottery key.  Keys 0-47 of the
# JAX package on the CPU give 12.71-15.35 oversampled (3 of 48 below 13.0;
# the medians of its six blocks of 8 keys are 13.54-13.86), and the port on
# the CPU fed the same uniforms 12.93-14.91 (PERF.md).  So the oversampled
# check holds the median of keys 0-7 and a floor for each key, and the
# rounding stage, where the card once lost ~0.3 digits, is held to the
# host's rounding of the same train; the greedy check holds key 0
# (JAX: 11.9-12.9, BENCH_NOTES.md:306).
DIGITS_MEDIAN = 13.3
DIGITS_FLOOR = 12.5
DIGITS_GREEDY = 11.5
ROUND_RTOL = 1e-14          # card vs host rounding of one train: SVDs of
                            # the same matrices in other orders
KEYS = range(8)
# The MVN / COS path (bench.py's configurations mvn_d6, mvn_d6_refined,
# coscoeff_d6, stdnorm_d10, mvn_complex_d6).  Its digits over the lottery
# key, from CPU runs of both packages over keys 0-7
# (PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_apps_mvn.py prints
# them; PERF.md section 2 has the table).  Port / JAX package as minimum,
# median, maximum:
#   mvn_d6 greedy            5.33 5.88 6.37 / 5.54 5.98 7.57
#   mvn_d6 oversample=6      7.43 7.53 7.58 / 7.37 7.50 7.59
#   mvn_d6 refine_sweeps=2   6.75 6.85 7.01 / 6.59 6.81 7.21
#   mvn_d6 weighted lottery  5.63 5.98 7.04 / 5.59 6.20 7.24
#   stdnorm_d10              3.43 (the 33-point rule's own error, every key)
#   coscoeff_d6, -log10 of accchk's einf / ainf  5.08 5.47 5.97 / 5.38 5.90 6.13
# Far from machine precision: rank 20 carries the MVN pdf to ~1e-6, and the
# floors are held accordingly: the median of keys 0-7 at most 0.5 below the
# port's CPU median, each key above a floor under both packages' minima.
MVN = dict(d=6, n=65, max_rank=20, accuracy=500 * 2.2e-16, pivoting=1)
MVN_FLOORS = {  # variant: (median of keys 0-7, each key)
    "greedy": (5.4, 4.9),
    "oversample6": (7.0, 6.8),
    "refined2": (6.35, 6.0),
}
MVN_VARIANTS = {"greedy": {}, "oversample6": {"oversample": 6}, "refined2": {"refine_sweeps": 2}}
MVN_WEIGHTED_FLOOR = 5.2    # key 0 with the weighted lottery
MVN_COMPOSED_FLOOR = 7.2    # key 0 with oversample=6 and refine_sweeps=2 (CPU keys 0-3: 7.56-7.57)
STDNORM = dict(d=10, n=32, max_rank=8, accuracy=5 * 2.2e-16, pivoting=1)
STDNORM_DIGITS = 3.3
COS_ACCCHK_REL = 1e-4       # coscoeff_d6 at rank 20: accchk's einf / ainf over 2^14 samples
COMPLEX_RTOL = 1e-13        # complex contraction vs the real one, and its imaginary part
MVN_KERNELS = ("score_residual_argmax", "small_table_lookup")
# The family (bench.py:707-741's mvn_family_batch): mvn_d6 at rank 20 over
# four correlations in one cross_batch, every lane against its single run.
FAMILY_LANES = 4
FAMILY_KERNELS = ("score_residual_argmax_batched", "small_table_lookup")
FAMILY_RTOL = 1e-13         # a lane's values against its single run's
# Worst-lane digits of the family over keys 0-3, from CPU runs of both
# packages (PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_batch.py;
# the worst lane is always corr 0.6, the others reach 6.4-12.8):
#   port 3.93 4.33 5.34 4.56 / JAX package 3.74 6.36 4.19 4.81
# Key 0 is held under both packages' minimum.
FAMILY_WORST_FLOOR = 3.5
# The Greeks (drivers/crs_greeks.py at its defaults): d = 6, n = 65, rank
# 14, rho0 = 0.5, 5 rho points in [0.3, 0.7]; crs_greeks.py's own sanity check
# holds torch.func.grad of the skeleton value to its central difference.
GREEKS = dict(d=6, n=65, max_rank=14, rho0=0.5, nrho=5, key=5)
GREEK_FD_RTOL = 1e-5        # grad against the central difference (h = 1e-5)
GREEK_VALUE_RTOL = 1e-10    # the skeleton value at rho0 against the cross's
GREEK_SWEEP_RTOL = 1e-10    # the vmapped rho sweep of values against the pointwise ones: the
                            # batched solves round otherwise, and the late pivot submatrices of
                            # the rank-14 skeleton are near-singular (CPU: 2.3e-11); its Greeks
                            # are held as the gradient is, to GREEK_FD_RTOL * max(1, |greek|)
# The capped and chunked C_6 (tests/test_engine.py:284-297, the JAX package's
# slow test, and bench.py:630-636's padded-ratio line): every key's padded
# evaluations within 1.25x of its active ones and >= 11 digits.
CAPPED = dict(m=6, n=64, max_rank=24, accuracy=500 * 2.2e-16, pivoting=1,
              rank_chunks=[4, 8, 12, 16, 20, 24], rank_caps=[16, 24, 24, 16])
CAPPED_PADDED_RATIO = 1.25
CAPPED_DIGITS = 11.0
# Quantics (tests/test_quantics.py:104-125): exp(x) sin(6 pi x) on 2^20
# points; the greedy train plateaus above 1e-9 point error, one maxvol sweep
# brings it under 1e-12.
QUANTICS = dict(K=20, max_rank=10, pivoting=2, accuracy=1e-13)
QUANTICS_PLATEAU = 1e-9
QUANTICS_REFINED = 1e-12
# The f32 tier: C_6 (n = 65, rank 24) and mvn_d6 (n = 65, rank 20) in
# float32, rook, accuracy 1e-6.  Digits over keys 0-7 on the CPU, port /
# JAX package (TTCROSS_NO_X64=1), as minimum, median, maximum
# (PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_f32.py prints them):
#   C_6    6.69 6.95 7.15 / 6.32 6.82 7.68
#   mvn_d6 3.38 4.37 4.83 / 3.85 4.30 5.07   (key 0: 4.49 / 4.73)
# C_6 is held at its median of keys 0-7 and each key under both minima;
# mvn_d6 at key 0 under both minima.
F32_ACCURACY = 1e-6
F32_FLOORS = {"C_6": (6.5, 6.2), "mvn_d6": 3.3}
KERNEL_REPLACES = {   # the TPU kernel each CUDA kernel stands for
    "score_residual_argmax": "ttcross_tpu/ops/pallas_kernels.py:62",
    "score_residual_argmax_batched": "ttcross_tpu/ops/pallas_kernels.py:62",
    "small_table_lookup": "ttcross_tpu/ops/pallas_kernels.py:151",
    "ising_integrand_fused": "ttcross_tpu/ops/pallas_kernels.py:151",
    # the dd tier's variants (csrc/dd_kernels.cu): D1 and D4 of kernel A's
    # residual and its dd products, D2 and D3 of the lookup kernel's gathers
    "dd_score_residual_argmax": "ttcross_tpu/ops/pallas_kernels.py:62",
    "dd_dot": "ttcross_tpu/ops/pallas_kernels.py:62",
    "ising_c_integrand_dd_fused": "ttcross_tpu/ops/pallas_kernels.py:151",
    "dd_gather_tt_fused": "ttcross_tpu/ops/pallas_kernels.py:151",
    # the qd tier's (csrc/qd_kernels.cu): Q2 and Q4 of kernel A's residual and
    # its products, Q1 and Q3 of the lookup kernel's gathers
    "qd_score_residual_argmax": "ttcross_tpu/ops/pallas_kernels.py:62",
    "qd_dot": "ttcross_tpu/ops/pallas_kernels.py:62",
    "ising_c_integrand_qd_fused": "ttcross_tpu/ops/pallas_kernels.py:151",
    "qd_gather_tt_fused": "ttcross_tpu/ops/pallas_kernels.py:151",
}
F32_KERNELS = ("score_residual_argmax", "score_residual_argmax_batched", "small_table_lookup",
               "ising_integrand_fused")   # the kernels with an f32 instantiation
DD_KERNELS = ("dd_score_residual_argmax", "dd_dot", "ising_c_integrand_dd_fused",
              "dd_gather_tt_fused")
QD_KERNELS = ("qd_score_residual_argmax", "qd_dot", "ising_c_integrand_qd_fused",
              "qd_gather_tt_fused")
# The dd tier (phase 15).  Digits of each configuration over its keys, from
# CPU runs of both packages (PYTHONPATH=. JAX_PLATFORMS=cpu python
# tests/test_torch_engine_dd.py prints them), port / JAX package as minimum,
# median, maximum.  The floors are the JAX package's own test bounds
# (tests/test_engine_dd.py:25-47, tests/test_defect.py:53-61,
# tests/test_dd.py:168-190), under both packages' CPU minima; every key run
# on the card is held to its floor.
#   ising_c4_dd_tier   keys 0-7  17.69 18.62 18.98 / 18.05 18.78 19.64
#   c4_n65_r32         keys 0-7  31.35 31.64 32.72 / 30.87 30.97 31.13
#   c6_n65_r48         key 0     17.31 / 18.35
#   defect_c6          key 0     16.42 / 16.24
#   defect_stdnorm_d4  keys 0-7  15.92 every key / 15.92 every key
DD_RUNS = {   # name: (problem, m or d, n, "dd" | "defect", ranks, keys)
    "ising_c4_dd_tier": ("ising", 4, 33, "dd", (16,), range(8)),
    "c4_n65_r32": ("ising", 4, 65, "dd", (32,), range(8)),
    "c6_n65_r48": ("ising", 6, 65, "dd", (48,), range(1)),
    "defect_c6": ("ising", 6, 65, "defect", (32, 48), range(1)),
    "defect_stdnorm_d4": ("stdnorm", 4, 65, "defect", (6, 6), range(8)),
}
DD_FLOORS = {"ising_c4_dd_tier": 16.0, "c4_n65_r32": 28.0, "c6_n65_r48": 17.0,
             "defect_c6": 15.5, "defect_stdnorm_d4": 14.5}
DD_PATH_KERNELS = {"dd": ("dd_score_residual_argmax", "dd_dot", "ising_c_integrand_dd_fused"),
                   "defect": ("score_residual_argmax", "ising_integrand_fused",
                              "ising_c_integrand_dd_fused", "dd_gather_tt_fused", "dd_dot"),
                   "defect_stdnorm": ("score_residual_argmax", "small_table_lookup",
                                      "dd_gather_tt_fused", "dd_dot")}
DD_MUL_FLOPS, DD_ADD_FLOPS = 24, 11   # ops/dd.py: two_prod 17 + cross terms 4 + quick_two_sum 3;
                                      # two_sum 6 + 2 adds + quick_two_sum 3
F64_VECTOR_FLOPS = 33.5e12  # H100 SXM f64 outside the tensor cores (dd cannot use them)
SCORE_RTOL = 1e-12          # kernel A vs cuBLAS: f64 sums in another order
                            # (the 2-D path's DMMA tiles in yet another)
F32_RTOL = 1e-5             # an f32 kernel vs its plain version in f32 (cuBLAS sgemm without
                            # TF32, torch's cumprod): sums in another order, a few f32 ulps of
                            # the largest term; the fused integrand's D / E a-terms magnify an
                            # ulp of nearby prefix products (_integrand_rtol)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, 700 W
F64_FLOPS = 67e12           # ... f64 on the tensor cores, the card's f64 peak
F32_FLOPS = 67e12           # ... f32 outside the tensor cores (the f32 kernels run on the FMA pipe)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _time_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _score_inputs(gen, M, K, R, dev, dtype=None):
    """Random kernel-A inputs whose best score is clear of the second best
    by more than rounding (so the index is well defined): f64, or f32
    (dtype=torch.float32, clear by more than f32 rounding)."""
    import torch

    f32 = dtype == torch.float32
    while True:
        vals, colf, rowf = (torch.randn(s, generator=gen, dtype=torch.float64)
                            for s in ((M, K), (M, R), (R, K)))
        if f32:
            vals, colf, rowf = (x.float().double() for x in (vals, colf, rowf))
        mask = torch.rand((M, K), generator=gen) > 0.2
        resid = (vals - colf @ rowf).abs()
        top = torch.topk(torch.where(mask, resid, -1.0).reshape(-1), 2).values
        if float(top[0] - top[1]) > (1e-4 if f32 else 1e-9) * float(top[0]):
            dt = torch.float32 if f32 else torch.float64
            return tuple(x.to(dev, dt) for x in (vals, colf, rowf)) + (mask.to(dev),)


def _tag(t) -> list:
    """What an f32 launch's shape carries in launch_shapes() (ops/kernels.py)."""
    import torch

    return ["f32"] if t.dtype == torch.float32 else []


def _bound_us(nbytes: int, flops: int, esz: int = 8):
    """The least time the card could take: bytes over the memory rate or
    flops over the peak of the element type (esz bytes: f64 on the tensor
    cores, f32 outside them), whichever is larger, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / (F64_FLOPS if esz == 8 else F32_FLOPS)
    return max(t_bytes, t_ops) * 1e6, ("bytes" if t_bytes >= t_ops else "operations")


def _score_bound(M, K, R, esz=8):
    # vals, colf, rowf and the mask read once; three 8-byte result words written
    return _bound_us(esz * (M * K + M * R + R * K) + M * K + 24, 2 * M * K * R, esz)


def _batched_bound(P, M, K, R, esz=8):
    # per bond: vals, colf, rowf and the mask read once, three 8-byte result words written
    return _bound_us(P * (esz * (M * K + M * R + R * K) + M * K + 24), 2 * P * M * K * R, esz)


def _lookup_bound(L, E, n, esz=8):
    # the tables and the int32 indices read once, L outputs per index
    return _bound_us(esz * L * n + 4 * E + esz * L * E, 0, esz)


def _integrand_bound(kind, B, d, n, esz=8):
    # the int32 indices and the (2, n) table read once, one value per row
    # written; per variable a prefix product and a weight product, for C
    # and D also the prefix sum and the suffix product and sum; for D and
    # E five operations per pair i < j (difference, sum, ratio, square,
    # product); four per row to combine
    per_row = 2 * d + (3 * d if kind in "CD" else 0) + (5 * d * (d + 1) // 2 if kind in "DE" else 0)
    return _bound_us(4 * B * d + 2 * esz * n + esz * B, B * (per_row + 4), esz)


def _integrand_rtol(kind, d, on_card, f32=False):
    """Fused kernel vs plain, per value.  The row path (d <= 8) keeps the
    order of the plain version on the CPU: a few ulps.  The plain version on
    the card forms its prefix products as a tree (torch's CUDA cumprod),
    and the a-term's ratios of nearby prefix products (P_j / P_i up to
    1 - 3e-4 at n = 65) magnify its one-ulp differences ~3000-fold, so D
    and E are held to it at 1e-11.  The warp path's tree scans give C's
    sums of prefix products to 1e-12 and D's and E's products of ~d^2/2
    ratios to 1e-10.  In f32: F32_RTOL for C, 1e-3 for D and E (the same
    magnification of an f32 ulp: the plain f32 version is up to 1.8e-4
    off the f64 one on the CPU at d = 5 and 8, n = 33)."""
    if f32:
        return F32_RTOL if kind == "C" else 1e-3
    if d <= 8:
        return 1e-11 if on_card and kind != "C" else 1e-14
    return 1e-12 if kind == "C" else 1e-10


def _rel_errs(got, want, rtol, atol=0.0):
    """(max |got - want|, max relative error over want != 0, within rtol per
    value, or within atol where the values are subnormal); a zero of want
    must be a zero of got unless atol allows it."""
    diff = (got - want).abs()
    nz = want != 0
    rel = float((diff[nz] / want[nz].abs()).max()) if bool(nz.any()) else 0.0
    return float(diff.max()), rel, bool((diff <= rtol * want.abs() + atol).all())


def _by_shape(shapes) -> dict:
    """launch_shapes() with strings for keys, for a JSON line."""
    return {name: {str(list(sh)): c for sh, c in sorted(by.items())}
            for name, by in shapes.items()}


def _require_held(label, shapes, held) -> None:
    """Every shape at which a run launched a kernel must be one that phase 3
    held against the plain version."""
    missing = {name: sorted(set(by) - held[name]) for name, by in shapes.items()
               if set(by) - held[name]}
    if missing:
        raise AssertionError(f"{label}: launched at shapes that no kernel check held: {missing}")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_per_call(fn, calls: int = 50, tries: int = 10) -> dict:
    """Device-only time and kernels per call of fn (torch.profiler over
    `calls` back-to-back calls after one warm-up): the CUDA-event times
    include the host's launch overhead, which these leave out.  The
    profiler now and then records no device event at all for such a
    window (seen once in some 200 windows on an H100, and three windows in
    a row once in a run of ~250), so an empty window is profiled again, up
    to `tries` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
        if kern:
            break
    return {"device_us": sum(_device_us(e) for e in kern) / calls,
            "kernels_per_call": sum(e.count for e in kern) / calls,
            "by_kernel_us": {e.key[:60]: _device_us(e) / calls for e in kern},
            "by_kernel": {e.key: (_device_us(e), e.count) for e in kern}}


def host_us_per_call(fn, calls: int = 1000) -> float:
    """Host clock around `calls` calls and one synchronize, per call."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def mvn_shapes(d: int, N: int, R: int, maxvol: bool = False):
    """The kernel launches of a sequential rook cross of an integrand that
    looks its nodes up in one n = N table (apps/mvn.py, apps/stdnorm.py) at
    padded rank R: kernel A's (M, K, R) and kernel B's (B, d).  A rook fiber
    is R*N long; the lottery draws 2(R+N) candidates; the init evaluates 8
    shifted diagonals of N entries, then d fibers of N; a maxvol bond visit
    evaluates the (R*N*R, d) fiber cross and the first core (N*R, d)."""
    a = [(R * N, 1, R), (1, N * R, R)]
    b = [(R * N, d), (2 * (R + N), d), (8 * N, d), (d * N, d)]
    if maxvol:
        b += [(R * N * R, d)]
    return a, b


def mvn_path_shapes():
    """Every shape the MVN / COS phase launches at: mvn_d6 at ranks 20 (the
    greedy and the refined run, whose maxvol pads to the largest rank, 20)
    and 26 (oversample=6, alone and with refine_sweeps=2), stdnorm_d10 at
    rank 8 on its 33-point rule, the small run against the CPU (d = 4,
    n = 17, ranks 6 and 8), the Greeks' nominal cross at rank 14, and the
    4-lane family at rank 20: every lane's batch in one kernel-B launch."""
    a, b = [], []
    for d, N, R, n, mv in [(6, 65, 20, 65, True), (6, 65, 26, 65, True), (10, 33, 8, 33, False),
                           (4, 17, 6, 17, True), (4, 17, 8, 17, False), (6, 65, 14, 65, False)]:
        sa, sb = mvn_shapes(d, N, R, mv)
        for shape in sa:
            if shape not in a:
                a.append(shape)
        for shape in sb:
            if (*shape, n) not in b:
                b.append((*shape, n))
    sa, sb = mvn_shapes(6, 65, 20)
    b += [(FAMILY_LANES * B, d, 65) for B, d in sb]
    return a, b


def kernel_cases(dev, gen):
    """Kernel A's and kernel B's inputs: the main path's shapes (the rook
    passes, the integrand's batches), the larger ones of full pivoting and
    long chains, and the MVN / COS path's (mvn_path_shapes; kernel B there
    reads one table, the nodes)."""
    import torch

    R, N, B = 30, 65, 1950            # the headline's padded rank and mode size
    a = [(name, _score_inputs(gen, M, Kc, Rr, dev)) for name, M, Kc, Rr in
         [("col_pass", B, 1, R), ("row_pass", 1, B, R), ("superblock", B, B, R),
          ("random", 8192, 8192, 32), ("long_col", 100000, 1, R), ("long_row", 1, 70001, R)]]
    mvn_a, mvn_b = mvn_path_shapes()
    a += [(f"mvn_{'col' if Kc == 1 else 'row'}_r{Rr}_{M * Kc}", _score_inputs(gen, M, Kc, Rr, dev))
          for M, Kc, Rr in mvn_a]
    b = []
    for name, Bb, d, n in [("rook_fiber", B, 5, N), ("lottery", 190, 5, N),
                           ("init_diag", 520, 5, N), ("init_fibers", 325, 5, N),
                           ("large", 100584, 255, 33),
                           # the chain's lift at C_256 (254 bonds) and C_1024 (1022):
                           # the lottery's candidates, the states' rows, a fiber's
                           # fixed index and its free one, the accepted pivots
                           ("lift_cand", 254, 54, 17), ("lift_states", 254, 10, 17),
                           ("lift_fixed", 254, 1, 17), ("lift_free", 1, 17, 17),
                           ("lift_accept", 1, 254, 17),
                           ("lift_cand_c1024", 1022, 54, 17), ("lift_states_c1024", 1022, 10, 17),
                           ("lift_fixed_c1024", 1022, 1, 17), ("lift_accept_c1024", 1, 1022, 17)]:
        tables = torch.randn((2, n), generator=gen, dtype=torch.float64).to(dev)
        ind = torch.randint(-2, n + 2, (Bb, d), generator=gen, dtype=torch.int32).to(dev)
        b.append((name, (tables, ind)))
    for Bb, d, n in mvn_b:
        tables = torch.randn((1, n), generator=gen, dtype=torch.float64).to(dev)
        ind = torch.randint(-2, n + 2, (Bb, d), generator=gen, dtype=torch.int32).to(dev)
        b.append((f"mvn_nodes_{Bb}x{d}_n{n}", (tables, ind)))
    return a, b


def integrand_cases(dev, gen):
    """The fused integrand's inputs: the headline's four batch shapes (C_6,
    n = 65), the rook fiber's at D_6 and E_6, and the long chain's at n = 17:
    the fibers and the lottery of a C_256 sweep without the chain (254 bonds
    x 170 and x 54) and the init batches of C_256 and C_1024 (with the chain
    they are the only integrand calls); tables from make_ising, indices in
    range but for two rows."""
    import torch

    from ttcross_tpu_torch.apps import make_ising

    cases = []
    for name, kind, m, n, B in [("rook_fiber", "C", 6, 64, 1950), ("lottery", "C", 6, 64, 190),
                                ("init_diag", "C", 6, 64, 520), ("init_fibers", "C", 6, 64, 325),
                                ("rook_fiber_D", "D", 6, 64, 1950),
                                ("rook_fiber_E", "E", 6, 64, 1950),
                                ("lc_fibers", "C", 256, 17, 43180),
                                ("lc_lottery", "C", 256, 17, 13716),
                                ("lc_init_diag", "C", 256, 17, 136),
                                ("lc_init_fibers", "C", 256, 17, 4335),
                                ("lc_init_diag_c1024", "C", 1024, 17, 136),
                                ("lc_init_fibers_c1024", "C", 1024, 17, 17391)]:
        p = make_ising(kind, m, n, device=dev)
        ind = torch.randint(0, p.n, (B, p.d), generator=gen, dtype=torch.int32)
        ind[0, 0] = -1                 # out of range: the row's value is 0
        ind[1, p.d - 1] = p.n
        cases.append((name, kind, p.tables, ind.to(dev)))
    return cases


def check_integrand(cases):
    """Phase 3, the fused integrand against its plain version on the same
    inputs, on the card and on the host: per-value error within
    _integrand_rtol, one kernel per call, times, bound and share.  No
    single PyTorch call computes the integrand, so it has no library
    yardstick."""
    import torch

    from ttcross_tpu_torch.ops import kernels as K

    rows = []
    for name, kind, tables, ind in cases:
        B, d = ind.shape
        n = tables.shape[1]
        f32 = tables.dtype == torch.float32
        atol = 1e-37 if f32 else 0.0      # f32 prefix products of long chains reach subnormals
        got = K.ising_integrand_fused(tables, ind, kind)
        want = K.ising_integrand_plain(tables, ind, kind)
        torch.cuda.synchronize()
        err = {}
        for where, w in (("card", want), ("cpu", K.ising_integrand_plain(tables.cpu(), ind.cpu(), kind))):
            rtol = _integrand_rtol(kind, d, where == "card", f32)
            err[where] = _rel_errs(got.cpu(), w.cpu(), rtol, atol)
            if not err[where][2] or not bool((got[:2] == 0).all()):
                raise AssertionError(f"fused integrand {name}: max |got - plain on the {where}| "
                                     f"{err[where][0]} exceeds {rtol} relative")
        fn = lambda: K.ising_integrand_fused(tables, ind, kind)  # noqa: E731
        plain = lambda: K.ising_integrand_plain(tables, ind, kind)  # noqa: E731
        dev_k = device_per_call(fn)
        if not (0 < dev_k["kernels_per_call"] <= 1
                and all("integrand" in k for k in dev_k["by_kernel_us"])):
            raise AssertionError(f"fused integrand {name}: {dev_k['by_kernel_us']} at "
                                 f"{dev_k['kernels_per_call']} kernels per call (one is the design)")
        dev_p = device_per_call(plain)
        bound, by = _integrand_bound(kind, B, d, n, tables.element_size())
        row = {"kernel": "ising_integrand_fused", "kind": kind, "shape": [B, d, n] + _tag(tables),
               "case": name, "max_abs_err": err["card"][0],
               "max_rel_err_vs_card_plain": err["card"][1],
               "max_rel_err_vs_cpu_plain": err["cpu"][1],
               "rtol_card": _integrand_rtol(kind, d, True, f32),
               "rtol_cpu": _integrand_rtol(kind, d, False, f32),
               "ms": _time_ms(fn), "plain_ms": _time_ms(plain),
               "library_ms": None, "device_us": dev_k["device_us"],
               "kernels_per_call": dev_k["kernels_per_call"],
               "plain_device_us": dev_p["device_us"],
               "plain_kernels_per_call": dev_p["kernels_per_call"],
               "bound_us": bound, "bound_by": by, "share_of_bound": bound / dev_k["device_us"]}
        if name == "rook_fiber":
            row["host_us_per_call"] = host_us_per_call(fn)
        _emit(row)
        rows.append(row)
    return rows


def check_kernels(dev, a_cases, b_cases):
    """Phase 3: kernel vs plain on the card, with times, bounds and shares."""
    import torch

    from ttcross_tpu_torch.ops import kernels as K

    a_rows = []
    for name, args in a_cases:
        vals, colf, rowf, mask = args
        M, Kc = vals.shape
        Rr = colf.shape[1]
        f32 = vals.dtype == torch.float32
        got = K.score_residual_argmax(*args)
        want = K.score_residual_argmax_plain(*args)
        torch.cuda.synchronize()
        if got[1].dtype != vals.dtype:
            raise AssertionError(f"kernel A {name}: a {got[1].dtype} score for {vals.dtype} inputs")
        gi, gs, gr = (float(x) for x in got)
        wi, ws, wr = (float(x) for x in want)
        if int(gi) != int(wi):
            raise AssertionError(f"kernel A {name}: index {int(gi)} != plain {int(wi)}")
        err = max(abs(gs - ws), abs(gr - wr))
        if err > (F32_RTOL if f32 else SCORE_RTOL) * abs(ws):
            raise AssertionError(f"kernel A {name}: score {gs} vs plain {ws}")
        dev_k = device_per_call(lambda: K.score_residual_argmax(*args))
        dev_p = device_per_call(lambda: K.score_residual_argmax_plain(*args))
        bound, by = _score_bound(M, Kc, Rr, vals.element_size())
        fiber = M == 1 or Kc == 1
        if fiber and not 0 < dev_k["kernels_per_call"] <= 1:
            raise AssertionError(f"kernel A {name}: {dev_k['kernels_per_call']} kernels "
                                 "per fiber call (one is the design)")
        row = {"kernel": "score_residual_argmax", "shape": [M, Kc, Rr] + _tag(vals),
               "case": name, "index": int(gi), "max_abs_err": err,
               "ms": _time_ms(lambda: K.score_residual_argmax(*args)),
               "plain_ms": _time_ms(lambda: K.score_residual_argmax_plain(*args)),
               "device_us": dev_k["device_us"], "kernels_per_call": dev_k["kernels_per_call"],
               "by_kernel_us": dev_k["by_kernel_us"],
               "plain_device_us": dev_p["device_us"], "bound_us": bound, "bound_by": by,
               "share_of_bound": bound / dev_k["device_us"],
               "l2": "warm: back-to-back calls" if vals.element_size() * M * Kc < 40e6
               else "exceeds L2"}
        if fiber:
            row["host_us_per_call"] = host_us_per_call(lambda: K.score_residual_argmax(*args))
        _emit(row)
        a_rows.append(row)

    b_rows = []
    for name, (tables, ind) in b_cases:
        L, n = tables.shape
        got = K.small_table_lookup(tables, ind)
        want = K.small_table_lookup_plain(tables, ind)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if not torch.equal(got, want):
            raise AssertionError(f"kernel B {name}: not bitwise equal to the plain version "
                                 f"(max difference {err})")
        inside = ind.clamp(0, n - 1)   # the library gather takes in-range indices only
        flat = inside.view(-1)
        if not torch.equal(K.small_table_lookup(tables, inside).view(L, -1),
                           torch.index_select(tables, 1, flat)):
            raise AssertionError(f"kernel B {name}: index_select disagrees")
        dev_k = device_per_call(lambda: K.small_table_lookup(tables, ind))
        dev_l = device_per_call(lambda: torch.index_select(tables, 1, flat))
        bound, by = _lookup_bound(L, ind.numel(), n, tables.element_size())
        row = {"kernel": "small_table_lookup", "shape": [L, *ind.shape, n] + _tag(tables),
               "case": name,
               "max_abs_err": err,
               "ms": _time_ms(lambda: K.small_table_lookup(tables, ind)),
               "plain_ms": _time_ms(lambda: K.small_table_lookup_plain(tables, ind)),
               "library_ms": _time_ms(lambda: torch.index_select(tables, 1, flat)),
               "device_us": dev_k["device_us"], "kernels_per_call": dev_k["kernels_per_call"],
               "library_device_us": dev_l["device_us"], "bound_us": bound, "bound_by": by,
               "share_of_bound": bound / dev_k["device_us"]}
        if name == "rook_fiber":
            row["host_us_per_call"] = host_us_per_call(lambda: K.small_table_lookup(tables, ind))
        _emit(row)
        b_rows.append(row)
    return a_rows, b_rows


BATCHED_CASES = [("col_pass_c256", 254, 170, 1, 10), ("row_pass_c256", 254, 1, 170, 10),
                 ("col_pass_c1024", 1022, 170, 1, 10), ("row_pass_c1024", 1022, 1, 170, 10),
                 ("col_one_bond", 1, 170, 1, 10), ("row_one_bond", 1, 1, 170, 10),
                 # the 4-lane mvn_d6 family: one launch scores every lane's fiber
                 ("col_pass_family", FAMILY_LANES, 1300, 1, 20),
                 ("row_pass_family", FAMILY_LANES, 1, 1300, 20)]


def check_batched(dev, gen, cases=BATCHED_CASES, dtype=None):
    """Phase 3, kernel A batched over bonds at the long chain's shapes, half
    of the bonds fully masked (a red-black phase's dead parity): the plain
    version's indices, scores and residuals within BATCHED_RTOL of the
    largest residual, and the bits of one single-fiber launch per bond; one
    kernel per call; times, bound and share.  dtype=torch.float32: the f32
    instantiation, its indices held to the plain version's where the best
    score is clear of the second by more than f32 rounding (tie-free inputs
    as _score_inputs makes them), its values to F32_RTOL.  No single
    PyTorch call computes it, so it has no library yardstick."""
    import torch

    from ttcross_tpu_torch.ops import kernels as K

    dtype = dtype or torch.float64
    f32 = dtype == torch.float32
    rows = []
    for name, P, M, Kc, R in cases:
        if f32:
            stacks = [_score_inputs(gen, M, Kc, R, dev, dtype) for _ in range(P)]
            vals, colf, rowf, mask = (torch.stack([s[i] for s in stacks]) for i in range(4))
        else:
            vals, colf, rowf = (torch.randn(sh, generator=gen, dtype=torch.float64).to(dev)
                                for sh in ((P, M, Kc), (P, M, R), (P, R, Kc)))
            mask = (torch.rand((P, M, Kc), generator=gen) > 0.2).to(dev)
        mask[1::2] = False
        args = (vals, colf, rowf, mask)
        got = K.score_residual_argmax_batched(*args)
        want = K.score_residual_argmax_batched_plain(*args)
        single = [K.score_residual_argmax(*(a[p] for a in args)) for p in range(P)]
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]) or got[1].dtype != dtype:
            raise AssertionError(f"batched kernel A {name}: indices differ from the plain version's")
        scale = float(want[2].abs().max())
        err = max(float((g - w).abs().max()) for g, w in zip(got[1:], want[1:]))
        if err > (F32_RTOL if f32 else BATCHED_RTOL) * scale:
            raise AssertionError(f"batched kernel A {name}: {err} from the plain version")
        if not all(torch.equal(got[i], torch.stack([x[i] for x in single])) for i in range(3)):
            raise AssertionError(f"batched kernel A {name}: not the bits of {P} single-fiber launches")
        if P > 1 and not (bool((got[0][1::2] == 0).all()) and bool((got[1][1::2] == -1.0).all())):
            raise AssertionError(f"batched kernel A {name}: a fully masked bond is not (0, -1)")
        fn = lambda: K.score_residual_argmax_batched(*args)  # noqa: E731
        plain = lambda: K.score_residual_argmax_batched_plain(*args)  # noqa: E731
        dev_k, dev_p = device_per_call(fn), device_per_call(plain)
        if not 0 < dev_k["kernels_per_call"] <= 1:
            raise AssertionError(f"batched kernel A {name}: {dev_k['kernels_per_call']} kernels "
                                 "per call (one is the design)")
        bound, by = _batched_bound(P, M, Kc, R, vals.element_size())
        row = {"kernel": "score_residual_argmax_batched", "shape": [P, M, Kc, R] + _tag(vals),
               "case": name,
               "max_abs_err": err, "bit_equal_to_single_launches": True,
               "ms": _time_ms(fn), "plain_ms": _time_ms(plain), "library_ms": None,
               "device_us": dev_k["device_us"], "kernels_per_call": dev_k["kernels_per_call"],
               "plain_device_us": dev_p["device_us"],
               "plain_kernels_per_call": dev_p["kernels_per_call"],
               "host_us_per_call": host_us_per_call(fn),
               "bound_us": bound, "bound_by": by, "share_of_bound": bound / dev_k["device_us"]}
        _emit(row)
        rows.append(row)
    return rows


def _package_of(root: str):
    """The name of the ttcross_tpu_torch package of the checkout at `root`,
    imported under another name so that it sits beside this checkout's."""
    import importlib.util
    from pathlib import Path

    name = "other_ttcross_tpu_torch"
    pkg = Path(root).resolve() / "ttcross_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return name


def compare_with(root: str, a_cases, b_cases, i_cases) -> dict:
    """Device-only and host time per call of the kernels of the checkout at
    `root` and of this one, on the same inputs, in turns: other, this,
    this, other.  The integrand is each checkout's apps.ising.
    ising_integrand at the rook fiber's shape and at C_256's fibers (e.g. the
    parent's kernel B and eager chain against this one's fused kernel)."""
    import importlib

    from ttcross_tpu_torch.apps import ising
    from ttcross_tpu_torch.ops import kernels as K

    name = _package_of(root)
    other_k = importlib.import_module(name + ".ops.kernels")
    other_i = importlib.import_module(name + ".apps.ising")
    cases = [(f"score_residual_argmax {c}", other_k.score_residual_argmax,
              K.score_residual_argmax, args) for c, args in a_cases]
    cases += [(f"small_table_lookup {c}", other_k.small_table_lookup,
               K.small_table_lookup, args) for c, args in b_cases[:1]]
    cases += [(f"ising_integrand {c}", other_i.ising_integrand, ising.ising_integrand,
               (ind, tables, kind)) for c, kind, tables, ind in i_cases
              if c in ("rook_fiber", "lc_fibers")]
    out = {}
    for label, f_other, f_this, args in cases:
        reads = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            f = f_other if who == "other" else f_this
            dev = device_per_call(lambda: f(*args))
            reads[who].append({"device_us": dev["device_us"],
                               "kernels_per_call": dev["kernels_per_call"],
                               "host_us_per_call": host_us_per_call(lambda: f(*args))})
        out[label] = reads
    return {"phase": "compare", "other": root, "per_call": out}


def run_headline(dev, oversample, return_state=False, key=0):
    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross

    h = HEADLINE
    prob = make_ising("C", h["m"], h["n"], device=dev)
    t0 = time.perf_counter()
    res = cross(prob.fun, [prob.n] * prob.d, max_rank=h["max_rank"],
                accuracy=h["accuracy"], pivoting=h["pivoting"],
                quad=[prob.quad_weights] * prob.d, truth=prob.truth,
                oversample=oversample, return_state=return_state, key=key,
                device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vals = np.asarray(res.values)
    if not (np.all(np.isfinite(vals)) and res.tt.ready()
            and res.tt.device.type == "cuda" and max(res.ranks) <= h["max_rank"]):
        raise AssertionError(f"malformed result: ranks {res.ranks}, values {vals}")
    return res, wall, float(-np.log10(res.errors[-1]))


def run_long_chain(dev, m=256, mode="jacobi-rb", chain=True, key=0):
    """One long-chain cross on the card through the public entry points;
    (result, wall seconds, digits, launches per kernel of this run, the
    same by the shape of the call)."""
    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross
    from ttcross_tpu_torch.ops import kernels as K

    h = LONG_CHAIN
    prob = make_ising("C", m, h["n"])          # on the card by default
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = cross(prob.fun, [prob.n] * prob.d, max_rank=h["max_rank"], accuracy=h["accuracy"],
                pivoting=h["pivoting"], quad=[prob.quad_weights] * prob.d, truth=prob.truth,
                sweep_mode=mode, chain=prob.chain if chain else None, key=key,
                return_state=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, shapes = K.launch_counts(), K.launch_shapes()
    vals = np.asarray(res.values)
    state = list(res.state) + list(res.chain_states or ())
    if not (np.all(np.isfinite(vals)) and res.tt.ready() and res.tt.device.type == "cuda"
            and max(res.ranks) <= h["max_rank"] and len(res.ranks) == m
            and all(t.device.type == "cuda" for t in state)
            and (res.chain_states is not None) == chain):
        raise AssertionError(f"malformed long-chain result: ranks {res.ranks}, values {vals}")
    return res, wall, float(-np.log10(res.errors[-1])), counts, shapes


def _long_chain_row(res, wall, digits, counts, shapes) -> dict:
    return {"digits": digits, "n_evals": res.neval, "padded_evals": res.padded_evals,
            "max_rank": max(res.ranks), "sweeps": res.sweeps, "wall_s": wall, "launches": counts,
            "launches_per_sweep": {k: v / res.sweeps for k, v in counts.items()},
            "launches_by_shape": _by_shape(shapes)}


def check_long_chain(dev, held):
    """Phase 6: C_256 jacobi-rb + chain, first and steady call and keys 0-7,
    then jacobi-rb without the chain, jacobi with it, and C_1024, each
    over keys 0-7 too; every run's kernel launches at shapes in `held`.  Returns the launch counts
    of the first C_256 run, in all and by shape."""
    res, first, digits, launches, shapes = run_long_chain(dev)
    res2, steady, digits2, launches2, _ = run_long_chain(dev)
    by_key = [digits] + [run_long_chain(dev, key=k)[2] for k in KEYS[1:]]
    median = statistics.median(by_key)
    floor_median, floor_key = LC_FLOORS[256, "jacobi-rb", True]
    _emit({"phase": "long_chain", "config": "C_256 n=17 rank 10 jacobi-rb chain pivoting=1",
           **_long_chain_row(res, first, digits, launches, shapes), "ranks": list(res.ranks),
           "steady_s": steady, "state_on_card": True, "digits_by_key": by_key,
           "median_digits": median})
    if median < floor_median or min(by_key) < floor_key or res.neval > LC_EVALS_MAX:
        raise AssertionError(f"long-chain digits over keys {by_key}: median {median} < "
                             f"{floor_median}, a key < {floor_key}, or {res.neval} "
                             f"evals > {LC_EVALS_MAX}")
    if min(launches[k] for k in LONG_CHAIN_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the long-chain path was never launched: {launches}")
    _require_held("C_256 jacobi-rb + chain", shapes, held)
    if (res2.neval, res2.ranks, digits2, launches2) != (res.neval, res.ranks, digits, launches):
        raise AssertionError("the repeated long-chain run took another path")
    for label, m, mode, chain, need in [
            ("C_256 jacobi-rb, black-box integrand", 256, "jacobi-rb", False,
             ("score_residual_argmax_batched", "ising_integrand_fused")),
            ("C_256 jacobi + chain", 256, "jacobi", True, LONG_CHAIN_KERNELS),
            ("C_1024 jacobi-rb + chain", 1024, "jacobi-rb", True, LONG_CHAIN_KERNELS)]:
        run_long_chain(dev, m, mode, chain)              # first call at this shape
        *run, shapes_v = run_long_chain(dev, m, mode, chain)
        row = _long_chain_row(*run, shapes_v)
        by_key = [row["digits"]] + [run_long_chain(dev, m, mode, chain, key=k)[2]
                                    for k in KEYS[1:]]
        median = statistics.median(by_key)
        floor_median, floor_key = LC_FLOORS[m, mode, chain]
        _emit({"phase": "long_chain_variant", "config": label, **row, "digits_by_key": by_key,
               "median_digits": median})
        if median < floor_median or min(by_key) < floor_key:
            raise AssertionError(f"{label}: digits over keys {by_key}: median {median} < "
                                 f"{floor_median} or a key < {floor_key}")
        if min(row["launches"][k] for k in need) <= 0:
            raise AssertionError(f"{label}: a kernel of its path was not launched: {row['launches']}")
        _require_held(label, shapes_v, held)
    return launches, shapes


def profile_long_chain_parts(dev) -> None:
    """Kernels and device-only time per call of the long chain's parts at
    C_256's shapes (254 bonds, R = 10, N = 17, NLOT = 54) on the state
    after init: the three chain evaluators and the states' scan and update
    (what one fused kernel each would replace), one whole hunt of all
    bonds and one apply."""
    import torch

    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.config import precision_thresholds
    from ttcross_tpu_torch.cross.engine import CrossConfig, make_engine

    h = LONG_CHAIN
    p = make_ising("C", 256, h["n"])
    R, N, nb = h["max_rank"], p.n, p.d - 1
    se, sp = precision_thresholds(torch.float64)
    cfg = CrossConfig(d=p.d, n=(N,) * p.d, N=N, R=R, piv=h["pivoting"], small_element=se,
                      small_pivot=sp, jacobi=True, rb=True)
    kit = make_engine(p.fun, cfg, dev, chain=p.chain)
    ev, st = kit.chain_ev, kit.init_fn()
    Ls, Rs = ev.states_from_vip(st.vip)
    gen = torch.Generator(device="cpu").manual_seed(0)
    NLOT = 2 * (R + N)
    U = torch.rand((nb, 2, NLOT), generator=gen, dtype=torch.float64).to(dev)
    ps, iN = torch.arange(nb, device=dev), torch.arange(N, device=dev)
    zr = torch.zeros((nb, NLOT), dtype=torch.long, device=dev)     # rank 1: link 0
    jk = torch.randint(0, N, (2, nb, NLOT), generator=gen).to(dev)
    live = torch.ones((nb,), dtype=torch.bool, device=dev)
    w = torch.ones((p.d, N), dtype=torch.float64, device=dev)
    hunt, amax, neval, padded = kit.jacobi_hunt(st, U, True, 0, nb, live, cs=(Ls, Rs))
    st2 = st._replace(amax=amax, neval=neval, padded=padded)
    parts = {
        "eval_cand (254, 54)": lambda: ev.eval_cand(Ls, Rs, ps, zr, jk[0], jk[1], zr),
        "eval_col (254, 10, 17)": lambda: ev.eval_col(Ls, Rs, ps, jk[0, :, 0], zr[:, 0], iN),
        "eval_row (254, 17, 10)": lambda: ev.eval_row(Ls, Rs, ps, zr[:, 0], jk[1, :, 0], iN),
        "states_from_vip": lambda: ev.states_from_vip(st.vip),
        "value_fn (per sweep)": lambda: kit.value_fn(st, w),
        "update_states": lambda: ev.update_states(Ls.clone(), Rs.clone(), zr[:, 0], jk[0, :, 0],
                                                  jk[1, :, 0], zr[:, 0], ~live, zr[:, 0]),
        "jacobi_hunt, all bonds": lambda: kit.jacobi_hunt(st, U, True, 0, nb, live, cs=(Ls, Rs)),
        # nothing is accepted (live all false), so the state stays as it is
        "jacobi_apply, no accept": lambda: kit.jacobi_apply(st2, hunt, live=~live,
                                                            skip_corners=True),
    }
    rows = {}
    for name, fn in parts.items():
        got = device_per_call(fn, calls=20)
        rows[name] = {"kernels_per_call": got["kernels_per_call"], "device_us": got["device_us"],
                      "host_us_per_call": host_us_per_call(fn, calls=50)}
    _emit({"phase": "profile", "run": "C_256 long-chain parts, per call", **rows})


def check_rounding(dev, final_values) -> dict:
    """The oversampled cross is a rank-30 cross, then svd_round to rank
    24.  For each key, round the same rank-30 train on the card and on the
    host (LAPACK): their quadrature values must agree to ROUND_RTOL, and
    the card's must be the headline's final value."""
    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross
    from ttcross_tpu_torch.tt.ops import contract
    from ttcross_tpu_torch.tt.ortho import svd_round
    from ttcross_tpu_torch.tt.types import TT

    h = HEADLINE
    prob = make_ising("C", h["m"], h["n"], device=dev)
    w = [prob.quad_weights] * prob.d
    rels = []
    for key, final in zip(KEYS, final_values):
        res = cross(prob.fun, [prob.n] * prob.d, max_rank=h["max_rank"] + 6,
                    accuracy=h["accuracy"], pivoting=h["pivoting"], key=key, device=dev)
        on_card = float(contract(svd_round(res.tt, tol=0.0, rmax=h["max_rank"]), w))
        host = TT(tuple(c.cpu() for c in res.tt.cores))
        on_host = float(contract(svd_round(host, tol=0.0, rmax=h["max_rank"]), w))
        if abs(on_card - final) > 1e-15 * abs(final):
            raise AssertionError(f"key {key}: rounded value {on_card} != headline {final}")
        rels.append(abs(on_card - on_host) / abs(on_host))
    if max(rels) > ROUND_RTOL:
        raise AssertionError(f"rounding on the card differs from the host's: {rels}")
    return {"phase": "rounding", "rel_card_vs_host_by_key": rels, "max_rel": max(rels)}


def check_small_against_cpu(dev) -> dict:
    """A small cross on the card against the same cross (same uniforms) on
    the CPU, where every kernel is its plain version."""
    import numpy as np

    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross

    rows = {}
    for piv in (1, -1):          # -1 scores each superblock on kernel A's 2-D path
        out = {}
        for where in ("cpu", dev):
            p = make_ising("C", 5, 17, device=where)
            out[str(where)] = cross(p.fun, [p.n] * p.d, max_rank=8, pivoting=piv,
                                    quad=[p.quad_weights] * p.d, truth=p.truth,
                                    oversample=2, device=where)
        c, g = out["cpu"], out[str(dev)]
        if (c.ranks, c.neval, c.sweeps) != (g.ranks, g.neval, g.sweeps):
            raise AssertionError(f"C_5 pivoting={piv} on the card {g.ranks} {g.neval} "
                                 f"!= CPU {c.ranks} {c.neval}")
        rel = float(np.max(np.abs(np.subtract(g.values, c.values)) / np.abs(c.values)))
        if rel > 1e-11:
            raise AssertionError(f"C_5 pivoting={piv}: the card differs from the CPU by {rel}")
        rows[f"pivoting={piv}"] = {"ranks": list(g.ranks), "n_evals": g.neval,
                                   "max_rel_value_diff": rel}
    # the long chain's path at C_32 (n = 17, rank 6): all-bonds red-black
    # sweeps, candidates from the chain's interface states
    out = {}
    for where in ("cpu", dev):
        p = make_ising("C", 32, 17, device=where)
        out[str(where)] = cross(p.fun, [p.n] * p.d, max_rank=6, accuracy=LONG_CHAIN["accuracy"],
                                pivoting=1, quad=[p.quad_weights] * p.d, truth=p.truth,
                                sweep_mode="jacobi-rb", chain=p.chain, device=where)
    c, g = out["cpu"], out[str(dev)]
    if (c.ranks, c.neval, c.sweeps) != (g.ranks, g.neval, g.sweeps):
        raise AssertionError(f"C_32 jacobi-rb + chain on the card {g.ranks} {g.neval} != CPU "
                             f"{c.ranks} {c.neval}")
    rel = float(np.max(np.abs(np.subtract(g.values, c.values)) / np.abs(c.values)))
    if rel > 1e-9:          # rank-6 values carry ~1e-7 of error; batched sums in another order
        raise AssertionError(f"C_32 jacobi-rb + chain: the card differs from the CPU by {rel}")
    rows["C_32 jacobi-rb chain"] = {"max_rank": max(g.ranks), "n_evals": g.neval,
                                    "sweeps": g.sweeps, "max_rel_value_diff": rel}
    return {"phase": "small_vs_cpu", **rows}


def run_mvn(dev, key=0, **extra):
    """One MVN d = 6, n = 65, rank 20 cross on the card through the public
    entry points; (result, wall seconds, digits, launches per kernel of this
    run, the same by the shape of the call, the problem)."""
    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import make_mvn
    from ttcross_tpu_torch.cross import cross
    from ttcross_tpu_torch.ops import kernels as K

    h = MVN
    prob = make_mvn(d=h["d"], n=h["n"])        # on the card by default
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = cross(prob.fun, [prob.n] * prob.d, max_rank=h["max_rank"], accuracy=h["accuracy"],
                pivoting=h["pivoting"], quad=[prob.quad_weights] * prob.d, truth=prob.truth,
                key=key, **extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, shapes = K.launch_counts(), K.launch_shapes()
    vals = np.asarray(res.values)
    if not (np.all(np.isfinite(vals)) and res.tt.ready() and res.tt.device.type == "cuda"
            and max(res.ranks) <= h["max_rank"] and len(res.ranks) == h["d"] + 1
            and prob.table.device.type == "cuda" and prob.density.inv_cov_t.device.type == "cuda"):
        raise AssertionError(f"malformed MVN result: ranks {res.ranks}, values {vals}")
    return res, wall, float(-np.log10(res.errors[-1])), counts, shapes, prob


def _mvn_row(res, wall, digits, counts, shapes) -> dict:
    return {"digits": digits, "n_evals": res.neval, "padded_evals": res.padded_evals,
            "ranks": list(res.ranks), "sweeps": res.sweeps, "first_s": wall, "launches": counts,
            "launches_by_shape": _by_shape(shapes)}


def check_mvn_path(dev, held):
    """Phase 7: the MVN / COS option-pricing path at the sizes of the
    reference's test programs.  Returns (label, launches by shape) of every
    run of the phase that launches a kernel, the first run of each."""
    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import (CHF_RHO05, basket_chf, basket_pdf, make_cos_coefficients,
                                        make_mvn_density, make_stdnorm)
    from ttcross_tpu_torch.cross import accchk, cross
    from ttcross_tpu_torch.ops import kernels as K
    from ttcross_tpu_torch.tt import contract, load_ttbin_ref, save_ttbin_ref

    first, runs = {}, []
    for variant, extra in MVN_VARIANTS.items():
        res, wall, digits, launches, shapes, prob = run_mvn(dev, **extra)
        res2, steady, digits2, launches2, _, _ = run_mvn(dev, **extra)
        by_key = [digits] + [run_mvn(dev, key=k, **extra)[2] for k in KEYS[1:]]
        median = statistics.median(by_key)
        floor_median, floor_key = MVN_FLOORS[variant]
        _emit({"phase": "mvn", "config": f"mvn_d6 n=65 rank 20 pivoting=1 {variant}",
               **_mvn_row(res, wall, digits, launches, shapes), "steady_s": steady,
               "digits_by_key": by_key, "median_digits": median})
        if median < floor_median or min(by_key) < floor_key:
            raise AssertionError(f"mvn_d6 {variant}: digits over keys {by_key}: median {median} < "
                                 f"{floor_median} or a key < {floor_key}")
        if min(launches[k] for k in MVN_KERNELS) <= 0:
            raise AssertionError(f"mvn_d6 {variant}: a kernel of its path was not launched: {launches}")
        _require_held(f"mvn_d6 {variant}", shapes, held)
        if (res2.neval, res2.ranks, digits2, launches2) != (res.neval, res.ranks, digits, launches):
            raise AssertionError(f"the repeated mvn_d6 {variant} run took another path")
        first[variant] = res
        runs.append((f"mvn_d6 {variant}", shapes))
    res = first["greedy"]
    err = res.errors[-1]

    # the weighted lottery, key 0
    *run, shapes_w, _ = run_mvn(dev, weighted_lottery=True)
    _emit({"phase": "mvn", "config": "mvn_d6 n=65 rank 20 pivoting=1 weighted_lottery",
           **_mvn_row(*run, shapes_w)})
    if run[2] < MVN_WEIGHTED_FLOOR:
        raise AssertionError(f"mvn_d6 weighted lottery: {run[2]} digits < {MVN_WEIGHTED_FLOOR}")
    _require_held("mvn_d6 weighted lottery", shapes_w, held)
    runs.append(("mvn_d6 weighted_lottery", shapes_w))

    # the composition: cross at rank 26, refine the pivots there, round to 20
    *run, shapes_c, _ = run_mvn(dev, oversample=6, refine_sweeps=2)
    _emit({"phase": "mvn", "config": "mvn_d6 n=65 rank 20 pivoting=1 oversample=6 refine_sweeps=2",
           **_mvn_row(*run, shapes_c)})
    if run[2] < MVN_COMPOSED_FLOOR:
        raise AssertionError(f"mvn_d6 oversample=6 refine_sweeps=2: {run[2]} digits < "
                             f"{MVN_COMPOSED_FLOOR}")
    _require_held("mvn_d6 oversample=6 refine_sweeps=2", shapes_c, held)
    runs.append(("mvn_d6 oversample=6 refine_sweeps=2", shapes_c))

    # mvn_complex_d6: the rank-20 train against complex128 weights, on the card
    real = contract(res.tt, [prob.quad_weights] * prob.d)
    cplx = contract(res.tt, [prob.quad_weights.astype(np.complex128)] * prob.d)
    if cplx.device.type != "cuda" or cplx.dtype != torch.complex128 or cplx.dim() != 0:
        raise AssertionError(f"the complex contraction is {cplx.dtype} on {cplx.device}")
    real, cplx = float(real), complex(cplx)
    _emit({"phase": "mvn", "config": "mvn_complex_d6", "real": real, "complex_re": cplx.real,
           "complex_im": cplx.imag, "complex_digits": float(-np.log10(abs(1 - cplx / prob.truth)))})
    if abs(cplx.real - real) > COMPLEX_RTOL * abs(real) or abs(cplx.imag) > COMPLEX_RTOL:
        raise AssertionError(f"complex contraction {cplx} against the real one {real}")

    # chf / pdf: 32 terms of the basket's characteristic function against
    # the rho = 0.5 goldens (the train's own error bounds both), then the COS
    # density on 100 points: non-negative to 1e-6 and of mass 1 within the
    # train's error (its cosine series integrates exactly by the trapezoid
    # rule on this grid)
    phis = basket_chf(res.tt, prob.nodes, prob.quad_weights, 32)
    chf_dev = float((phis.cpu() - torch.tensor(CHF_RHO05, dtype=torch.complex128)).abs().max())
    xs = np.linspace(0.0, 300.0, 100)
    pdf = basket_pdf(res.tt, prob.nodes, prob.quad_weights, xs, 32)
    mass = float(torch.trapezoid(pdf, torch.from_numpy(xs).to(pdf.device)))
    _emit({"phase": "mvn", "config": "chf / pdf of the greedy mvn_d6 train, 32 terms",
           "train_err": err, "chf_max_dev_from_goldens": chf_dev, "pdf_min": float(pdf.min()),
           "pdf_mass": mass, "on_card": phis.device.type == "cuda" and pdf.device.type == "cuda"})
    if not (phis.device.type == "cuda" and phis.dtype == torch.complex128
            and chf_dev <= 4 * err + 1e-8 and float(pdf.min()) >= -1e-6
            and abs(mass - 1.0) <= 2 * err + 1e-8 and bool(torch.isfinite(pdf).all())):
        raise AssertionError(f"chf / pdf: deviation {chf_dev}, pdf min {float(pdf.min())}, mass "
                             f"{mass} at a train error of {err}")

    # coscoeff_d6 + accchk
    dens = make_mvn_density(6, corr=0.5)
    cc = make_cos_coefficients(6, dens.mu, dens.cov, 0.52517, 8.52517)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    cres = cross(cc.fun, [65] * 6, max_rank=20, accuracy=MVN["accuracy"], pivoting=1)
    chk = accchk(cres.tt, cc.fun, nlot=2**14)
    wall = time.perf_counter() - t0
    counts, shapes_k = K.launch_counts(), K.launch_shapes()
    rel = chk["einf"] / max(chk["ainf"], 1e-300)
    _emit({"phase": "mvn", "config": "coscoeff_d6 n=65 rank 20 + accchk 2^14", "n_evals": cres.neval,
           "padded_evals": cres.padded_evals, "ranks": list(cres.ranks), "sweeps": cres.sweeps,
           "wall_s": wall, "launches": counts, "launches_by_shape": _by_shape(shapes_k),
           "accchk": chk, "accchk_rel": rel})
    if not (rel <= COS_ACCCHK_REL and chk["ainf"] > 0 and cres.tt.device.type == "cuda"):
        raise AssertionError(f"coscoeff_d6: accchk {chk}")
    if counts["score_residual_argmax"] <= 0:     # its integrand looks no table up: no kernel B
        raise AssertionError(f"coscoeff_d6: kernel A was not launched: {counts}")
    _require_held("coscoeff_d6", shapes_k, held)
    runs.append(("coscoeff_d6", shapes_k))

    # stdnorm_d10 (n = 32 -> 33, rank 8): kernel B on the 33-point table
    h = STDNORM
    sp = make_stdnorm(d=h["d"], n=h["n"])
    K.reset_launch_counts()
    t0 = time.perf_counter()
    sres = cross(sp.fun, [sp.n] * sp.d, max_rank=h["max_rank"], accuracy=h["accuracy"],
                 pivoting=h["pivoting"], quad=[sp.quad_weights] * sp.d, truth=sp.truth)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, shapes_s = K.launch_counts(), K.launch_shapes()
    sdigits = float(-np.log10(sres.errors[-1]))
    _emit({"phase": "mvn", "config": "stdnorm_d10 n=33 rank 8 pivoting=1",
           **_mvn_row(sres, wall, sdigits, counts, shapes_s)})
    if sdigits < STDNORM_DIGITS or min(counts[k] for k in MVN_KERNELS) <= 0:
        raise AssertionError(f"stdnorm_d10: {sdigits} digits, launches {counts}")
    _require_held("stdnorm_d10", shapes_s, held)
    runs.append(("stdnorm_d10", shapes_s))

    # serialization: the reference's 'TT' stream, from the card and back onto it
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        save_ttbin_ref(res.tt, tmp + "/mvn.tt")
        back = load_ttbin_ref(tmp + "/mvn.tt")
    same = back.device.type == "cuda" and all(torch.equal(a, b)
                                              for a, b in zip(back.cores, res.tt.cores))
    _emit({"phase": "mvn", "config": "save_ttbin_ref -> load_ttbin_ref on the card",
           "cores_bit_equal": same, "entries": res.tt.mem()})
    if not same:
        raise AssertionError("the serialization round trip changed the train")

    _emit(check_small_mvn_against_cpu(dev, held))
    return runs


SMALL_MVN_VARIANTS = {"greedy": {}, "refine_sweeps=1": {"refine_sweeps": 1},
                      "oversample=2": {"oversample": 2},
                      "weighted_lottery": {"weighted_lottery": True}}


def small_mvn_against_cpu(dev, extra):
    """One small MVN cross (d = 4, n = 17, rank 6) on the card against the
    same cross (same uniforms) on the CPU, where every kernel is its plain
    version: ranks, evals, padded evals and sweeps equal, values to 1e-12
    (1e-11 where oversampling rounds the train: SVDs on two devices).  The
    density has a perturbed mean and covariance: the default one is symmetric
    under permutations of its modes, which leaves mirrored pivots to the last
    bit.  Returns (row, launch counts, launches by shape) of the card's run."""
    import numpy as np

    from ttcross_tpu_torch.apps import make_mvn
    from ttcross_tpu_torch.cross import cross
    from ttcross_tpu_torch.interop import mvn_from_numpy
    from ttcross_tpu_torch.ops import kernels as K

    base = make_mvn(d=4, n=17, device="cpu")
    rng = np.random.default_rng(5)
    A = rng.normal(size=(4, 4)) * 0.1
    cov, mu = base.density.cov + A @ A.T, base.density.mu + rng.normal(size=4) * 0.1
    out = {}
    K.reset_launch_counts()
    for where in ("cpu", dev):
        p = mvn_from_numpy(base.nodes, base.quad_weights, mu, cov, np.linalg.inv(cov),
                           float(np.linalg.det(cov)), where)
        out[str(where)] = cross(p.fun, [p.n] * p.d, max_rank=6, pivoting=1,
                                quad=[p.quad_weights] * p.d, truth=1.0, device=where, **extra)
    counts, shapes = K.launch_counts(), K.launch_shapes()
    c, g = out["cpu"], out[str(dev)]
    if g.tt.device.type != "cuda" or min(counts[k] for k in MVN_KERNELS) <= 0:
        raise AssertionError(f"small MVN {extra}: train on {g.tt.device}, launches {counts}")
    if (c.ranks, c.neval, c.padded_evals, c.sweeps) != (g.ranks, g.neval, g.padded_evals, g.sweeps):
        raise AssertionError(f"small MVN {extra} on the card {g.ranks} {g.neval} != CPU "
                             f"{c.ranks} {c.neval}")
    rel = float(np.max(np.abs(np.subtract(g.values, c.values)) / np.abs(c.values)))
    if rel > (1e-11 if extra.get("oversample") else 1e-12):
        raise AssertionError(f"small MVN {extra}: the card differs from the CPU by {rel}")
    return ({"ranks": list(g.ranks), "n_evals": g.neval, "max_rel_value_diff": rel},
            counts, shapes)


def check_small_mvn_against_cpu(dev, held) -> dict:
    """small_mvn_against_cpu for the greedy, refined, oversampled and
    weighted cross, each launching at shapes in `held` only."""
    rows = {}
    for name, extra in SMALL_MVN_VARIANTS.items():
        rows[name], _, shapes = small_mvn_against_cpu(dev, extra)
        _require_held(f"small MVN {name}", shapes, held)
    return {"phase": "mvn_small_vs_cpu", **rows}


def profile_maxvol_parts(dev) -> None:
    """Kernels, device-only time and host time per call of the maxvol
    refinement's parts at mvn_d6's shapes (R = 20, N = 65, d = 6) from the
    greedy cross's pivot sets: one L->R and one R->L visit of a middle bond,
    the selection alone on the (1300, 20) fiber cross, and the integrand's
    (26000, 6) batch alone."""
    import torch

    from ttcross_tpu_torch.cross.chains import pivot_index_sets
    from ttcross_tpu_torch.cross.maxvol import _pad_sets, _refine_engine, maxvol_select

    res, _, _, _, _, prob = run_mvn(dev, return_state=True)
    R, N, d = MVN["max_rank"], prob.n, prob.d
    LI, RJ, rr = (torch.from_numpy(a).to(dev) for a in
                  _pad_sets(*pivot_index_sets(res.state.vip, res.state.rk), d, R))
    kit = _refine_engine(prob.fun, (N,) * d, R, 8, 1.01, dev)
    z = torch.zeros((), dtype=torch.int64, device=dev)
    M = torch.randn((R * N, R), dtype=torch.float64, device=dev)
    rowm = torch.ones(R * N, dtype=torch.bool, device=dev)
    ind = torch.randint(0, N, (R * N * R, d), dtype=torch.int32, device=dev)
    parts = {
        "visit_lr, bond 2": lambda: kit.visit_lr(2, LI.clone(), RJ, rr, z, z),
        "visit_rl, bond 2": lambda: kit.visit_rl(2, LI, RJ.clone(), rr, z, z),
        "maxvol_select (1300, 20)": lambda: maxvol_select(M, rowm, rr[2]),
        "integrand (26000, 6)": lambda: prob.fun(ind),
    }
    rows = {}
    for name, fn in parts.items():
        got = device_per_call(fn, calls=10)
        rows[name] = {"kernels_per_call": got["kernels_per_call"], "device_us": got["device_us"],
                      "host_ms_per_call": host_us_per_call(fn, calls=20) * 1e-3}
    _emit({"phase": "profile", "run": "mvn_d6 maxvol sweep parts, per call", **rows})


def hold_new_shapes(dev, gen, shapes, held, checked, label="skeleton") -> None:
    """Hold the shapes that a run's data or options decide (a skeleton's
    batch is its number of samples; a capped or chunked sweep launches at
    per-bond, per-chunk shapes) the way phase 3 holds the fixed ones: every
    kernel at every such shape the run launched it at, in the launch's
    dtype, with phase 3's checks, times and bound; the rows join `checked`
    and `held`."""
    import torch

    from ttcross_tpu_torch.apps import make_ising

    def new(name):
        for sh in sorted(set(shapes.get(name, {})) - held[name], key=str):
            f32 = sh[-1] == "f32"
            yield (sh[:-1] if f32 else sh), (torch.float32 if f32 else torch.float64)

    a_cases, b_cases, i_cases, p_cases = [], [], [], []
    for (M, Kc, R), dt in new("score_residual_argmax"):
        a_cases.append((f"{label}_{M}x{Kc}_r{R}", _score_inputs(gen, M, Kc, R, dev, dt)))
    for (L, B, d, n), dt in new("small_table_lookup"):
        tables = torch.randn((L, n), generator=gen, dtype=torch.float64).to(dev, dt)
        ind = torch.randint(-2, n + 2, (B, d), generator=gen, dtype=torch.int32).to(dev)
        b_cases.append((f"{label}_{B}x{d}_n{n}", (tables, ind)))
    for (B, d, n), dt in new("ising_integrand_fused"):
        p = make_ising("C", d + 1, n - 1, device=dev, dtype=dt)
        ind = torch.randint(0, p.n, (B, d), generator=gen, dtype=torch.int32)
        ind[0, 0], ind[min(1, B - 1), d - 1] = -1, p.n
        i_cases.append((f"{label}_{B}x{d}", "C", p.tables, ind.to(dev)))
    for (P, M, Kc, R), dt in new("score_residual_argmax_batched"):
        p_cases.append(((f"{label}_{P}x{M}x{Kc}", P, M, Kc, R), dt))
    a_rows, b_rows = check_kernels(dev, a_cases, b_cases)
    p_rows = [r for case, dt in p_cases for r in check_batched(dev, gen, [case], dt)]
    for name, rows in [("score_residual_argmax", a_rows), ("small_table_lookup", b_rows),
                       ("ising_integrand_fused", check_integrand(i_cases)),
                       ("score_residual_argmax_batched", p_rows)]:
        for r in rows:
            checked[name][tuple(r["shape"])] = r
            held[name].add(tuple(r["shape"]))


def _merge_shapes(runs) -> dict:
    """launch_shapes() of several runs, summed."""
    out = {name: {} for shapes in runs for name in shapes}
    for shapes in runs:
        for name, by in shapes.items():
            for sh, c in by.items():
                out[name][sh] = out[name].get(sh, 0) + c
    return out


def check_headline_host_reeval(dev, gen, held, checked, device_only):
    """Phase 8: the headline exactly as bench.py runs it (bench.py:220-224),
    cross(..., oversample=6, host_reeval=True): the rank-30 cross on the
    card, its skeleton re-evaluated by the integrand on the card (one
    fused-integrand launch at the skeleton's batch), rebuilt, rounded and
    valued on the host.  Keys 0-7 against the headline's floors, each beside
    phase 4's device-only train of the same key (`device_only`: (result,
    digits) per key); n_evals is the device run's plus the skeleton's
    samples.  Returns the launches by shape of key 0's first run."""
    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross, extract_skeleton
    from ttcross_tpu_torch.ops import kernels as K

    h = HEADLINE
    prob = make_ising("C", h["m"], h["n"], device=dev)
    kw = dict(accuracy=h["accuracy"], pivoting=h["pivoting"], quad=[prob.quad_weights] * prob.d,
              truth=prob.truth, device=dev)

    def run(key):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = cross(prob.fun, [prob.n] * prob.d, max_rank=h["max_rank"], oversample=6,
                    host_reeval=True, key=key, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not (res.tt.device.type == torch.device(dev).type and max(res.ranks) <= h["max_rank"]
                and res.history[-1].direction == "hr" and np.isfinite(res.values[-1])):
            raise AssertionError(f"malformed host_reeval result: ranks {res.ranks}")
        return res, wall, float(-np.log10(res.errors[-1])), K.launch_counts(), K.launch_shapes()

    first = run(0)
    steady = run(0)
    pivots = cross(prob.fun, [prob.n] * prob.d, max_rank=h["max_rank"] + 6, key=0,
                   return_pivots=True, **kw)
    skel = extract_skeleton(pivots, [prob.n] * prob.d, device=dev)
    runs = [first] + [run(k) for k in KEYS[1:]]
    rows = []
    for key, (res, wall, digits, counts, shapes) in zip(KEYS, runs):
        dres, ddigits = device_only[key]
        samples = res.neval - dres.neval
        at = (samples, prob.d, prob.n)
        rows.append({"key": key, "digits": digits, "n_evals": res.neval, "wall_s": wall,
                     "device_only_digits": ddigits, "device_only_n_evals": dres.neval,
                     "skeleton_samples": samples,
                     "skeleton_launches": shapes["ising_integrand_fused"].get(at, 0)})
        launched = shapes["ising_integrand_fused"].get(at, 0) == 1 or torch.device(dev).type == "cpu"
        if not launched or res.padded_evals - dres.padded_evals != samples:
            raise AssertionError(f"host_reeval key {key}: n_evals {res.neval} is the device run's "
                                 f"{dres.neval} plus {samples}, but the integrand launched "
                                 f"{shapes['ising_integrand_fused']} (one launch at {at} expected)")
    if runs[0][0].neval != device_only[0][0].neval + skel.n_samples:
        raise AssertionError(f"host_reeval key 0: {runs[0][0].neval} evals != device-only "
                             f"{device_only[0][0].neval} + {skel.n_samples} skeleton samples")
    by_key = [r["digits"] for r in rows]
    median = statistics.median(by_key)
    all_shapes = _merge_shapes([r[4] for r in runs])
    hold_new_shapes(dev, gen, all_shapes, held, checked)
    _emit({"phase": "headline_host_reeval",
           "config": "C_6 n=65 rank 24 oversample=6 host_reeval=True pivoting=1 (bench.py:220-224)",
           "first_s": first[1], "steady_s": steady[1], "skeleton_samples_key0": skel.n_samples,
           "launches": first[3], "launches_by_shape": _by_shape(first[4]), "by_key": rows,
           "digits_by_key": by_key, "median_digits": median,
           "device_only_median_digits": statistics.median(dg for _, dg in device_only)})
    if median < DIGITS_MEDIAN or min(by_key) < DIGITS_FLOOR:
        raise AssertionError(f"host_reeval headline digits over keys {by_key}: median {median} < "
                             f"{DIGITS_MEDIAN} or a key < {DIGITS_FLOOR}")
    if (steady[0].neval, steady[0].ranks, steady[2]) != (first[0].neval, first[0].ranks, first[2]):
        raise AssertionError("the repeated host_reeval headline took another path")
    if min(first[3][k] for k in MAIN_PATH_KERNELS) <= 0 and torch.device(dev).type == "cuda":
        raise AssertionError(f"host_reeval headline: a kernel of its path was not launched: {first[3]}")
    for key, r in zip(KEYS, runs):
        _require_held(f"C_6 headline host_reeval key {key}", r[4], held)
    return first[4]


def f32_cases(dev, gen):
    """Phase 3's f32 instantiations, at the shapes the f32 runs of phase 14
    launch them (C_6 n = 65 at rank 24: rook fibers of 1560, lottery 178,
    init 520 / 325; mvn_d6 at rank 20, mvn_shapes) and, for the paths no
    f32 run drives, at the f64 phase's shapes: kernel A's 2-D path (the
    SIMT kernel) and a long fiber, the batched kernel A at C_256's, the
    fused integrand's D / E rows and its warp path at C_256's fibers."""
    import torch

    from ttcross_tpu_torch.apps import make_ising

    f32 = torch.float32
    a = [(f"f32_{nm}", _score_inputs(gen, M, Kc, R, dev, f32)) for nm, M, Kc, R in
         [("col_c6_r24", 1560, 1, 24), ("row_c6_r24", 1, 1560, 24), ("col_mvn_r20", 1300, 1, 20),
          ("row_mvn_r20", 1, 1300, 20), ("superblock", 1950, 1950, 30),
          ("long_col", 100000, 1, 30)]]
    b = []
    for Bb, d in mvn_shapes(6, 65, 20)[1]:
        tables = torch.randn((1, 65), generator=gen, dtype=torch.float64).to(dev, f32)
        ind = torch.randint(-2, 67, (Bb, d), generator=gen, dtype=torch.int32).to(dev)
        b.append((f"f32_mvn_nodes_{Bb}x{d}", (tables, ind)))
    i = []
    for name, kind, m, n, B in [("f32_rook_fiber", "C", 6, 64, 1560), ("f32_lottery", "C", 6, 64, 178),
                                ("f32_init_diag", "C", 6, 64, 520),
                                ("f32_init_fibers", "C", 6, 64, 325),
                                ("f32_rook_fiber_D", "D", 6, 64, 1560),
                                ("f32_rook_fiber_E", "E", 6, 64, 1560),
                                ("f32_lc_fibers", "C", 256, 17, 43180)]:
        p = make_ising(kind, m, n, device=dev, dtype=f32)
        ind = torch.randint(0, p.n, (B, p.d), generator=gen, dtype=torch.int32)
        ind[0, 0], ind[1, p.d - 1] = -1, p.n
        i.append((name, kind, p.tables, ind.to(dev)))
    batched = [("f32_col_pass_c256", 254, 170, 1, 10), ("f32_row_pass_c256", 254, 1, 170, 10)]
    return a, b, i, batched


def run_capped(dev, key=0, chunks=CAPPED["rank_chunks"], caps=CAPPED["rank_caps"]):
    """One C_6 cross at rank 24 with rank chunks and per-bond caps (the JAX
    package's padded-ratio configuration, tests/test_engine.py:284-297 and
    bench.py:630-636) on the card; (result, wall, digits, launches, by
    shape)."""
    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross
    from ttcross_tpu_torch.ops import kernels as K

    h = CAPPED
    prob = make_ising("C", h["m"], h["n"], device=dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = cross(prob.fun, [prob.n] * prob.d, max_rank=h["max_rank"], accuracy=h["accuracy"],
                pivoting=h["pivoting"], quad=[prob.quad_weights] * prob.d, truth=prob.truth,
                key=key, rank_chunks=chunks, rank_caps=caps, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vals = np.asarray(res.values)
    if not (np.all(np.isfinite(vals)) and res.tt.ready()
            and res.tt.device.type == torch.device(dev).type and max(res.ranks) <= h["max_rank"]
            and all(r <= c for r, c in zip(res.ranks[1:-1], caps or [h["max_rank"]] * 4))):
        raise AssertionError(f"malformed capped result: ranks {res.ranks}, values {vals}")
    return res, wall, float(-np.log10(res.errors[-1])), K.launch_counts(), K.launch_shapes()


def _capped_row(res, wall, digits, counts, shapes) -> dict:
    return {"digits": digits, "n_evals": res.neval, "padded_evals": res.padded_evals,
            "padded_ratio": res.padded_evals / res.neval, "ranks": list(res.ranks),
            "sweeps": res.sweeps, "wall_s": wall, "launches": counts,
            "launches_by_shape": _by_shape(shapes)}


def check_capped(dev, gen, held, checked):
    """Phase 11: C_6 rank 24 with rank_chunks=[4, ..., 24] and
    rank_caps=[16, 24, 24, 16] over keys 0-7 (each key's padded ratio <=
    CAPPED_PADDED_RATIO and digits >= CAPPED_DIGITS, the JAX package's slow
    test), first and steady; rank_chunks="auto" and the uncapped greedy
    C_6 at key 0 beside it.  The per-bond, per-chunk shapes are held after
    the first run (hold_new_shapes).  Returns the launches by shape of
    key 0's first run."""
    first = run_capped(dev)
    hold_new_shapes(dev, gen, first[4], held, checked, "capped")
    steady = run_capped(dev)
    runs = [first] + [run_capped(dev, key=k) for k in KEYS[1:]]
    for r in runs[1:]:
        hold_new_shapes(dev, gen, r[4], held, checked, "capped")
    auto = run_capped(dev, chunks="auto", caps=None)
    hold_new_shapes(dev, gen, auto[4], held, checked, "chunked")
    plain = run_capped(dev, chunks=None, caps=None)
    rows = [{"key": k, **{f: v for f, v in _capped_row(*r).items() if f != "launches_by_shape"}}
            for k, r in zip(KEYS, runs)]
    _emit({"phase": "capped", "config": "C_6 n=65 rank 24 pivoting=1 rank_chunks=[4,8,12,16,20,24] "
           "rank_caps=[16,24,24,16] (tests/test_engine.py:284-297, bench.py:630-636)",
           **_capped_row(*first), "steady_s": steady[1], "by_key": rows,
           "auto_chunks_key0": _capped_row(*auto), "uncapped_key0": _capped_row(*plain)})
    for k, r in zip(KEYS, runs):
        ratio = r[0].padded_evals / r[0].neval
        if ratio > CAPPED_PADDED_RATIO or r[2] < CAPPED_DIGITS:
            raise AssertionError(f"capped C_6 key {k}: padded ratio {ratio} > {CAPPED_PADDED_RATIO} "
                                 f"or {r[2]} digits < {CAPPED_DIGITS}")
        _require_held(f"capped C_6 key {k}", r[4], held)
    for label, r in (("chunks auto", auto), ("uncapped", plain)):
        if r[2] < CAPPED_DIGITS:
            raise AssertionError(f"C_6 {label}: {r[2]} digits < {CAPPED_DIGITS}")
        _require_held(f"C_6 {label}", r[4], held)
    if (steady[0].neval, steady[0].ranks, steady[2]) != (first[0].neval, first[0].ranks, first[2]):
        raise AssertionError("the repeated capped C_6 run took another path")
    if min(first[3][k] for k in MAIN_PATH_KERNELS) <= 0:
        raise AssertionError(f"capped C_6: a kernel of its path was not launched: {first[3]}")
    return first[4]


def check_adaptive(dev, held):
    """Phase 12: stdnorm_d10 (n = 33, rank 8, accuracy 5 eps) with and
    without adaptive=True (bench.py:462-476), key 0, first and steady each:
    n_evals, digits and walls side by side (bench.py's note claims 28 %
    fewer integrand calls at identical digits); then two adaptive sweeps
    under torch's sync debug mode set to raise.  Returns the adaptive run's
    launches by shape."""
    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import make_stdnorm
    from ttcross_tpu_torch.config import precision_thresholds
    from ttcross_tpu_torch.cross import cross
    from ttcross_tpu_torch.cross.engine import CrossConfig, make_engine
    from ttcross_tpu_torch.ops import kernels as K

    h = STDNORM
    sp = make_stdnorm(d=h["d"], n=h["n"], device=dev)

    def run(adaptive):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = cross(sp.fun, [sp.n] * sp.d, max_rank=h["max_rank"], accuracy=h["accuracy"],
                    pivoting=h["pivoting"], quad=[sp.quad_weights] * sp.d, truth=sp.truth,
                    adaptive=adaptive, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return res, wall, float(-np.log10(res.errors[-1])), K.launch_counts(), K.launch_shapes()

    out, runs = {}, {}
    for label, ad in (("plain", 0.0), ("adaptive", True)):
        a, b = run(ad), run(ad)
        runs[label] = a
        out[label] = {**_mvn_row(*a), "steady_s": b[1]}
        _require_held(f"stdnorm_d10 {label}", a[4], held)
        if (b[0].neval, b[2]) != (a[0].neval, a[2]):
            raise AssertionError(f"the repeated stdnorm_d10 {label} run took another path")
    se, spv = precision_thresholds(torch.float64)
    cfg = CrossConfig(d=sp.d, n=(sp.n,) * sp.d, N=sp.n, R=h["max_rank"], piv=h["pivoting"],
                      small_element=se, small_pivot=spv, adaptive=4096.0)
    kit = make_engine(sp.fun, cfg, dev)
    st = kit.init_fn()
    U = torch.rand((2, sp.d - 1, 2, 2 * (h["max_rank"] + sp.n)), dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for it in (1, 2):
            st = kit.sweep_fn(st, it, U[it - 1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    p, a = runs["plain"][0], runs["adaptive"][0]
    _emit({"phase": "adaptive", "config": "stdnorm_d10 n=33 rank 8 pivoting=1 accuracy=5 eps, "
           "adaptive=True (margin 4096) vs off (bench.py:462-476)", **out,
           "n_evals_saved_share": 1 - a.neval / p.neval,
           "digits_difference": runs["adaptive"][2] - runs["plain"][2],
           "sync_free_adaptive_sweeps": 2})
    if runs["adaptive"][2] < STDNORM_DIGITS or a.neval >= p.neval:
        raise AssertionError(f"adaptive stdnorm_d10: {runs['adaptive'][2]} digits, {a.neval} "
                             f"evals against {p.neval} without the gate")
    return runs["adaptive"][4]


def check_quantics(dev, gen, held, checked):
    """Phase 13: quantics (tests/test_quantics.py:104-125): exp(x) sin(6 pi
    x) on the 2^20 grid at rank 10, pivoting 2: the greedy train's point
    error at x = i/64 above QUANTICS_PLATEAU (the conditioning plateau is
    real), with refine_sweeps=1 below QUANTICS_REFINED; exp at rank 4 and
    its left Riemann sum (-> e - 1); the 2-D Gaussian on [-3, 3)^2 at
    K = 10 bits per coordinate, held as tests/test_quantics.py holds it
    (left Riemann sum within 2e-2 of the mass, the train within 1e-8 at
    grid points).  Kernel A on every rook pass (the
    integrands are plain torch).  Returns the launches by shape of the
    greedy run."""
    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import make_quantics, quantics_cross
    from ttcross_tpu_torch.cross import cross
    from ttcross_tpu_torch.ops import kernels as K

    q = QUANTICS
    xs = np.arange(64) / 64.0
    tru = np.exp(xs) * np.sin(6 * np.pi * xs)

    def f(x):
        return torch.exp(x) * torch.sin(6 * np.pi * x)

    def run(**kw):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        prob, res = quantics_cross(f, q["K"], max_rank=q["max_rank"], pivoting=q["pivoting"],
                                   accuracy=q["accuracy"], device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        err = float(np.abs(prob.value(res.tt, xs[:, None]).cpu().numpy() - tru).max())
        return res, wall, err, K.launch_counts(), K.launch_shapes()

    greedy, refined = run(), run(refine_sweeps=1)
    h = 2.0 ** -q["K"]
    prob, eres = quantics_cross(torch.exp, q["K"], max_rank=4, pivoting=1, accuracy=1e-13,
                                device=dev)
    riemann = h * (np.e - 1.0) / (np.exp(h) - 1.0)
    p2 = make_quantics(lambda x: torch.exp(-(x[:, 0] ** 2 + x[:, 1] ** 2)), 10, dd=2,
                       domain=(-3.0, 3.0), device=dev)
    K.reset_launch_counts()
    r2 = cross(p2.fun, [p2.n] * p2.d, max_rank=8, pivoting=1, accuracy=1e-12, small_pivot=1e-14,
               quad=p2.quad_weights, device=dev)
    shapes2 = K.launch_shapes()
    xy = np.stack([np.linspace(-2.9, 2.9, 16), np.linspace(2.9, -2.9, 16)], axis=1)
    cell = 6.0 / 2 ** 10
    grid = -3.0 + cell * np.floor((xy + 3.0) / cell)
    err2 = float(np.abs(p2.value(r2.tt, xy).cpu().numpy() - np.exp(-(grid ** 2).sum(1))).max())
    for r in (greedy, refined):
        hold_new_shapes(dev, gen, r[4], held, checked, "quantics")
    hold_new_shapes(dev, gen, shapes2, held, checked, "quantics_2d")
    row = {"phase": "quantics", "config": "exp(x) sin(6 pi x), K = 20, rank 10, pivoting 2, "
           "accuracy 1e-13 (tests/test_quantics.py:104-125)"}
    for label, r in (("greedy", greedy), ("refine_sweeps=1", refined)):
        row[label] = {"point_error": r[2], "n_evals": r[0].neval, "ranks": list(r[0].ranks),
                      "sweeps": r[0].sweeps, "wall_s": r[1], "launches": r[3],
                      "launches_by_shape": _by_shape(r[4])}
    row["exp_rank4"] = {"value": eres.values[-1], "riemann_sum": riemann,
                        "rel_vs_riemann": abs(1 - eres.values[-1] / riemann),
                        "rel_vs_e_minus_1": abs(1 - eres.values[-1] / (np.e - 1)),
                        "ranks": list(eres.ranks)}
    mass = (np.sqrt(np.pi) * math.erf(3.0)) ** 2      # (int_-3^3 e^{-x^2} dx)^2
    row["gauss_2d"] = {"K": 10, "value": r2.values[-1], "mass": mass,
                       "rel_vs_mass": abs(1 - r2.values[-1] / mass),
                       "point_error": err2, "ranks": list(r2.ranks), "n_evals": r2.neval}
    _emit(row)
    if not (greedy[2] > QUANTICS_PLATEAU and refined[2] < QUANTICS_REFINED):
        raise AssertionError(f"quantics: greedy point error {greedy[2]} (> {QUANTICS_PLATEAU} "
                             f"expected), refined {refined[2]} (< {QUANTICS_REFINED} required)")
    if abs(1 - eres.values[-1] / riemann) > 1e-10 or max(eres.ranks) > 2:
        raise AssertionError(f"quantics exp: {eres.values[-1]} vs the Riemann sum {riemann}")
    if abs(1 - r2.values[-1] / mass) > 2e-2 or err2 > 1e-8:     # as tests/test_quantics.py
        raise AssertionError(f"quantics 2-D: mass {r2.values[-1]}, point error {err2}")
    for label, r in (("greedy", greedy), ("refined", refined)):
        if r[3]["score_residual_argmax"] <= 0:
            raise AssertionError(f"quantics {label}: kernel A was not launched: {r[3]}")
        _require_held(f"quantics {label}", r[4], held)
    _require_held("quantics 2-D", shapes2, held)
    return greedy[4]


def run_f32(dev, which, key=0):
    """One f32 cross on the card: the C_6 (rank 24) or the mvn_d6 (rank 20)
    problem made in float32 and crossed with dtype=torch.float32, rook,
    accuracy F32_ACCURACY; (result, wall, digits, launches, by shape)."""
    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import make_ising, make_mvn
    from ttcross_tpu_torch.cross import cross
    from ttcross_tpu_torch.ops import kernels as K

    f32 = torch.float32
    if which == "C_6":
        prob, R = make_ising("C", HEADLINE["m"], HEADLINE["n"], device=dev, dtype=f32), 24
    else:
        prob, R = make_mvn(d=MVN["d"], n=MVN["n"], device=dev, dtype=f32), MVN["max_rank"]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = cross(prob.fun, [prob.n] * prob.d, max_rank=R, accuracy=F32_ACCURACY, pivoting=1,
                quad=[prob.quad_weights] * prob.d, truth=prob.truth, key=key, dtype=f32,
                return_state=True, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vals = np.asarray(res.values)
    if not (np.all(np.isfinite(vals)) and res.tt.dtype == f32
            and res.tt.device.type == torch.device(dev).type
            and res.state.cores.dtype == f32 and max(res.ranks) <= R):
        raise AssertionError(f"malformed f32 result: ranks {res.ranks}, values {vals}")
    return res, wall, float(-np.log10(res.errors[-1])), K.launch_counts(), K.launch_shapes()


def check_f32(dev, gen, held, checked):
    """Phase 14: the f32 tier.  C_6 (n = 65, rank 24, rook) in float32 over
    keys 0-7 through kernel A's and the fused integrand's f32
    instantiations, held to F32_FLOORS; mvn_d6 greedy (n = 65, rank 20) in
    float32, key 0, through kernel B's and kernel A's.  Every launch of
    these runs is an f32 one, at a shape phase 3 held in f32.  Returns the
    launches by shape of key 0's C_6 run and of the mvn_d6 run."""
    first = run_f32(dev, "C_6")
    steady = run_f32(dev, "C_6")
    runs = [first] + [run_f32(dev, "C_6", key=k) for k in KEYS[1:]]
    mvn = run_f32(dev, "mvn_d6")
    by_key = [r[2] for r in runs]
    median = statistics.median(by_key)
    _emit({"phase": "f32", "config": "C_6 n=65 rank 24 pivoting=1 accuracy=1e-6 float32",
           **_capped_row(*first), "steady_s": steady[1], "digits_by_key": by_key,
           "median_digits": median, "mvn_d6": _mvn_row(*mvn)})
    (fm, fk), mvn_floor = F32_FLOORS["C_6"], F32_FLOORS["mvn_d6"]
    if median < fm or min(by_key) < fk or mvn[2] < mvn_floor:
        raise AssertionError(f"f32 digits: C_6 over keys {by_key} (median >= {fm}, each >= {fk}), "
                             f"mvn_d6 {mvn[2]} (>= {mvn_floor})")
    for label, r, need in (("C_6", first, MAIN_PATH_KERNELS), ("mvn_d6", mvn, MVN_KERNELS)):
        f64 = {n: [sh for sh in by if sh[-1] != "f32"] for n, by in r[4].items()}
        if any(f64.values()) or min(r[3][k] for k in need) <= 0:
            raise AssertionError(f"f32 {label}: launches {r[4]} (f32 ones only, of {need})")
    for k, r in zip(KEYS, runs):
        _require_held(f"f32 C_6 key {k}", r[4], held)
    _require_held("f32 mvn_d6", mvn[4], held)
    if (steady[0].neval, steady[0].ranks, steady[2]) != (first[0].neval, first[0].ranks, first[2]):
        raise AssertionError("the repeated f32 C_6 run took another path")
    return first[4], mvn[4]


def device_launches(fn) -> int:
    """Kernel launches on the card during one call of fn (torch.profiler's
    device events), every eager op's, not only the hand kernels'."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return int(sum(e.count for e in prof.key_averages()
                   if "CUDA" in str(getattr(e, "device_type", ""))))


def check_family(dev, held):
    """Phase 9: the mvn_d6 family of bench.py:707-741, four correlations in
    one cross_batch (rank 20, greedy), first and steady call; then each
    lane's single cross() with its lane_key, first and steady.  Every lane
    equals its single run (ranks, sweeps, n_evals, vip; values to
    FAMILY_RTOL), the worst lane holds FAMILY_WORST_FLOOR, kernel B launches
    once per lane-batched integrand step (a single run's count, not L
    times) and kernel A once per pass for all lanes (batched).  Returns
    the batch's launches by shape."""
    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import make_mvn_family
    from ttcross_tpu_torch.cross import cross, cross_batch, lane_key
    from ttcross_tpu_torch.ops import kernels as K

    fam = make_mvn_family(d=MVN["d"], n=MVN["n"], corrs=np.linspace(0.2, 0.6, FAMILY_LANES),
                          device=dev)
    kw = dict(max_rank=MVN["max_rank"], accuracy=MVN["accuracy"], pivoting=MVN["pivoting"],
              quad=[fam.quad_weights] * fam.d, truth=1.0, device=dev)

    def timed(fn):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, K.launch_counts(), K.launch_shapes()

    def batch():
        return cross_batch(fam.fun, [fam.n] * fam.d, fam.params, **kw)

    res, first, launches, shapes = timed(batch)
    res2, steady, launches2, _ = timed(batch)
    singles = []
    for lane in range(FAMILY_LANES):
        fun = (lambda par: lambda ind: fam.fun(ind, par))(fam.lane(lane))

        def one(fun=fun, lane=lane):
            return cross(fun, [fam.n] * fam.d, key=lane_key(0, lane), return_pivots=True, **kw)

        s1, w1, c1, _ = timed(one)
        singles.append((s1, w1, timed(one)[1], c1, one))
    rows, rels = [], []
    for lane, (r, (s, w1, w2, c, _)) in enumerate(zip(res, singles)):
        rel = float(np.max(np.abs(np.subtract(r.values, s.values)) / np.abs(s.values)))
        rels.append(rel)
        same = (r.ranks == s.ranks and r.sweeps == s.sweeps and r.neval == s.neval
                and np.array_equal(r.state.vip, s.state.vip))
        rows.append({"lane": lane, "corr": fam.corrs[lane], "digits": float(-np.log10(r.errors[-1])),
                     "n_evals": r.neval, "ranks": list(r.ranks), "sweeps": r.sweeps,
                     "single_first_s": w1, "single_steady_s": w2, "single_launches": c,
                     "equals_single_run": same, "max_rel_value_diff": rel})
    worst = min(row["digits"] for row in rows)
    busy = {"batch": device_launches(batch), "single_lane_0": device_launches(singles[0][4])}
    steps = max(c["small_table_lookup"] for *_, c, _ in singles)
    _emit({"phase": "family", "config": "mvn_d6 n=65 rank 20 pivoting=1, 4 lanes corr 0.2-0.6 "
           "(bench.py:707-741)", "first_s": first, "steady_s": steady, "n_evals": res.neval,
           "sweeps": res.sweeps, "worst_lane_digits": worst, "lanes": rows,
           "singles_first_s": sum(x[1] for x in singles), "singles_steady_s": sum(x[2] for x in singles),
           "launches": launches, "launches_by_shape": _by_shape(shapes),
           "device_launches_per_run": busy,
           "device_launches_singles_estimate": busy["single_lane_0"] * FAMILY_LANES})
    for row, (r, (s, *_)) in zip(rows, zip(res, singles)):
        if not row["equals_single_run"] or row["max_rel_value_diff"] > FAMILY_RTOL:
            raise AssertionError(f"family lane {row['lane']}: ranks {r.ranks} / {s.ranks}, evals "
                                 f"{r.neval} / {s.neval}, vip equal {row['equals_single_run']}, "
                                 f"values {row['max_rel_value_diff']} apart")
    if worst < FAMILY_WORST_FLOOR:
        raise AssertionError(f"family worst lane {worst} digits < {FAMILY_WORST_FLOOR}")
    if launches["small_table_lookup"] != steps or launches["score_residual_argmax"] != 0 or \
            launches["score_residual_argmax_batched"] != max(c["score_residual_argmax"]
                                                             for *_, c, _ in singles):
        raise AssertionError(f"family: launches {launches}, a single run's {singles[0][3]}: kernel B "
                             "once per integrand step and kernel A batched once per pass expected")
    if (res2.neval, [r.ranks for r in res2], launches2) != (res.neval, [r.ranks for r in res], launches):
        raise AssertionError("the repeated family run took another path")
    _require_held("mvn_d6 family", shapes, held)
    return shapes


def mvn_rho_fun(nodes, d, sigma=0.4, T=1.0):
    """drivers/crs_greeks.py::mvn_rho_fun on the port: the MVN pdf with the
    equicorrelation rho a differentiable parameter (closed-form
    Sherman-Morrison inverse of cov = s2 ((1 - rho) I + rho 11^T)).  The
    node lookup is kernel B: its inputs, the indices and the nodes, are free
    of rho, so it runs under torch.func.grad and once under torch.func.vmap
    over rho."""
    import numpy as np
    import torch

    from ttcross_tpu_torch.ops.dense import table_lookup

    s2 = sigma * sigma * T
    mu = float(np.log(100.0) - 0.5 * sigma * sigma * T)

    def fun(ind, rho):
        diff = table_lookup(nodes, ind) - mu
        denom = 1.0 + (d - 1.0) * rho
        q = ((diff * diff).sum(dim=1) - rho / denom * diff.sum(dim=1) ** 2) / (s2 * (1.0 - rho))
        det = (s2 ** d) * ((1.0 - rho) ** (d - 1)) * denom
        return torch.exp(-0.5 * q) / torch.sqrt((2.0 * np.pi) ** d * det)

    return fun


def check_greeks(dev, gen, held, checked):
    """Phase 10: drivers/crs_greeks.py's problem at its defaults on the card:
    a cross at rho0 (return_state), its frozen skeleton, the skeleton value,
    its torch.func.grad against a central difference of the skeleton value
    (crs_greeks.py's sanity check), and the vmapped rho sweep of values and
    Greeks against the same sweep point by point.  Returns the launches by
    shape of the cross and of the skeleton's evaluations."""
    import numpy as np
    import torch

    from ttcross_tpu_torch.apps.mvn import MVN_BOX
    from ttcross_tpu_torch.cross import cross, extract_skeleton, skeleton_value_fn
    from ttcross_tpu_torch.ops import kernels as K
    from ttcross_tpu_torch.ops.quadrature import lgwt, map_to_interval

    g = GREEKS
    d, n = g["d"], g["n"]
    x, w = map_to_interval(*lgwt(n), *MVN_BOX)
    fun = mvn_rho_fun(torch.from_numpy(x).to(dev), d)
    rho0 = torch.tensor(g["rho0"], dtype=torch.float64, device=dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = cross(lambda i: fun(i, rho0), [n] * d, max_rank=g["max_rank"], accuracy=MVN["accuracy"],
                pivoting=1, quad=[w] * d, truth=1.0, key=g["key"], return_state=True, device=dev)
    torch.cuda.synchronize()
    cross_s = time.perf_counter() - t0
    cross_shapes = K.launch_shapes()
    skel = extract_skeleton(res, [n] * d, device=dev)
    vfn = skeleton_value_fn(fun, skel, weights=[w] * d)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    v0 = float(vfn(rho0))
    grad = float(torch.func.grad(vfn)(rho0))
    h = 1e-5
    fd = (float(vfn(rho0 + h)) - float(vfn(rho0 - h))) / (2 * h)
    greek_s = time.perf_counter() - t0
    skel_shapes = K.launch_shapes()
    rhos = torch.linspace(0.3, 0.7, g["nrho"], dtype=torch.float64, device=dev)
    K.reset_launch_counts()
    sweep = torch.func.vmap(vfn)(rhos)
    sweep_launches = K.launch_counts()["small_table_lookup"]
    greeks = torch.func.vmap(torch.func.grad(vfn))(rhos)
    pointwise = torch.stack([vfn(r) for r in rhos])
    pointwise_g = torch.stack([torch.func.grad(vfn)(r) for r in rhos])
    sweep_rel = float(((sweep - pointwise).abs() / pointwise.abs()).max())
    greek_abs = float(((greeks - pointwise_g).abs() / pointwise_g.abs().clamp(min=1.0)).max())
    _emit({"phase": "greeks", "config": "drivers/crs_greeks.py defaults: d=6 n=65 rank 14 rho0=0.5",
           "cross_s": cross_s, "n_evals": res.neval, "ranks": list(res.ranks),
           "skeleton_samples": skel.n_samples, "mass_rho0": v0, "cross_value": res.values[-1],
           "dmass_drho": grad, "central_difference": fd, "grad_vs_fd_rel": abs(grad - fd) / abs(grad),
           "value_grad_fd_s": greek_s, "rhos": rhos.tolist(), "masses": sweep.tolist(),
           "greeks": greeks.tolist(), "sweep_vs_pointwise_rel": sweep_rel,
           "greeks_vs_pointwise": greek_abs, "kernel_b_launches_per_vmapped_sweep": sweep_launches,
           "cross_launches_by_shape": _by_shape(cross_shapes),
           "skeleton_launches_by_shape": _by_shape(skel_shapes)})
    if abs(v0 / res.values[-1] - 1) > GREEK_VALUE_RTOL or abs(grad - fd) > GREEK_FD_RTOL * max(1.0, abs(grad)):
        raise AssertionError(f"Greeks: skeleton value {v0} vs the cross's {res.values[-1]}, grad "
                             f"{grad} vs central difference {fd}")
    on_card = rhos.device.type == "cuda"
    if sweep_rel > GREEK_SWEEP_RTOL or greek_abs > GREEK_FD_RTOL or sweep_launches != on_card:
        raise AssertionError(f"Greeks: vmapped sweep {sweep_rel} / {greek_abs} from the pointwise "
                             f"values, {sweep_launches} kernel-B launches for the vmapped sweep")
    hold_new_shapes(dev, gen, skel_shapes, held, checked)
    _require_held("Greeks cross", cross_shapes, held)
    _require_held("Greeks skeleton", skel_shapes, held)
    return _merge_shapes([cross_shapes, skel_shapes])


# ------------------------------------------------------------ phase 15: the dd tier
def _dd_bound(name, shape):
    """The least time of a dd kernel's call: f64 flops (DD_MUL_FLOPS per dd
    multiply, DD_ADD_FLOPS per dd add) over the f64 vector rate, or bytes
    (each input read once: hi and lo of every operand as the lottery's
    gathered layout holds them, each output written once) over the memory
    rate, whichever is larger."""
    madd = DD_MUL_FLOPS + DD_ADD_FLOPS
    if name == "dd_score_residual_argmax":
        B, T = shape
        nbytes, flops = 16 * (2 * B * T + B) + B + 16 * B + 32, B * T * madd + B * DD_ADD_FLOPS
    elif name == "dd_dot":
        M, N, T = shape
        nbytes, flops = 16 * (M * T + T * N + M * N), M * N * T * madd
    elif name == "dd_gather_tt_fused":     # (B, N) + the train's ranks
        B, N, ranks = shape[0], shape[1], shape[2:]
        d = len(ranks) - 1
        pairs = sum(ranks[c] * ranks[c + 1] for c in range(d))
        nbytes, flops = 8 * N * pairs + 4 * B * d + 16 * B, B * pairs * madd
    else:   # ising_c_integrand_dd_fused: 2d scan steps, the product, dd_div, d weights, one more
        B, d, n = shape
        div = 3 + 2 * DD_MUL_FLOPS + 2 * DD_ADD_FLOPS + 6
        nbytes = 4 * B * d + 32 * n + 16 * B
        flops = B * (2 * d * madd + DD_MUL_FLOPS + div + d * DD_MUL_FLOPS + DD_MUL_FLOPS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F64_VECTOR_FLOPS
    return max(t_bytes, t_ops) * 1e6, ("bytes" if t_bytes >= t_ops else "operations")


def _dd_pair(gen, shape, dev):
    """A normalized dd pair of random values on the card."""
    import torch

    from ttcross_tpu_torch.ops.dd import DD

    hi = torch.randn(shape, generator=gen, dtype=torch.float64)
    lo = hi * torch.randn(shape, generator=gen, dtype=torch.float64) * 2.0 ** -54
    return DD((hi + lo).to(dev), (lo - ((hi + lo) - hi)).to(dev))


def _dd_cases(dev, gen, name, shape):
    """(label, fn, plain) per layout that the dd engine gives the kernel at
    this shape: D1 as the lottery (both operands gathered, the rank mask on
    x), a column pass (y a broadcast vector, mask on y) and a row pass (x a
    broadcast vector, y a transposed view); D4 as a GEMM and as the
    contraction of a core against a weight vector; D3 on a random train of
    the run's ranks and modes of N; D2 on the dd C_m tables."""
    import torch

    from ttcross_tpu_torch.ops import kernels as K
    from ttcross_tpu_torch.ops.dd import DD

    def m(f, x):
        return DD(f(x.hi), f(x.lo))

    out = []
    if name == "dd_score_residual_argmax":
        B, T = shape
        vals = _dd_pair(gen, (B,), dev)
        mask = (torch.rand(B, generator=gen) > 0.3).to(dev)
        rank = torch.tensor([max(T - 1, 0)], dtype=torch.int32, device=dev)
        x, y = _dd_pair(gen, (B, T), dev), _dd_pair(gen, (B, T), dev)
        vec = _dd_pair(gen, (T,), dev)
        yt = m(lambda t: t.T, _dd_pair(gen, (T, B), dev))
        for label, args in (("lottery", (vals, x, y, rank, mask, K.MASK_X)),
                            ("col", (vals, x, m(lambda t: t.expand(B, T), vec), rank, mask,
                                     K.MASK_Y)),
                            ("row", (vals, m(lambda t: t.expand(B, T), vec), yt, rank, mask,
                                     K.MASK_X))):
            out.append((label, (lambda a=args: K.dd_score_residual_argmax(*a)),
                        (lambda a=args: K.dd_score_residual_argmax_plain(*a))))
    elif name == "dd_dot":
        M, N, T = shape
        a, b = _dd_pair(gen, (M, T), dev), _dd_pair(gen, (T, N), dev)
        x, y = m(lambda t: t[:, None, :].expand(M, N, T), a), m(lambda t: t.T[None].expand(M, N, T), b)
        g, w = _dd_pair(gen, (M, T, N), dev), _dd_pair(gen, (T,), dev)
        xg, yw = m(lambda t: t.permute(0, 2, 1), g), m(lambda t: t[None, None].expand(M, N, T), w)
        for label, args in (("gemm", (x, y)), ("core_weights", (xg, yw))):
            out.append((label, (lambda a=args: K.dd_dot(*a)), (lambda a=args: K.dd_dot_plain(*a))))
    elif name == "dd_gather_tt_fused":
        from ttcross_tpu_torch.tt.types import TT

        B, N, ranks = shape[0], shape[1], shape[2:]
        d = len(ranks) - 1
        t = TT(tuple(torch.randn((ranks[c], N, ranks[c + 1]), generator=gen,
                                 dtype=torch.float64).to(dev) for c in range(d)))
        packed = K.pack_tt(t)
        ind = torch.randint(0, N, (B, d), generator=gen, dtype=torch.int32).to(dev)
        out.append(("train", (lambda: K.dd_gather_tt_fused(packed, ind)),
                    (lambda: K.dd_gather_tt_plain(packed, ind))))
    else:
        from ttcross_tpu_torch.apps import make_ising_dd

        B, d, n = shape
        tables = make_ising_dd(m=d + 1, n=n - 1 if n % 2 == 0 else n, device=dev)[1].tables
        ind = torch.randint(0, n, (B, d), generator=gen, dtype=torch.int32).to(dev)
        out.append(("rows", (lambda: K.ising_c_integrand_dd_fused(tables, ind)),
                    (lambda: K.ising_c_integrand_dd_plain(tables, ind))))
    return out


def hold_dd_shapes(dev, gen, shapes, held, checked) -> None:
    """Phase 15's kernel check: every dd kernel at every shape a dd run
    launched it at, in each layout the engine gives it there (_dd_cases),
    bit for bit against its plain version on the card (hi, lo, and D1's
    index and r at it), max_abs_err the largest |kernel - plain| over
    them; the first layout's device time, kernels per call
    (one is the design), bound, share, CUDA-event time of kernel and plain,
    and host time per call.  The rows join `checked` and `held`."""
    import torch

    from ttcross_tpu_torch.ops.dd import DD

    def parts(r):
        if isinstance(r, DD):
            return [r.hi, r.lo]
        return [p for x in r for p in (parts(x) if isinstance(x, (tuple, DD)) else [x])]

    for name in DD_KERNELS:
        for shape in sorted(set(shapes.get(name, {})) - held[name]):
            cases = _dd_cases(dev, gen, name, shape)
            err = 0.0
            for label, fn, plain in cases:
                got, want = parts(fn()), parts(plain())
                torch.cuda.synchronize()
                if not all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(got, want)):
                    raise AssertionError(f"{name} {shape} ({label}): not bit-equal to its plain "
                                         "version")
                err = max([err] + [float((a.double() - b.double()).abs().max())
                                   for a, b in zip(got, want)])
            _, fn, plain = cases[0]
            dev_k = device_per_call(fn)
            if not 0 < dev_k["kernels_per_call"] <= 1:
                raise AssertionError(f"{name} {shape}: {dev_k['kernels_per_call']} kernels per "
                                     "call (one is the design)")
            # the plain versions launch ~35 ops per dd multiply-add: fewer calls
            dev_p = device_per_call(plain, calls=5)
            bound, by = _dd_bound(name, shape)
            row = {"kernel": name, "shape": list(shape), "layouts": [c[0] for c in cases],
                   "max_abs_err": err, "ms": _time_ms(fn), "plain_ms": _time_ms(plain, reps=5),
                   "library_ms": None, "device_us": dev_k["device_us"],
                   "kernels_per_call": dev_k["kernels_per_call"],
                   "plain_device_us": dev_p["device_us"],
                   "plain_kernels_per_call": dev_p["kernels_per_call"],
                   "bound_us": bound, "bound_by": by,
                   "share_of_bound": bound / dev_k["device_us"],
                   "host_us_per_call": host_us_per_call(fn, calls=200)}
            _emit(row)
            checked[name][tuple(shape)] = row
            held[name].add(tuple(shape))


def _dd_digits(value, truth: str) -> float:
    from decimal import Decimal, localcontext

    with localcontext() as ctx:
        ctx.prec = 60
        rel = abs(1 - (Decimal(value[0]) + Decimal(value[1])) / Decimal(truth))
        return float(-rel.log10()) if rel != 0 else 60.0


def run_dd(dev, name, key=0):
    """One run of DD_RUNS[name] on `dev`: (result or (hi, lo, info), wall,
    digits, launches, by shape, summary row)."""
    from decimal import Decimal

    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import ISING_C_STR, TPI_STR, make_ising_dd, make_stdnorm_dd
    from ttcross_tpu_torch.cross import cross_dd, cross_defect_corrected
    from ttcross_tpu_torch.ops import kernels as K

    problem, m, n, kind, ranks, _ = DD_RUNS[name]
    if problem == "ising":
        prob, fun_dd, wh, wl = make_ising_dd(m=m, n=n, device=dev)
        truth = ISING_C_STR[m]
    else:
        prob, fun_dd, wh, wl = make_stdnorm_dd(d=m, n=n, device=dev)
        truth = str((Decimal(TPI_STR) / 2) ** (m // 2))
    nn = [prob.n] * prob.d
    K.reset_launch_counts()
    t0 = time.perf_counter()
    if kind == "dd":
        res = cross_dd(fun_dd, nn, wh, wl, max_rank=ranks[0], pivoting=1, key=key, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        value, row = res.value, {"n_evals": res.neval, "sweeps": res.sweeps,
                                 "ranks": list(res.ranks)}
        if not (all(np.isfinite(c).all() for c in res.cores_hi) and max(res.ranks) <= ranks[0]):
            raise AssertionError(f"dd {name}: malformed result, ranks {res.ranks}")
    else:
        acc = 5 * 2.2e-16 if problem == "stdnorm" else 1e-13
        res = cross_defect_corrected(prob.fun, fun_dd, nn, wh, wl, max_rank=ranks[0],
                                     max_rank2=ranks[1], accuracy=acc, pivoting=1, key=key,
                                     device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        value, info = res[:2], res[2]
        row = {"n_evals": info["nevals"], "ranks": [list(r) for r in info["ranks"]],
               "q1": list(info["q1"]), "q2": list(info["q2"])}
    if not all(math.isfinite(v) for v in value):
        raise AssertionError(f"dd {name}: value {value}")
    digits = _dd_digits(value, truth)
    evals = sum(row["n_evals"]) if isinstance(row["n_evals"], list) else row["n_evals"]
    row.update(value=list(value), digits=digits, wall_s=wall, evals_per_s=evals / wall)
    return res, wall, digits, K.launch_counts(), K.launch_shapes(), row


def check_small_dd_against_cpu(dev) -> dict:
    """cross_dd at C_4, n = 17, rank 8 on the card and on the CPU with the
    same key: the same draws, eager dd operations rounded once and kernels
    equal to their plain versions bit for bit, so the values, the pivots
    (vip), the ranks, the evaluations and the dd cores are equal."""
    import numpy as np

    from ttcross_tpu_torch.apps import make_ising_dd
    from ttcross_tpu_torch.cross import cross_dd

    out = {}
    for where in (dev, "cpu"):
        prob, fun_dd, wh, wl = make_ising_dd(m=4, n=17, device=where)
        out[str(where)] = cross_dd(fun_dd, [prob.n] * prob.d, wh, wl, max_rank=8, pivoting=1,
                                   key=0, device=where)
    card, cpu = out[str(dev)], out["cpu"]
    same = (card.value == cpu.value and card.ranks == cpu.ranks and card.neval == cpu.neval
            and np.array_equal(card.vip, cpu.vip)
            and all(np.array_equal(a, b) for a, b in zip(card.cores_hi + card.cores_lo,
                                                         cpu.cores_hi + cpu.cores_lo)))
    row = {"phase": "dd_small_vs_cpu", "config": "cross_dd C_4 n=17 rank 8 key 0",
           "card": list(card.value), "cpu": list(cpu.value), "ranks": list(card.ranks),
           "n_evals": card.neval, "bit_equal": same}
    if not same:
        raise AssertionError(f"the card's cross_dd differs from the CPU's: {row}")
    return row


def dd_sweeps_without_sync(dev) -> dict:
    """Two cross_dd sweeps of ising_c4_dd_tier's problem (C_4, n = 33, rank
    16) and a call of the defect's integrand (D2 + D3 + dd operations),
    with torch's sync debug mode set to raise: nothing inside a sweep
    waits for the card (the stop rule's read between sweeps does)."""
    import torch

    from ttcross_tpu_torch.apps import make_ising_dd
    from ttcross_tpu_torch.cross.defect import _Defect
    from ttcross_tpu_torch.cross.engine_dd import DDConfig, get_dd_engine, key_draws
    from ttcross_tpu_torch.tt.types import TT

    prob, fun_dd, _, _ = make_ising_dd(m=4, n=33, device=dev)
    d, N, R = prob.d, prob.n, 16
    kit = get_dd_engine(fun_dd, DDConfig(d=d, n=(N,) * d, N=N, R=R, piv=1, small_element=1e-30,
                                         small_pivot=1e-12), dev)
    draw_of = key_draws(0, 2, d, 2 * (R + N), dev)
    st = kit.init_fn()
    gen = torch.Generator().manual_seed(5)
    train = TT(tuple(torch.randn((r1, N, r2), generator=gen, dtype=torch.float64).to(dev)
                     for r1, r2 in ((1, 8), (8, 8), (8, 1))))
    defect = _Defect(fun_dd, [train])
    ind = torch.randint(0, N, (528, d), generator=gen, dtype=torch.int32).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for it in (1, 2):
            st = kit.sweep_fn(st, it, draw_of(it))
        defect(ind)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return {"phase": "dd_sync_free", "config": "cross_dd C_4 n=33 rank 16, sweeps 1-2; the "
            "defect integrand at (528, 3)", "sync_free_sweeps": 2, "ranks": st.rk.tolist()}


def stdnorm_dd_launches(dev, d, n, rank) -> int:
    """Kernels on the card per call of make_stdnorm_dd's fun_dd (plain dd
    operations) at the defect's rook-fiber batch (n rank, d)."""
    import torch

    from ttcross_tpu_torch.apps import make_stdnorm_dd

    fun_dd = make_stdnorm_dd(d=d, n=n, device=dev)[1]
    ind = torch.randint(0, n, (n * rank, d), dtype=torch.int32).to(dev)
    fun_dd(ind)
    return device_launches(lambda: fun_dd(ind))


def check_dd(dev, gen, held, checked):
    """Phase 15: the dd tier.  Each DD_RUNS configuration over its keys on
    the card, each key held to DD_FLOORS; ising_c4_dd_tier's key 0 twice
    (first and steady wall, the same path); the small card-vs-CPU run; every
    dd kernel held at every shape the runs launched it at (hold_dd_shapes),
    the f64 kernels of the defect's crosses at theirs (hold_new_shapes).
    Returns [(path label, launches by shape, the kernels the path must
    launch)] of each configuration's first run."""
    paths = []
    for name, (problem, m, n, kind, ranks, keys) in DD_RUNS.items():
        first = run_dd(dev, name)
        runs = [first] + [run_dd(dev, name, key=k) for k in keys[1:]]
        row = {"phase": "dd", "config": name, **first[5], "launches": first[3],
               "launches_by_shape": _by_shape(first[4]),
               "digits_by_key": [r[2] for r in runs], "floor": DD_FLOORS[name]}
        if problem == "stdnorm":     # its dd integrand is plain dd operations, no hand kernel
            row["fun_dd_launches_per_call"] = stdnorm_dd_launches(dev, m, n, ranks[0])
        if name == "ising_c4_dd_tier":
            steady = run_dd(dev, name)
            row["steady_s"] = steady[1]
            if (steady[0].neval, steady[0].ranks, steady[0].value) != (
                    first[0].neval, first[0].ranks, first[0].value):
                raise AssertionError("the repeated ising_c4_dd_tier run took another path")
        _emit(row)
        if min(row["digits_by_key"]) < DD_FLOORS[name]:
            raise AssertionError(f"dd {name}: digits {row['digits_by_key']} < "
                                 f"{DD_FLOORS[name]}")
        need = DD_PATH_KERNELS["defect_stdnorm" if problem == "stdnorm" else kind]
        if min(first[3][k] for k in need) <= 0:
            raise AssertionError(f"dd {name}: a kernel of its path never launched: {first[3]}")
        for r in runs:
            hold_dd_shapes(dev, gen, r[4], held, checked)
            hold_new_shapes(dev, gen, r[4], held, checked, label=f"dd_{name}")
            _require_held(f"dd {name}", r[4], held)
        paths.append((f"dd {name}", first[4], need))
    _emit(check_small_dd_against_cpu(dev))
    _emit(dd_sweeps_without_sync(dev))
    return paths


# ------------------------------------------------------------ phase 16: the distributed engines
# The distributed engines (ttcross_tpu_torch/parallel/) run one process per
# rank; this phase spawns its ranks itself (parallel/launch.py::spawn_ranks:
# the spawn start method, a file store in a temporary directory, a time
# limit per rank, any rank's failure failing the phase).  NCCL refuses two
# ranks on one card, so the multi-rank runs use gloo with both ranks on
# cuda:0.  bench.py's parallel line (bench.py:861-863) and the long chain:
PAR_C32 = dict(m=32, n=16, max_rank=8, accuracy=500 * 2.2e-16, pivoting=1)
PAR_RUNS = {   # name: (m, n, max_rank, sweep_mode, chain)
    "C_32 sequential": (32, 16, 8, "sequential", False),
    "C_32 jacobi-rb": (32, 16, 8, "jacobi-rb", False),
    "C_256 jacobi-rb + chain": (256, 17, 10, "jacobi-rb", True),
}
PAR_KEYS = range(4)
# Digits of each configuration on two ranks of the CPU over keys 0-3, port /
# JAX package (each rank draws its own stream: the port's rank_key, JAX's
# fold_in; PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_parallel.py
# prints them), as minimum, median, maximum:
#   C_32 sequential          9.24 9.49 9.85 / 9.07 9.50 10.24
#   C_32 jacobi-rb           9.47 9.71 10.87 / 8.02 8.47 9.78
#   C_256 jacobi-rb + chain  11.30 11.49 12.06 / 10.39 10.57 10.65
# Every key on the card is held under both packages' minima.
PAR_FLOORS = {"C_32 sequential": 8.5, "C_32 jacobi-rb": 7.5, "C_256 jacobi-rb + chain": 10.0}
PAR_ONE_RTOL = 1e-15        # one rank's values against cross() fed the same uniforms
PAR_CPU_RTOL = 1e-13        # two ranks on the card against two ranks on the CPU
PAR_DD_KEYS = range(4)      # cross_dd_parallel on ising_c4_dd_tier, held to DD_FLOORS
PAR_TIMEOUT = 400           # seconds per spawned group
PAR_PATH_KERNELS = {"sequential": MAIN_PATH_KERNELS, "jacobi-rb": ("score_residual_argmax_batched",
                                                                    "ising_integrand_fused"),
                    "chain": LONG_CHAIN_KERNELS}


def _par_cross(fun, n, **kw):
    """cross_parallel through its public entry point, with the final pivots
    (vip, host numpy) read where the run finalizes its train."""
    import ttcross_tpu_torch.parallel.engine as E

    seen, orig = {}, E.finalize

    def finalize(st, kit):
        seen["vip"] = st.vip.cpu().numpy()
        return orig(st, kit)

    E.finalize = finalize
    try:
        return E.cross_parallel(fun, n, **kw), seen["vip"]
    finally:
        E.finalize = orig


def _par_row(res, vip, wall, counts, shapes) -> dict:
    import numpy as np

    return {"values": [float(v) for v in res.values], "ranks": list(res.ranks),
            "n_evals": res.neval, "padded_evals": res.padded_evals, "sweeps": res.sweeps,
            "vip": vip.tolist(), "digits": float(-np.log10(res.errors[-1])), "wall_s": wall,
            "launches": counts, "shapes": shapes, "tt_on": str(res.tt.device)}


def _par_run(name, key, device, uniforms=None) -> dict:
    """One cross_parallel run of PAR_RUNS[name] on this rank, its launches
    counted from 0."""
    import torch

    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.ops import kernels as K
    from ttcross_tpu_torch.parallel import bond_mesh

    m, n, R, mode, chain = PAR_RUNS[name]
    mesh = bond_mesh(device=device)
    p = make_ising("C", m, n, device=mesh.device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res, vip = _par_cross(p.fun, [p.n] * p.d, max_rank=R, accuracy=PAR_C32["accuracy"],
                          pivoting=1, quad=[p.quad_weights] * p.d, truth=p.truth, key=key,
                          sweep_mode=mode, chain=p.chain if chain else None, mesh=mesh,
                          uniforms=uniforms)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    return _par_row(res, vip, time.perf_counter() - t0, K.launch_counts(), K.launch_shapes())


def _par_profiled(name, device) -> dict:
    """One more steady run of PAR_RUNS[name] on this rank under
    torch.profiler: its wall, this rank's kernel time on the card and
    launches, per sweep."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        row = _par_run(name, 0, device)
    kernels = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    return {"wall_s": row["wall_s"], "device_busy_s": busy_us * 1e-6, "launches": launches,
            "sweeps": row["sweeps"], "launches_per_sweep": launches / row["sweeps"]}


def _par_one_rank(device=None):
    """Phase 16.1, on one rank (NCCL on the card): each configuration's
    cross_parallel (first and steady call) and cross() fed the same
    uniforms."""
    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross.engine import _cross
    from ttcross_tpu_torch.parallel import bond_mesh
    from ttcross_tpu_torch.parallel.engine import rank_uniforms

    mesh = bond_mesh(device=device)
    out = {"backend": mesh.backend, "device": str(mesh.device)}
    for name in ("C_32 sequential", "C_256 jacobi-rb + chain"):
        m, n, R, mode, chain = PAR_RUNS[name]
        p = make_ising("C", m, n, device=mesh.device)
        U = rank_uniforms(0, 0, R - 1, p.d - 1, 2 * (R + p.n))
        first = _par_run(name, 0, device, U)
        steady = _par_run(name, 0, device, U)
        t0 = time.perf_counter()
        ref = _cross(p.fun, [p.n] * p.d, max_rank=R, accuracy=PAR_C32["accuracy"], pivoting=1,
                     quad=[p.quad_weights] * p.d, truth=p.truth, key=0, dtype=torch.float64,
                     verbose=False, return_state=False, return_pivots=True, max_sweeps=None,
                     small_element=None, small_pivot=None, oversample=0, sweep_mode=mode,
                     device=mesh.device, chain=p.chain if chain else None, uniforms=U)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        out[name] = {"first": first, "steady_s": steady["wall_s"],
                     "cross_s": time.perf_counter() - t0,
                     "cross": {"values": list(map(float, ref.values)), "ranks": list(ref.ranks),
                               "n_evals": ref.neval, "vip": ref.state.vip.tolist()},
                     "max_rel": float(np.max(np.abs(np.subtract(first["values"], ref.values))
                                             / np.abs(ref.values)))}
    if mesh.device.type == "cuda":
        out["profile"] = {name: _par_profiled(name, device) for name in PAR_RUNS}
    return out


def _par_two_ranks(device, keys):
    """Phase 16.2, on one of two gloo ranks: every PAR_RUNS configuration
    over `keys` on `device`."""
    out = {name: [_par_run(name, key, device) for key in keys] for name in PAR_RUNS}
    if device != "cpu":
        out["profile"] = {name: _par_profiled(name, device) for name in PAR_RUNS}
    return out


def _par_surface(device):
    """Phases 16.3-16.5, on one of two gloo ranks on `device`: cross_dd_parallel
    on ising_c4_dd_tier over PAR_DD_KEYS; pcontract of the chf driver's
    32-weight family; accchk(mesh=) and cross_batch(mesh=) on the 4-lane
    mvn_d6 family (2 lanes per rank)."""
    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import ISING_C_STR, make_ising_dd, make_mvn, make_mvn_family
    from ttcross_tpu_torch.cross import accchk, cross, cross_batch
    from ttcross_tpu_torch.ops import kernels as K
    from ttcross_tpu_torch.parallel import bond_mesh, cross_dd_parallel, pcontract
    from ttcross_tpu_torch.tt.ops import contract

    mesh = bond_mesh(device=device)
    dev = mesh.device
    out = {"dd": []}
    prob, fun_dd, wh, wl = make_ising_dd(m=4, n=33, device=dev)
    for key in PAR_DD_KEYS:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        r = cross_dd_parallel(fun_dd, [prob.n] * prob.d, wh, wl, max_rank=16, pivoting=1,
                              key=key, mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["dd"].append({"key": key, "value": list(r.value), "digits": _dd_digits(r.value,
                                                                                   ISING_C_STR[4]),
                          "ranks": list(r.ranks), "n_evals": r.neval, "sweeps": r.sweeps,
                          "wall_s": time.perf_counter() - t0, "launches": K.launch_counts(),
                          "shapes": K.launch_shapes()})
    # the chf driver's family (drivers/crs_chf.py:39-51): 32 Fourier weight
    # sets of the rank-6 MVN pdf train at d = 4, n = 17
    p = make_mvn(d=4, n=17, device=dev)
    t = cross(p.fun, [p.n] * 4, max_rank=6, accuracy=500 * 2.2e-16, pivoting=1, device=dev).tt
    omega = np.arange(32) * np.pi / 300.0
    w_k = p.quad_weights[None, :] * np.exp(1j * omega[:, None] * np.exp(p.nodes)[None, :] / 4)
    got = pcontract(t, [w_k] * 4, mesh)
    want = np.array([complex(contract(t, [w_k[k]] * 4)) for k in range(32)])
    out["pcontract"] = {"max_rel": float(np.max(np.abs(got - want) / np.abs(want))),
                        "shape": list(np.shape(got))}
    fam = make_mvn_family(d=MVN["d"], n=MVN["n"], corrs=np.linspace(0.2, 0.6, FAMILY_LANES),
                          device=dev)
    kw = dict(max_rank=MVN["max_rank"], accuracy=MVN["accuracy"], pivoting=MVN["pivoting"],
              quad=[fam.quad_weights] * fam.d, truth=1.0)
    K.reset_launch_counts()
    res = cross_batch(fam.fun, [fam.n] * fam.d, fam.params, mesh=mesh, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["batch"] = [{"ranks": list(r.ranks), "n_evals": r.neval, "sweeps": r.sweeps,
                     "values": list(map(float, r.values)), "vip": r.state.vip.tolist()}
                    for r in res]
    out["batch_shapes"] = K.launch_shapes()
    lane0 = (lambda par: lambda ind: fam.fun(ind, par))(fam.lane(0))
    out["accchk"] = accchk(res[0].tt, lane0, nlot=2**14, key=3, mesh=mesh)
    return out


def _held_everywhere(dev, gen, held, checked, label, shapes) -> None:
    hold_new_shapes(dev, gen, shapes, held, checked, label=label)
    hold_dd_shapes(dev, gen, shapes, held, checked)
    hold_qd_shapes(dev, gen, shapes, held, checked)
    _require_held(label, shapes, held)


def check_parallel(dev, gen, held, checked):
    """Phase 16: the distributed engines (ttcross_tpu_torch/parallel/).
      1. one NCCL rank: cross_parallel of bench.py's parallel line (C_32,
         sequential) and of the long chain (C_256 jacobi-rb + chain) equals
         cross() fed the same uniforms (ranks, vip, n_evals; values to
         PAR_ONE_RTOL);
      2. two gloo ranks on the card: C_32 sequential and jacobi-rb and C_256
         jacobi-rb + chain over PAR_KEYS, both ranks the same result, every
         key above its floor, key 0 equal to the same two ranks on the CPU
         (ranks, n_evals, sweeps; values to PAR_CPU_RTOL; and vip at C_32:
         the long chain's late pivots are f64-noise near-ties that the
         card's kernel sums and the CPU's break apart, as the one-device
         C_256 cross's do, reported beside it);
      3-5. two gloo ranks on the card: cross_dd_parallel on
         ising_c4_dd_tier against DD_FLOORS, pcontract of the chf family
         against tt.contract, accchk(mesh=) against the one-device accchk
         and cross_batch(mesh=) lanes against the one-process family;
      6. cross_batch(sweep_mode="jacobi") of the family at full width (d = 6,
         n = 65, rank 20): each lane equal to its single cross(sweep_mode=
         "jacobi").
    Every kernel launched at a shape held against its plain version.
    Returns [(path label, launches by shape, the kernels it must launch)]."""
    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import make_mvn_family
    from ttcross_tpu_torch.cross import accchk, cross, cross_batch, lane_key
    from ttcross_tpu_torch.ops import kernels as K
    from ttcross_tpu_torch.parallel import spawn_ranks

    paths = []
    t0 = time.perf_counter()
    one = spawn_ranks(_par_one_rank, 1, backend="nccl", timeout=PAR_TIMEOUT, threads=0)[0]
    spawn_one_s = time.perf_counter() - t0
    for name in ("C_32 sequential", "C_256 jacobi-rb + chain"):
        r = one[name]
        first, ref = r["first"], r["cross"]
        same = (first["ranks"] == ref["ranks"] and first["n_evals"] == ref["n_evals"]
                and first["vip"] == ref["vip"])
        _emit({"phase": "parallel_one_rank", "config": name, "backend": one["backend"],
               "device": one["device"], "digits": first["digits"], "n_evals": first["n_evals"],
               "sweeps": first["sweeps"], "first_s": first["wall_s"], "steady_s": r["steady_s"],
               "cross_s": r["cross_s"], "equals_cross": same, "max_rel_value_diff": r["max_rel"],
               "launches": first["launches"], "launches_by_shape": _by_shape(first["shapes"])})
        if one["backend"] != "nccl" or not first["tt_on"].startswith("cuda"):
            raise AssertionError(f"parallel one rank: {one['backend']} on {first['tt_on']}")
        if not same or r["max_rel"] > PAR_ONE_RTOL:
            raise AssertionError(f"{name}: one rank differs from cross() with its uniforms")
        mode = "chain" if "chain" in name else "sequential"
        _held_everywhere(dev, gen, held, checked, f"parallel 1 rank {name}", first["shapes"])
        paths.append((f"parallel 1 rank {name}", first["shapes"], PAR_PATH_KERNELS[mode]))

    t0 = time.perf_counter()
    card = spawn_ranks(_par_two_ranks, 2, args=("cuda:0", list(PAR_KEYS)), timeout=PAR_TIMEOUT)
    spawn_two_s = time.perf_counter() - t0
    cpu = spawn_ranks(_par_two_ranks, 2, args=("cpu", [0]), timeout=PAR_TIMEOUT, threads=4)
    for name in PAR_RUNS:
        # walls, launches per sweep and the card's busy share: one rank, and
        # two ranks sharing the card (their kernel time summed over the
        # longer wall)
        p1, p2 = one["profile"][name], [card[r]["profile"][name] for r in (0, 1)]
        wall2 = max(p["wall_s"] for p in p2)
        _emit({"phase": "parallel_profile", "config": name,
               "one_rank": {**p1, "device_busy_share": p1["device_busy_s"] / p1["wall_s"]},
               "two_ranks": {"wall_s": wall2, "per_rank": p2, "device_busy_share":
                             sum(p["device_busy_s"] for p in p2) / wall2}})
    for name, (m, n, R, mode, chain) in PAR_RUNS.items():
        runs0, runs1 = card[0][name], card[1][name]
        ref = cpu[0][name][0]
        both = all(a["values"] == b["values"] and a["vip"] == b["vip"]
                   and a["n_evals"] == b["n_evals"] for a, b in zip(runs0, runs1))
        k0 = runs0[0]
        same_cpu = (k0["ranks"] == ref["ranks"] and k0["n_evals"] == ref["n_evals"]
                    and k0["sweeps"] == ref["sweeps"])
        vip_diff = np.argwhere(np.asarray(k0["vip"]) != np.asarray(ref["vip"]))[:, :2]
        rel = float(np.max(np.abs(np.subtract(k0["values"], ref["values"]))
                           / np.abs(ref["values"])))
        by_key = [r["digits"] for r in runs0]
        shapes = _merge_shapes([runs0[0]["shapes"], runs1[0]["shapes"]])
        _emit({"phase": "parallel_two_ranks", "config": name, "backend": "gloo, both on cuda:0",
               "digits_by_key": by_key, "floor": PAR_FLOORS[name], "n_evals": k0["n_evals"],
               "sweeps": k0["sweeps"], "walls_s": [r["wall_s"] for r in runs0],
               "cpu_wall_s": ref["wall_s"], "ranks_agree": both, "equals_cpu": same_cpu,
               "vip_equal_cpu": len(vip_diff) == 0,
               "vip_differs_at_cpu": sorted({tuple(map(int, x)) for x in vip_diff}),
               "max_rel_value_diff_cpu": rel, "launches": _merge_counts(
                   [runs0[0]["launches"], runs1[0]["launches"]]),
               "launches_by_shape": _by_shape(shapes)})
        if not both:
            raise AssertionError(f"{name}: the two ranks returned different results")
        if not same_cpu or rel > PAR_CPU_RTOL or (len(vip_diff) and name != "C_256 jacobi-rb + chain"):
            raise AssertionError(f"{name}: two ranks on the card differ from two on the CPU")
        if min(by_key) < PAR_FLOORS[name]:
            raise AssertionError(f"{name}: digits {by_key} < {PAR_FLOORS[name]}")
        for r in runs0[1:] + runs1[1:]:
            _held_everywhere(dev, gen, held, checked, f"parallel 2 ranks {name}", r["shapes"])
        _held_everywhere(dev, gen, held, checked, f"parallel 2 ranks {name}", shapes)
        need = PAR_PATH_KERNELS["chain" if chain else mode]
        paths.append((f"parallel 2 ranks {name}", shapes, need))

    _emit(_long_chain_card_vs_cpu())
    surf = spawn_ranks(_par_surface, 2, args=("cuda:0",), timeout=PAR_TIMEOUT)
    s0, s1 = surf
    dd_digits = [r["digits"] for r in s0["dd"]]
    dd_shapes = _merge_shapes([s0["dd"][0]["shapes"], s1["dd"][0]["shapes"]])
    _emit({"phase": "parallel_dd", "config": "cross_dd_parallel ising_c4_dd_tier (C_4 n=33 "
           "rank 16), 2 gloo ranks on cuda:0", "digits_by_key": dd_digits,
           "floor": DD_FLOORS["ising_c4_dd_tier"], "n_evals": s0["dd"][0]["n_evals"],
           "ranks": s0["dd"][0]["ranks"], "walls_s": [r["wall_s"] for r in s0["dd"]],
           "ranks_agree": [r["value"] for r in s0["dd"]] == [r["value"] for r in s1["dd"]],
           "launches_by_shape": _by_shape(dd_shapes)})
    if min(dd_digits) < DD_FLOORS["ising_c4_dd_tier"] or \
            [r["value"] for r in s0["dd"]] != [r["value"] for r in s1["dd"]]:
        raise AssertionError(f"cross_dd_parallel: digits {dd_digits} or the ranks disagree")
    for r in s0["dd"][1:] + s1["dd"][1:]:
        _held_everywhere(dev, gen, held, checked, "parallel dd", r["shapes"])
    _held_everywhere(dev, gen, held, checked, "parallel dd", dd_shapes)
    paths.append(("parallel 2 ranks cross_dd ising_c4_dd_tier", dd_shapes, DD_PATH_KERNELS["dd"]))
    _emit({"phase": "parallel_pcontract", "config": "the chf family: 32 weight sets of the "
           "rank-6 MVN pdf at d=4, n=17, 2 gloo ranks", **s0["pcontract"]})
    if s0["pcontract"]["max_rel"] > 1e-12 or s0["pcontract"] != s1["pcontract"]:
        raise AssertionError(f"pcontract: {s0['pcontract']} / {s1['pcontract']}")

    fam = make_mvn_family(d=MVN["d"], n=MVN["n"], corrs=np.linspace(0.2, 0.6, FAMILY_LANES),
                          device=dev)
    kw = dict(max_rank=MVN["max_rank"], accuracy=MVN["accuracy"], pivoting=MVN["pivoting"],
              quad=[fam.quad_weights] * fam.d, truth=1.0, device=dev)
    ref = cross_batch(fam.fun, [fam.n] * fam.d, fam.params, **kw)
    lane0 = (lambda par: lambda ind: fam.fun(ind, par))(fam.lane(0))
    acc_ref = accchk(ref[0].tt, lane0, nlot=2**14, key=3, device=dev)
    lanes_same = all(got["ranks"] == list(want.ranks) and got["n_evals"] == want.neval
                     and got["vip"] == want.state.vip.tolist() and got["values"] == want.values
                     for s in surf for got, want in zip(s["batch"], ref))
    acc_same = (s0["accchk"] == s1["accchk"] and all(
        s0["accchk"][k] == acc_ref[k] for k in ("einf", "ainf", "worst_index"))
        and all(abs(s0["accchk"][k] - acc_ref[k]) <= 1e-12 * acc_ref[k] for k in ("efro", "afro")))
    batch_shapes = _merge_shapes([s0["batch_shapes"], s1["batch_shapes"]])
    _emit({"phase": "parallel_family", "config": "cross_batch(mesh=) of the 4-lane mvn_d6 "
           "family, 2 lanes per gloo rank; accchk(mesh=) 2^14 samples of lane 0",
           "lanes_equal_one_process": lanes_same, "accchk": s0["accchk"],
           "accchk_one_device": acc_ref, "accchk_equal": acc_same,
           "launches_by_shape": _by_shape(batch_shapes)})
    if not (lanes_same and acc_same):
        raise AssertionError("cross_batch(mesh=) or accchk(mesh=) differs from one process")
    _held_everywhere(dev, gen, held, checked, "parallel family", batch_shapes)
    paths.append(("parallel 2 ranks mvn_d6 family", batch_shapes, FAMILY_KERNELS))

    # 6. the lane-batched all-bonds sweep, in this process
    K.reset_launch_counts()
    t0 = time.perf_counter()
    jac = cross_batch(fam.fun, [fam.n] * fam.d, fam.params, sweep_mode="jacobi", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shapes = K.launch_shapes()
    rows = []
    for lane in range(FAMILY_LANES):
        fun = (lambda par: lambda ind: fam.fun(ind, par))(fam.lane(lane))
        s = cross(fun, [fam.n] * fam.d, key=lane_key(0, lane), return_pivots=True,
                  sweep_mode="jacobi", **kw)
        r = jac[lane]
        rows.append({"lane": lane, "digits": float(-np.log10(r.errors[-1])), "n_evals": r.neval,
                     "sweeps": r.sweeps, "equals_single_run": bool(
                         r.ranks == s.ranks and r.neval == s.neval and r.sweeps == s.sweeps
                         and np.array_equal(r.state.vip, s.state.vip)),
                     "max_rel_value_diff": float(np.max(np.abs(np.subtract(r.values, s.values))
                                                        / np.abs(s.values)))})
    _emit({"phase": "family_jacobi", "config": "cross_batch(sweep_mode='jacobi') of the 4-lane "
           "mvn_d6 family (n=65, rank 20)", "wall_s": wall, "n_evals": jac.neval,
           "lanes": rows, "launches": K.launch_counts(), "launches_by_shape": _by_shape(shapes),
           "spawn_one_rank_s": spawn_one_s, "spawn_two_ranks_s": spawn_two_s})
    bad = [r for r in rows if not r["equals_single_run"] or r["max_rel_value_diff"] > FAMILY_RTOL]
    if bad:
        raise AssertionError(f"jacobi family lanes differ from their single runs: {bad}")
    _held_everywhere(dev, gen, held, checked, "family jacobi", shapes)
    paths.append(("mvn_d6 family jacobi", shapes, FAMILY_KERNELS))
    return paths


def _long_chain_card_vs_cpu() -> dict:
    """The one-device C_256 jacobi-rb + chain cross of key 0 on the card and
    on the CPU (the same draws): where their pivots part."""
    import numpy as np

    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross

    m, n, R, mode, _ = PAR_RUNS["C_256 jacobi-rb + chain"]
    out = {}
    for where in ("cuda", "cpu"):
        p = make_ising("C", m, n, device=where)
        out[where] = cross(p.fun, [p.n] * p.d, max_rank=R, accuracy=PAR_C32["accuracy"],
                           pivoting=1, quad=[p.quad_weights] * p.d, truth=p.truth,
                           sweep_mode=mode, chain=p.chain, return_pivots=True, device=where)
    g, c = out["cuda"], out["cpu"]
    diff = np.argwhere(g.state.vip != c.state.vip)[:, :2]
    return {"phase": "long_chain_card_vs_cpu", "config": "C_256 jacobi-rb + chain key 0, one device",
            "ranks_equal": g.ranks == c.ranks, "n_evals": [g.neval, c.neval],
            "vip_differs_at": sorted({tuple(map(int, x)) for x in diff}),
            "max_rel_value_diff": float(np.max(np.abs(np.subtract(g.values, c.values))
                                               / np.abs(c.values)))}


def _merge_counts(runs) -> dict:
    out = {}
    for counts in runs:
        for k, v in counts.items():
            out[k] = out.get(k, 0) + v
    return out


# ------------------------------------------------------------ phase 17: the qd tier
# The quad-double tier (csrc/qd_kernels.cu's Q1-Q4; ROADMAP item 8's qd part).
# The JAX package runs it on the host in numpy (a TPU's emulated f64 breaks
# Dekker's two_prod); the port runs it on the card.  Digits against Bailey's
# C_4 (ISING_C_STR[4]) or pi^2, in decimal.  The floors stand on CPU runs of
# both packages at the same configurations, seed / key 0 (port / JAX package,
# digits, n_evals, wall on one core of the CPU host):
#   cross_qd C_4 n=65 rank 55            64.2097 / 64.2097 (the same limbs),
#                                        221,467 evals, 54 sweeps; 74.2 s / 55.9 s
#   stdnorm_d4_qd_engine                 62.3185 / 62.3185, 9,666 evals
#   defect C_4 n=33 ranks 16 / 33, 3 lv  33.6912 / 33.6912 (level-1 ranks
#                                        (1, 15, 14, 1) / (1, 15, 15, 1): the
#                                        f64 lotteries differ); 312 s / 232 s
#   cross_qd_parallel C_4 n=65 rank 33,  37.3395 / 37.3395 (the same limbs),
#   2 workers                            87,115 evals, 32 sweeps; 19.2 s / 14.7 s
QD_C4 = dict(m=4, n=65, max_rank=55)          # BENCH_NOTES.md:281, the 64.2-digit record
QD_C4_FLOOR = 64.0
QD_STDNORM = dict(d=4, n=201, max_rank=4)     # bench.py:550-568, stdnorm_d4_qd_engine
QD_STDNORM_EVALS, QD_STDNORM_DIGITS = 9666, 60.0
QD_DEFECT = dict(m=4, n=33, max_rank=16, max_rank2=33, levels=3)   # drivers/crs_ising_qd.py
QD_DEFECT_FLOOR = 32.0
QD_PAR = dict(m=4, n=65, max_rank=33, n_workers=2)                 # drivers/crs_ising_qde.py
QD_SMALL = dict(m=4, n=17, max_rank=10)
QD_PAR_RTOL, QD_SMALL_RTOL = 1e-58, 1e-60
QD_REFINE_ABS, QD_REFINE_DIGITS = 1e-27, 28.0   # tests/test_refine.py's cases
QD_MUL_FLOPS, QD_ADD_FLOPS, QD_DIV_FLOPS = 508, 172, 1586   # ops/qd.py's qd_mul, qd_add, qd_div
QD_KERNEL_SYMBOLS = {"qd_score_residual_argmax": "qd_score_kernel", "qd_dot": "qd_dot_kernel",
                     "qd_gather_tt_fused": "qd_gather_tt_kernel",
                     "ising_c_integrand_qd_fused": "ising_c_qd_kernel"}   # csrc/qd_kernels.cu
QD_PATH_KERNELS = {"cross_qd": ("qd_score_residual_argmax", "qd_dot", "ising_c_integrand_qd_fused"),
                   "stdnorm": ("qd_score_residual_argmax", "qd_dot"),
                   "defect": ("score_residual_argmax", "ising_integrand_fused",
                              "ising_c_integrand_qd_fused", "qd_gather_tt_fused", "qd_dot"),
                   "refine": ("score_residual_argmax", "qd_dot")}


def _qd_bound(name, shape):
    """The least time of a qd kernel's call: f64 flops (QD_MUL_FLOPS per qd
    multiply, QD_ADD_FLOPS per qd add, QD_DIV_FLOPS per qd divide, counted
    from ops/qd.py's operations) over the f64 vector rate, or bytes (each
    input read once, four limbs of every qd value, each output written once)
    over the memory rate, whichever is larger."""
    if name == "qd_score_residual_argmax":
        B, T = shape
        nbytes = 32 * (2 * B * T + B) + 32 * B
        flops = B * (T * QD_MUL_FLOPS + T * QD_ADD_FLOPS)     # T - 1 tree adds + the subtraction
    elif name == "qd_dot":
        M, N, T = shape[:3]
        nbytes = 32 * (M * T + T * N + M * N)
        flops = M * N * (T * QD_MUL_FLOPS + max(T - 1, 0) * QD_ADD_FLOPS)
    elif name == "qd_gather_tt_fused":     # (B, N) + the train's ranks
        B, N, ranks = shape[0], shape[1], shape[2:]
        d = len(ranks) - 1
        nbytes = 8 * N * sum(ranks[c] * ranks[c + 1] for c in range(d)) + 4 * B * d + 32 * B
        flops = B * sum(ranks[c + 1] * (ranks[c] * QD_MUL_FLOPS + (ranks[c] - 1) * QD_ADD_FLOPS)
                        for c in range(d))
    else:   # ising_c_integrand_qd_fused: 3d + 2 multiplies, 2d adds, one divide per row
        B, d, n = shape
        nbytes = 4 * B * d + 64 * n + 32 * B
        flops = B * ((3 * d + 2) * QD_MUL_FLOPS + 2 * d * QD_ADD_FLOPS + QD_DIV_FLOPS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F64_VECTOR_FLOPS
    return max(t_bytes, t_ops) * 1e6, ("bytes" if t_bytes >= t_ops else "operations")


def _qd_rand(gen, shape, dev):
    """Random qd values with populated low limbs, on the card."""
    import torch

    from ttcross_tpu_torch.ops.qd import QD

    e0 = torch.randn(shape, generator=gen, dtype=torch.float64)
    e1 = e0 * torch.randn(shape, generator=gen, dtype=torch.float64) * 1e-17
    e2 = e1 * torch.randn(shape, generator=gen, dtype=torch.float64) * 1e-17
    e3 = e2 * torch.randn(shape, generator=gen, dtype=torch.float64) * 1e-17
    return QD(*(e.to(dev) for e in (e0, e1, e2, e3)))


def _qd_cases(dev, gen, name, shape):
    """(label, fn, plain, inputs) per layout that the qd tier gives the
    kernel at this shape: Q2 as a lottery (both operands gathered), a
    column pass (y a broadcast vector) and a row pass (x a broadcast vector,
    y a transposed view); Q4 on GEMM views (a row broadcast over N, a
    transposed column over M), in the launch's mode; Q3 on a random train
    of the run's ranks and modes of N; Q1 on make_ising_qd's tables.
    `inputs` are the call's arguments."""
    import torch

    from ttcross_tpu_torch.ops import kernels as K
    from ttcross_tpu_torch.ops.qd import QD

    out = []
    if name == "qd_score_residual_argmax":
        B, T = shape
        vals, x, y = _qd_rand(gen, (B,), dev), _qd_rand(gen, (B, T), dev), _qd_rand(gen, (B, T), dev)
        vec = _qd_rand(gen, (T,), dev)
        yt = QD(*(e.T for e in _qd_rand(gen, (T, B), dev)))
        for label, args in (("lottery", (vals, x, y)),
                            ("col", (vals, x, QD(*(e.expand(B, T) for e in vec)))),
                            ("row", (vals, QD(*(e.expand(B, T) for e in vec)), yt))):
            out.append((label, (lambda a=args: K.qd_score_residual_argmax(*a)),
                        (lambda a=args: K.qd_score_residual_argmax_plain(*a)), args))
    elif name == "qd_dot":
        M, N, T, mode = shape
        a, b = _qd_rand(gen, (M, T), dev), _qd_rand(gen, (T, N), dev)
        args = (QD(*(e[:, None, :].expand(M, N, T) for e in a)),
                QD(*(e.T[None].expand(M, N, T) for e in b)), mode == "tree")
        out.append(("gemm", (lambda: K.qd_dot(*args)), (lambda: K.qd_dot_plain(*args)), args))
    elif name == "qd_gather_tt_fused":
        B, N, ranks = shape[0], shape[1], shape[2:]
        args = (_qd_train(gen, N, ranks, dev),
                torch.randint(0, N, (B, len(ranks) - 1), generator=gen, dtype=torch.int32).to(dev))
        out.append(("train", (lambda: K.qd_gather_tt_fused(*args)),
                    (lambda: K.qd_gather_tt_plain(*args)), args))
    else:
        B, d, n = shape
        args = (_qd_tables(d, n, dev),
                torch.randint(0, n, (B, d), generator=gen, dtype=torch.int32).to(dev))
        out.append(("rows", (lambda: K.ising_c_integrand_qd_fused(*args)),
                    (lambda: K.ising_c_integrand_qd_plain(*args)), args))
    return out


_QD_TRAINS, _QD_TABLES = {}, {}


def _qd_train(gen, N, ranks, dev):
    """One random packed train per (N, ranks), shared by the shapes of a
    group (so their plain versions run as one call)."""
    import torch

    from ttcross_tpu_torch.ops import kernels as K
    from ttcross_tpu_torch.tt.types import TT

    key = (N, tuple(ranks))
    if key not in _QD_TRAINS:
        d = len(ranks) - 1
        _QD_TRAINS[key] = K.pack_tt(TT(tuple(
            torch.randn((ranks[c], N, ranks[c + 1]), generator=gen, dtype=torch.float64).to(dev)
            for c in range(d))))
    return _QD_TRAINS[key]


def _qd_tables(d, n, dev):
    from ttcross_tpu_torch.apps import make_ising_qd

    if (d, n) not in _QD_TABLES:
        _QD_TABLES[d, n] = make_ising_qd(m=d + 1, n=n, device=dev)[1].tables
    return _QD_TABLES[d, n]


def _qd_parts(r):
    from ttcross_tpu_torch.ops.qd import QD

    if isinstance(r, QD):
        return list(r)
    return [p for x in r for p in (_qd_parts(x) if isinstance(x, tuple) else [x])]


def _qd_group(name, shape):
    """Shapes whose plain versions run as one call: the per-output
    arithmetic depends on T (and Q4's mode), Q3's train, Q1's table."""
    if name == "qd_score_residual_argmax":
        return shape[1]
    if name == "qd_dot":
        return shape[2:]
    if name == "qd_gather_tt_fused":
        return shape[1:]
    return shape[1:]


def _qd_plain_of_group(name, calls):
    """The plain version over every call of a group at once, split back per
    call: the outputs are elementwise in the rows (Q2, Q3, Q1) or the
    outputs (Q4), so each equals the plain version of its own call bit for
    bit.  calls: the argument tuples.  Returns one plain result per call."""
    import torch

    from ttcross_tpu_torch.ops import kernels as K
    from ttcross_tpu_torch.ops.qd import QD

    def cat(parts):
        return QD(*(torch.cat([p[k].contiguous().reshape(-1, *p[k].shape[len(p[k].shape) - 1:])
                               if p[k].dim() > 1 else p[k].reshape(-1) for p in parts])
                    for k in range(4)))

    if name == "qd_score_residual_argmax":
        sizes = [a[1][0].shape[0] for a in calls]
        r, _ = K.qd_score_residual_argmax_plain(cat([a[0] for a in calls]), cat([a[1] for a in calls]),
                                                cat([a[2] for a in calls]))
        out = []
        for part in zip(*(e.split(sizes) for e in r)):
            q = QD(*part)
            out.append((q, torch.argmax(q.e0.abs())))
        return out
    if name == "qd_dot":
        T, tree = calls[0][0][0].shape[2], calls[0][2]
        flat = [(QD(*(e.reshape(-1, 1, T) for e in x)), QD(*(e.reshape(-1, 1, T) for e in y)))
                for x, y, _ in calls]
        sizes = [f[0][0].shape[0] for f in flat]
        r = K.qd_dot_plain(QD(*(torch.cat([f[0][k].contiguous() for f in flat]) for k in range(4))),
                           QD(*(torch.cat([f[1][k].contiguous() for f in flat]) for k in range(4))),
                           tree)
        return [QD(*(e.reshape(x[0].shape[:2]) for e in part))
                for part, (x, _, _) in zip(zip(*(e.reshape(-1).split(sizes) for e in r)), calls)]
    sizes = [a[1].shape[0] for a in calls]
    ind = torch.cat([a[1] for a in calls])
    r = (K.qd_gather_tt_plain(calls[0][0], ind) if name == "qd_gather_tt_fused"
         else K.ising_c_integrand_qd_plain(calls[0][0], ind))
    return [QD(*part) for part in zip(*(e.split(sizes) for e in r))]


def hold_qd_shapes(dev, gen, shapes, held, checked) -> None:
    """Phase 17's kernel check: every qd kernel at every shape a run launched
    it at, in each layout the qd tier gives it there (_qd_cases), bit for
    bit against its plain version on the card (all four limbs, and Q2's
    index).  The plain versions of the shapes of a group (_qd_group) run as
    one call (_qd_plain_of_group): a qd plain version is some hundreds of
    launches per qd operation whatever the shape.  Each shape's row
    (max_abs_err over its layouts, 0 when bit-equal) joins `checked` and
    `held`.  Times: time_qd_row."""
    import torch

    for name in QD_KERNELS:
        groups = {}
        for shape in sorted(set(shapes.get(name, {})) - held[name], key=str):
            groups.setdefault(_qd_group(name, shape), []).append(shape)
        for group in groups.values():
            calls = []     # (shape, label, kernel result, arguments)
            for shape in group:
                for label, fn, _, args in _qd_cases(dev, gen, name, shape):
                    calls.append((shape, label, fn(), args))
            wants = _qd_plain_of_group(name, [c[3] for c in calls])
            torch.cuda.synchronize()
            errs = {}
            for (shape, label, got, _), want in zip(calls, wants):
                got, want = _qd_parts(got), _qd_parts(want)
                if not all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(got, want)):
                    raise AssertionError(f"{name} {shape} ({label}): not bit-equal to its plain "
                                         "version")
                errs[shape] = max([errs.get(shape, 0.0)] + [
                    float((a.double() - b.double()).abs().max()) for a, b in zip(got, want)])
            for shape in group:
                bound, by = _qd_bound(name, shape)
                checked[name][tuple(shape)] = {"kernel": name, "shape": list(shape),
                                               "max_abs_err": errs[shape], "bound_us": bound,
                                               "bound_by": by}
                held[name].add(tuple(shape))


def time_qd_row(dev, gen, name, shape, row) -> dict:
    """The times of a held qd kernel's shape (first layout): device µs per
    call and the kernel's own µs (torch.profiler, each device operation at
    its mean per recorded launch), the kernels per call the profiler
    recorded, CUDA-event ms of kernel and plain, the plain version's device
    µs, host µs per wrapper call; the bound's share.  Added to `row` once."""
    if "ms" in row:
        return row
    _, fn, plain, _ = _qd_cases(dev, gen, name, shape)[0]
    calls = 20
    for _ in range(10):      # a window may record none of the kernel's launches: profile again
        dev_k = device_per_call(fn, calls=calls)
        own = [v for k, v in dev_k["by_kernel"].items() if QD_KERNEL_SYMBOLS[name] in k]
        if own:
            break
    own_per_call = sum(c for _, c in own) / calls
    if not 0 < own_per_call <= 1:
        raise AssertionError(f"{name} {shape}: {own_per_call} launches of "
                             f"{QD_KERNEL_SYMBOLS[name]} per call (one is the design)")
    # each device operation of a call (the kernel; Q2's scratch zeroing too) at its mean over
    # the launches the profiler recorded, which now and then are fewer than the calls
    device_us = sum(t / c for t, c in dev_k["by_kernel"].values())
    dev_p = device_per_call(plain, calls=2)
    row.update(ms=_time_ms(fn, reps=10), plain_ms=_time_ms(plain, reps=3), library_ms=None,
               device_us=device_us, kernels_per_call=dev_k["kernels_per_call"],
               kernel_us=sum(t for t, _ in own) / sum(c for _, c in own),
               device_ops_us={k[:48]: t / c for k, (t, c) in dev_k["by_kernel"].items()},
               plain_device_us=dev_p["device_us"],
               plain_kernels_per_call=dev_p["kernels_per_call"],
               share_of_bound=row["bound_us"] / device_us,
               host_us_per_call=host_us_per_call(fn, calls=100))
    _emit({"phase": "qd_kernel", **row})
    return row


def _qd_digits(limbs, truth: str) -> float:
    from decimal import Decimal, localcontext

    from ttcross_tpu_torch.ops.qd import qd_to_mp

    with localcontext() as ctx:
        ctx.prec = 80
        rel = abs(1 - qd_to_mp(*limbs) / Decimal(truth))
        return float(-rel.log10()) if rel != 0 else 80.0


def _qd_rel(a, b) -> float:
    from decimal import localcontext

    from ttcross_tpu_torch.ops.qd import qd_to_mp

    with localcontext() as ctx:
        ctx.prec = 80
        x, y = qd_to_mp(*a), qd_to_mp(*b)
        return float(abs(x - y) / abs(y)) if y != 0 else float(abs(x))


def _pi_squared() -> str:
    """pi^2 = pi^(d/2) at d = 4, the product Gaussian's truth, as a string
    at 70 digits."""
    from decimal import Decimal, localcontext

    from ttcross_tpu_torch.apps import TPI_STR

    with localcontext() as ctx:
        ctx.prec = 70
        return str((Decimal(TPI_STR) / 2) ** 2)


def _limbs(x) -> list:
    return [float(e) for e in x]


def run_qd_c4(dev, **cfg):
    """One cross_qd on make_ising_qd(m, n) at `max_rank`, rook, seed 0, on
    `dev`: (result, wall, launches, by shape)."""
    import torch

    from ttcross_tpu_torch.apps import ISING_C_STR, make_ising_qd
    from ttcross_tpu_torch.cross import cross_qd
    from ttcross_tpu_torch.ops import kernels as K

    prob, fun_qd, wq = make_ising_qd(m=cfg["m"], n=cfg["n"], device=dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = cross_qd(fun_qd, [prob.n] * prob.d, max_rank=cfg["max_rank"], pivoting=1, quad=wq,
                   truth=ISING_C_STR[cfg["m"]], seed=0, device=dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0, K.launch_counts(), K.launch_shapes()


def _vip_of(monkey_mod):
    """Record the QdEngine each cross_qd builds (its pivot chains)."""
    seen = []
    base = monkey_mod.QdEngine

    class Recorded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)

    monkey_mod.QdEngine = Recorded
    return seen, base


def run_qd_parallel(device):
    """cross_qd_parallel at QD_PAR through the hub, as cross_qd_parallel
    calls it, with the workers' reports: the result, wall, every worker's
    vip, launches by shape (workers and parent merged) and host reads."""
    import torch

    from ttcross_tpu_torch.apps import ISING_C_STR, make_ising_qd
    from ttcross_tpu_torch.cross.engine_qd import QD_DPS
    from ttcross_tpu_torch.ops import kernels as K
    from ttcross_tpu_torch.parallel._hub import run_hub
    from ttcross_tpu_torch.parallel.engine_qd import _QdAdapter

    prob, fun_qd, wq = make_ising_qd(m=QD_PAR["m"], n=QD_PAR["n"], device=device)
    reports = []
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_hub(_QdAdapter(None, -7.0, device), fun_qd, [prob.n] * prob.d, QD_PAR["max_rank"],
                  1, wq, ISING_C_STR[4], -QD_DPS + 4, 8, 0, False, QD_PAR["n_workers"], None,
                  name="cross_qd_parallel", timeout=600.0, reports=reports)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shapes = _merge_shapes([K.launch_shapes()] + [e["shapes"] for e in reports])
    return res, wall, [e["vip"] for e in reports], shapes, sum(e["host_reads"] for e in reports)


def _dyadic_case(dev):
    """tests/test_refine.py's exact-rank case, on the port: a (2, 2) train
    of dyadic rationals at d = 3, n = 5, its dense tensor and the exact
    quadrature against weights 1/8."""
    from fractions import Fraction

    import numpy as np
    import torch

    rng = np.random.default_rng(31)
    cores = [np.round(rng.standard_normal((r1, 5, r2)) * 16) / 16
             for (r1, r2) in [(1, 2), (2, 2), (2, 1)]]
    dense = np.einsum("aib,bjc,ckd->ijk", *cores)
    exact = sum((Fraction(float(dense[idx])) * Fraction(1, 8) ** 3
                 for idx in np.ndindex(*dense.shape)), Fraction(0))
    table = torch.from_numpy(dense).to(dev)

    def fun(ind):
        i = ind.long()
        return table[i[:, 0], i[:, 1], i[:, 2]]

    def fun_dd(ind):
        v = fun(ind)
        return v, torch.zeros_like(v)

    return fun, fun_dd, exact


def check_refine(dev) -> dict:
    """refine_dd on the JAX package's two test cases, on the card: the
    exact-rank dyadic tensor against exact rationals (QD_REFINE_ABS), and
    stdnorm d = 4 at n = 101 on [-8.5, 8.5] (>= QD_REFINE_DIGITS)."""
    from decimal import Decimal, localcontext
    from fractions import Fraction

    import numpy as np
    import torch

    from ttcross_tpu_torch.apps import make_stdnorm
    from ttcross_tpu_torch.apps.stdnorm import StdnormDD
    from ttcross_tpu_torch.cross import cross, refine_dd
    from ttcross_tpu_torch.ops import kernels as K
    from ttcross_tpu_torch.ops.dd import DD, dd, dd_mul
    from ttcross_tpu_torch.ops.quadrature import gauss_legendre_dd

    K.reset_launch_counts()
    t0 = time.perf_counter()
    fun, fun_dd, exact = _dyadic_case(dev)
    res = cross(fun, [5] * 3, max_rank=3, pivoting=1, accuracy=1e-12, return_state=True,
                device=dev)
    hi, lo, neval = refine_dd(res.state, [5] * 3, fun_dd, [np.full(5, 0.125)] * 3, device=dev)
    err = abs(float(Fraction(hi) + Fraction(lo) - exact))
    (xh, xl), (wh, wl) = gauss_legendre_dd(101)
    X = dd_mul(DD(torch.from_numpy(xh), torch.from_numpy(xl)), dd(8.5))
    W = dd_mul(DD(torch.from_numpy(wh), torch.from_numpy(wl)), dd(8.5))
    prob = make_stdnorm(d=4, n=101, a=-8.5, b=8.5, device=dev)
    sres = cross(prob.fun, [101] * 4, max_rank=4, pivoting=1, accuracy=25e-16, return_state=True,
                 device=dev)
    shi, slo, sneval = refine_dd(sres.state, [101] * 4, StdnormDD(X, dev), [W.hi.numpy()] * 4,
                                 [W.lo.numpy()] * 4, device=dev)
    torch.cuda.synchronize()
    with localcontext() as ctx:
        ctx.prec = 70
        rel = abs(1 - (Decimal(shi) + Decimal(slo)) / Decimal(_pi_squared()))
        digits = float(-rel.log10()) if rel != 0 else 70.0
    row = {"phase": "qd_refine", "config": "refine_dd: exact-rank dyadic d=3 n=5 rank 3; stdnorm "
           "d=4 n=101 [-8.5, 8.5] rank 4", "dyadic_abs_err": err, "dyadic_n_evals": neval,
           "stdnorm_digits": digits, "stdnorm_n_evals": sneval, "wall_s": time.perf_counter() - t0,
           "launches": K.launch_counts()}
    _emit(row)
    if not err < QD_REFINE_ABS or digits < QD_REFINE_DIGITS:
        raise AssertionError(f"refine_dd: dyadic error {err}, stdnorm digits {digits}")
    return K.launch_shapes()


def check_small_qd_against_cpu(dev) -> dict:
    """cross_qd at QD_SMALL on the card and on the CPU with the same seed:
    vip, ranks, n_evals and sweeps equal, the value within QD_SMALL_RTOL
    (and whether its limbs are bit-equal)."""
    import ttcross_tpu_torch.cross.engine_qd as E

    out = {}
    for where in (dev, "cpu"):
        seen, base = _vip_of(E)
        try:
            out[str(where)] = (run_qd_c4(where, **QD_SMALL)[0], seen[0].vip)
        finally:
            E.QdEngine = base
    (card, cvip), (cpu, pvip) = out[str(dev)], out["cpu"]
    rel = _qd_rel(_limbs(card.value), _limbs(cpu.value))
    same = (cvip == pvip and card.ranks == cpu.ranks and card.neval == cpu.neval
            and card.sweeps == cpu.sweeps)
    row = {"phase": "qd_small_vs_cpu", "config": "cross_qd C_4 n=17 rank 10 seed 0",
           "card": _limbs(card.value), "cpu": _limbs(cpu.value), "ranks": list(card.ranks),
           "n_evals": card.neval, "sweeps": card.sweeps, "equal": same, "rel": rel,
           "bit_equal": _limbs(card.value) == _limbs(cpu.value)}
    _emit(row)
    if not same or rel > QD_SMALL_RTOL:
        raise AssertionError(f"the card's cross_qd differs from the CPU's: {row}")
    return row


def check_qd(dev, gen, held, checked, profile=False):
    """Phase 17: the qd tier.  (1) cross_qd at QD_C4 (digits >= QD_C4_FLOOR;
    wall, n_evals, sweeps, launches, host reads per bond visit; one
    profiled run for the card's busy share); (2) bench.py's
    stdnorm_d4_qd_engine (ranks 1, QD_STDNORM_EVALS evaluations, >=
    QD_STDNORM_DIGITS); (3) cross_defect_corrected_qd at QD_DEFECT (>=
    QD_DEFECT_FLOOR); (4) cross_qd_parallel with 2 workers on the card at
    QD_PAR, equal to 2 workers on the CPU (vip, ranks, n_evals; value within
    QD_PAR_RTOL); (5) refine_dd on the two JAX test cases; (6) a small
    cross_qd against the CPU.  Every qd kernel held bit for bit at every
    shape these runs launched it at (hold_qd_shapes), the f64 kernels of
    the defect's and refine's crosses at theirs.  Returns [(path label,
    launches by shape, the kernels it must launch)]."""
    import torch

    from ttcross_tpu_torch.apps import ISING_C_STR, make_ising_qd, make_stdnorm_qd
    from ttcross_tpu_torch.cross import cross_defect_corrected_qd, cross_qd
    from ttcross_tpu_torch.ops import kernels as K

    paths = []
    t_phase = time.perf_counter()

    def hold(label, shapes, everywhere=False):
        t0 = time.perf_counter()
        if everywhere:
            _held_everywhere(dev, gen, held, checked, label, shapes)
        else:
            hold_qd_shapes(dev, gen, shapes, held, checked)
        _emit({"phase": "qd_hold", "path": label, "seconds": time.perf_counter() - t0,
               "shapes": {k: len(v) for k, v in shapes.items() if v},
               "phase_elapsed_s": time.perf_counter() - t_phase})

    # 1. C_4 at n = 65, rank 55
    res, wall, counts, shapes = run_qd_c4(dev, **QD_C4)
    digits = _qd_digits(_limbs(res.value), ISING_C_STR[4])
    visits = res.sweeps * (QD_C4["m"] - 2)
    row = {"phase": "qd", "config": "cross_qd C_4 n=65 rank 55 pivoting=1 seed 0",
           "digits": digits, "floor": QD_C4_FLOOR, "value": _limbs(res.value),
           "n_evals": res.neval, "sweeps": res.sweeps, "ranks": list(res.ranks), "wall_s": wall,
           "launches": counts, "host_reads": res.history[-1]["host_reads"],
           "host_reads_per_bond_visit": res.history[-1]["host_reads"] / visits}
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile

        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_qd_c4(dev, **QD_C4)
            pwall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
        busy = sum(_device_us(e) for e in kern) * 1e-6
        row.update(profiled_wall_s=pwall, device_busy_s=busy, device_busy_share=busy / pwall,
                   device_launches=sum(e.count for e in kern),
                   top=[[e.key[:60], e.count, _device_us(e)] for e in
                        sorted(kern, key=_device_us, reverse=True)[:8]])
    _emit(row)
    if digits < QD_C4_FLOOR or not all(math.isfinite(v) for v in row["value"]):
        raise AssertionError(f"cross_qd C_4 n=65 rank 55: {digits} digits < {QD_C4_FLOOR}")
    hold("qd cross_qd", shapes)
    paths.append(("qd cross_qd C_4 n=65 rank 55", shapes, QD_PATH_KERNELS["cross_qd"]))

    # 2. stdnorm d = 4, n = 201, rank 4
    prob, fun_qd, wq = make_stdnorm_qd(d=QD_STDNORM["d"], n=QD_STDNORM["n"], device=dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    sres = cross_qd(fun_qd, [prob.n] * prob.d, max_rank=QD_STDNORM["max_rank"], quad=wq,
                    device=dev)
    torch.cuda.synchronize()
    sdig = _qd_digits(_limbs(sres.value), _pi_squared())
    srow = {"phase": "qd", "config": "stdnorm_d4_qd_engine: make_stdnorm_qd(d=4, n=201) rank 4",
            "digits": sdig, "n_evals": sres.neval, "ranks": list(sres.ranks),
            "sweeps": sres.sweeps, "wall_s": time.perf_counter() - t0,
            "launches": K.launch_counts()}
    _emit(srow)
    sshapes = K.launch_shapes()
    if (sres.ranks != (1,) * 5 or sres.neval != QD_STDNORM_EVALS
            or sdig < QD_STDNORM_DIGITS):
        raise AssertionError(f"stdnorm_d4_qd_engine: {srow}")
    hold("qd stdnorm", sshapes)
    paths.append(("qd stdnorm_d4_qd_engine", sshapes, QD_PATH_KERNELS["stdnorm"]))

    # 3. the qd defect pipeline at drivers/crs_ising_qd.py's defaults
    prob, fun_qd, wq = make_ising_qd(m=QD_DEFECT["m"], n=QD_DEFECT["n"], device=dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    limbs, info = cross_defect_corrected_qd(prob.fun, fun_qd, [prob.n] * prob.d, wq,
                                            max_rank=QD_DEFECT["max_rank"],
                                            max_rank2=QD_DEFECT["max_rank2"],
                                            levels=QD_DEFECT["levels"], device=dev)
    torch.cuda.synchronize()
    ddig = _qd_digits(limbs, ISING_C_STR[4])
    dshapes = K.launch_shapes()
    _emit({"phase": "qd", "config": "cross_defect_corrected_qd C_4 n=33 ranks 16 / 33 levels 3",
           "digits": ddig, "floor": QD_DEFECT_FLOOR, "limbs": list(limbs),
           "n_evals": info["nevals"], "ranks": [list(r) for r in info["ranks"]],
           "wall_s": time.perf_counter() - t0, "launches": K.launch_counts(),
           "launches_by_shape": _by_shape(dshapes)})
    if ddig < QD_DEFECT_FLOOR:
        raise AssertionError(f"cross_defect_corrected_qd: {ddig} digits < {QD_DEFECT_FLOOR}")
    hold("qd defect", dshapes, everywhere=True)
    paths.append(("qd cross_defect_corrected_qd C_4 n=33", dshapes, QD_PATH_KERNELS["defect"]))

    # 4. cross_qd_parallel, 2 workers on the card against 2 on the CPU
    pres, pwall, pvips, pshapes, preads = run_qd_parallel(str(dev))
    cres, cwall, cvips, _, _ = run_qd_parallel("cpu")
    prel = _qd_rel(_limbs(pres.value), _limbs(cres.value))
    same = (pvips[0] == cvips[0] and all(v == pvips[0] for v in pvips + cvips)
            and pres.ranks == cres.ranks and pres.neval == cres.neval)
    _emit({"phase": "qd_parallel", "config": "cross_qd_parallel C_4 n=65 rank 33, 2 workers",
           "digits": _qd_digits(_limbs(pres.value), ISING_C_STR[4]), "n_evals": pres.neval,
           "sweeps": pres.sweeps, "ranks": list(pres.ranks), "wall_s": pwall, "cpu_wall_s": cwall,
           "equals_cpu": same, "rel_cpu": prel, "host_reads": preads,
           "bit_equal_cpu": _limbs(pres.value) == _limbs(cres.value),
           "launches_by_shape": _by_shape(pshapes)})
    if not same or prel > QD_PAR_RTOL:
        raise AssertionError("cross_qd_parallel: 2 workers on the card differ from 2 on the CPU")
    hold("qd parallel", pshapes)
    paths.append(("qd cross_qd_parallel 2 workers", pshapes, QD_PATH_KERNELS["cross_qd"]))

    # 5. refine_dd
    rshapes = check_refine(dev)
    hold("qd refine", rshapes, everywhere=True)
    paths.append(("qd refine_dd", rshapes, QD_PATH_KERNELS["refine"]))

    # 6. the small cross_qd against the CPU
    check_small_qd_against_cpu(dev)
    return paths


# ------------------------------------------------------------ phase 18: the mp tier, native, the drivers
# The mp tier (ops/mp.py, cross_mp, cross_mp_parallel, the compiled MPFR
# engine) and native/ are host code by design, as in the JAX package and the
# reference's MPFUN tier (ttcross_tpu/ops/mp.py:1-17): they run on the card's
# host and launch nothing on the card.  The drivers (ttcross_tpu_torch/
# drivers/) run the card's tiers from a user's command line.  Expected
# results: CPU runs of the JAX package, which the port's CPU runs equal
# string for string (tests/test_torch_engine_mp.py, test_torch_mp_native.py):
#   ising_cross_mp_native C_4 n=65 rank 32 dps 120 (bench.py:574-590,
#     ising_c4_mp120_native)            37.0267 digits, 80,385 evals, 31 sweeps
#   cross_mp C_4 n=33 rank 12 dps 60    14.1946 digits, 7,425 evals, 11 sweeps
#   cross_mp_parallel, 2 workers        14.5004 digits, 7,777 evals, 11 sweeps
# The drivers' floors are the CPU floors of the configurations that phases 15
# and 17 run (DD_FLOORS, QD_*), or, where no phase runs it, the JAX driver's
# digits on the CPU at that configuration, which the port's CPU run equals:
#   crs_ising_qde 4 65 33 1 1 (its defaults)                   37.72
#   crs_ising_mpf C 4 33 12 60 (phase 18's cross_mp; its default, rank 48 at
#     n = 65 and 120 digits, takes minutes in mpmath)          14.19
#   crs_ising_mpn (its defaults: C 4 33 16 1 120)               19.87
MP_NATIVE = dict(kind="C", m=4, n=65, max_rank=32, dps=120)
MP_NATIVE_VALUE = ("0.70119986017642999981651392754834582798122257723922270354599932590271471281"
                   "726467977910992326699961230123086303075723359195856975E0")
MP_NATIVE_EVALS, MP_NATIVE_SWEEPS, MP_NATIVE_FLOOR = 80385, 31, 37.0
MP_CROSS = dict(m=4, n=33, max_rank=12, dps=60)
MP_CROSS_RUNS = {   # entry point: (value at 60 digits, n_evals, ranks, sweeps)
    "cross_mp": ("0.701199860176425520113207819413718382858226560439547794973630", 7425,
                 (1, 12, 12, 1), 11),
    "cross_mp_parallel": ("0.701199860176427784531338581204031348248389026947825551268724",
                          7777, (1, 12, 12, 1), 11),
}
MP_WORKERS = 2
DRIVER_RUNS = [   # (driver, argv, digits floor, the kernels its path must launch)
    ("crs_ising_dd", [], DD_FLOORS["defect_c6"], DD_PATH_KERNELS["defect"]),
    ("crs_ising_mp", [], DD_FLOORS["c4_n65_r32"], DD_PATH_KERNELS["dd"]),
    ("crs_stdnorm_dd", [], QD_REFINE_DIGITS, QD_PATH_KERNELS["refine"] + ("small_table_lookup",)),
    ("crs_ising_qd", [], QD_DEFECT_FLOOR, QD_PATH_KERNELS["defect"]),
    ("crs_ising_qde", [], 37.72, QD_PATH_KERNELS["cross_qd"]),
    ("crs_ising_mpf", ["C", "4", "33", "12", "60"], 14.19, ()),
    ("crs_ising_mpn", [], 19.87, ()),
    ("chf_equal", [], None, ()),
]
HOST_DRIVERS = ("crs_ising_mpf", "crs_ising_mpn")


def _prerequisites() -> dict:
    """What the host libraries need on the card's host: g++, the MPFR / GMP /
    quadmath shared libraries and mpmath (torch's sympy depends on it)."""
    import ctypes
    import importlib.util
    import shutil

    have = {"g++": shutil.which("g++") is not None,
            "mpmath": importlib.util.find_spec("mpmath") is not None}
    for lib in ("libmpfr.so.6", "libgmp.so.10", "libquadmath.so.0"):
        try:
            ctypes.CDLL(lib)
            have[lib] = True
        except OSError:
            have[lib] = False
    return have


def _run_driver(name, argv, device):
    """One driver's main in process: (exit code, output, wall)."""
    import contextlib
    import importlib
    import io

    import torch

    mod = importlib.import_module(f"ttcross_tpu_torch.drivers.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv) if name in HOST_DRIVERS else mod.main(argv, device=device)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0


def _driver_digits(out):
    for line in out.splitlines():
        if line.startswith("correct digits:"):
            return float(line.split(":")[1].split()[0])
    return None


def check_mp_native_drivers(dev, gen, held, checked):
    """Phase 18: the host libraries, the mp tier and the drivers.
      1. both native libraries built with g++ (seconds each) and the MPFR
         library's ABI self-test;
      2. ising_cross_mp_native at MP_NATIVE: value_str, n_evals and sweeps
         those of the CPU run, digits >= MP_NATIVE_FLOOR, its wall;
      3. cross_mp and cross_mp_parallel (MP_WORKERS spawned workers) at
         MP_CROSS: the JAX package's value strings, n_evals, ranks, sweeps;
      4. every driver in process (DRIVER_RUNS), on the card: its digits held
         to its floor, its wall and launches per kernel; the dd / qd paths'
         kernels must launch, and every shape is held against the plain
         version (_held_everywhere); the mp tier launches nothing.
    Returns [(path label, launches by shape, the kernels it must launch)]."""
    from mpmath import mp

    from ttcross_tpu_torch import native
    from ttcross_tpu_torch.apps import make_ising_mp
    from ttcross_tpu_torch.cross import cross_mp, ising_cross_mp_native
    from ttcross_tpu_torch.ops import kernels as K
    from ttcross_tpu_torch.ops.mp import workdps
    from ttcross_tpu_torch.parallel import cross_mp_parallel

    have = _prerequisites()
    absent = sorted(k for k, v in have.items() if not v)
    for what in absent:
        print(f"phase 18: {what} is absent on the card's host", flush=True)
    _emit({"phase": "native_prerequisites", **have})
    if absent:
        raise AssertionError(f"phase 18 needs {absent}")

    t0 = time.perf_counter()
    ok_native = native.build()
    t1 = time.perf_counter()
    ok_mpfr = native.build_mpfr()
    t2 = time.perf_counter()
    selftest = native.load_mpfr().mp_selftest() if ok_mpfr else None
    _emit({"phase": "native_build", "ttcross_native_s": t1 - t0, "mpfr_cross_s": t2 - t1,
           "built": [ok_native, ok_mpfr], "mp_selftest": selftest})
    if not (ok_native and ok_mpfr and native.available() and selftest == 27182818):
        raise AssertionError(f"native libraries: built {ok_native} / {ok_mpfr}, self-test "
                             f"{selftest}")

    K.reset_launch_counts()
    t0 = time.perf_counter()
    r = ising_cross_mp_native(**MP_NATIVE)
    row = {"phase": "mp", "config": "ising_cross_mp_native C_4 n=65 rank 32 dps 120",
           "digits": r.digits, "n_evals": r.neval, "sweeps": r.sweeps, "ranks": list(r.ranks),
           "wall_s": time.perf_counter() - t0, "equals_cpu": r.value_str == MP_NATIVE_VALUE,
           "value": r.value_str[:50]}
    _emit(row)
    if (not row["equals_cpu"] or (r.neval, r.sweeps) != (MP_NATIVE_EVALS, MP_NATIVE_SWEEPS)
            or r.digits < MP_NATIVE_FLOOR):
        raise AssertionError(f"ising_cross_mp_native differs from the CPU run: {row}")

    d, n, fun, quad, truth = make_ising_mp("C", m=MP_CROSS["m"], n=MP_CROSS["n"],
                                           dps=MP_CROSS["dps"])
    kw = dict(max_rank=MP_CROSS["max_rank"], pivoting=1, quad=quad, truth=truth,
              dps=MP_CROSS["dps"])
    for name, run in (("cross_mp", lambda: cross_mp(fun, [n] * d, **kw)),
                      ("cross_mp_parallel",
                       lambda: cross_mp_parallel(fun, [n] * d, n_workers=MP_WORKERS, **kw))):
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        with workdps(MP_CROSS["dps"]):
            got = (mp.nstr(res.value, MP_CROSS["dps"], strip_zeros=False), res.neval,
                   tuple(res.ranks), res.sweeps)
            digits = float(-mp.log10(abs(1 - res.value / truth)))
        row = {"phase": "mp", "config": f"{name} C_4 n=33 rank 12 dps 60"
               + (f", {MP_WORKERS} spawned workers" if name != "cross_mp" else ""),
               "digits": digits, "n_evals": res.neval, "sweeps": res.sweeps,
               "ranks": list(res.ranks), "wall_s": wall, "equals_jax": got == MP_CROSS_RUNS[name]}
        _emit(row)
        if not row["equals_jax"]:
            raise AssertionError(f"{name} differs from the JAX package's CPU run: {got}")
    if sum(K.launch_counts().values()):
        raise AssertionError(f"the mp tier launched kernels: {K.launch_counts()}")

    paths = []
    for name, argv, floor, need in DRIVER_RUNS:
        K.reset_launch_counts()
        rc, out, wall = _run_driver(name, argv, dev)
        counts, shapes = K.launch_counts(), K.launch_shapes()
        digits = _driver_digits(out)
        row = {"phase": "driver", "driver": name, "argv": argv, "rc": rc, "digits": digits,
               "floor": floor, "wall_s": wall, "launches": {k: v for k, v in counts.items() if v},
               "equal": "EQUAL" in out if name == "chf_equal" else None}
        _emit(row)
        if rc != 0 or (floor is not None and (digits is None or digits < floor)):
            raise AssertionError(f"driver {name}: {row}\n{out[-2000:]}")
        if name in HOST_DRIVERS and sum(counts.values()):
            raise AssertionError(f"driver {name} (host only) launched kernels: {counts}")
        if need:
            if min(counts.get(k, 0) for k in need) <= 0:
                raise AssertionError(f"driver {name}: a kernel of its path never launched: "
                                     f"{counts}")
            t0 = time.perf_counter()
            _held_everywhere(dev, gen, held, checked, f"driver {name}", shapes)
            _emit({"phase": "driver_hold", "driver": name, "seconds": time.perf_counter() - t0,
                   "shapes": {k: len(v) for k, v in shapes.items() if v}})
            paths.append((f"driver {name}", shapes, need))
    return paths


def profile_run(label: str, run) -> None:
    """torch.profiler over one steady run (run() returns a tuple that
    starts with the result): kernel time by name, the device's busy share
    of the run's wall time, and the kernel launches per sweep."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()[0]
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    print(avgs.table(sort_by="self_cuda_time_total", row_limit=30), flush=True)
    # device kernels only: an aten op's self device time repeats its kernels'
    kernels = [e for e in avgs if "CUDA" in str(getattr(e, "device_type", ""))]
    busy_us = sum(_device_us(e) for e in kernels)
    _emit({"phase": "profile", "run": label, "wall_s": wall, "device_busy_s": busy_us * 1e-6,
           "device_busy_share": busy_us * 1e-6 / wall,
           "kernel_launches": sum(e.count for e in kernels), "sweeps": res.sweeps,
           "kernel_launches_per_sweep": sum(e.count for e in kernels) / res.sweeps,
           "top": [[e.key[:80], e.count, _device_us(e)] for e in
                   sorted(kernels, key=_device_us, reverse=True)[:15]]})


T_START = time.perf_counter()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    _emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
           "kind": kind, "count": torch.cuda.device_count()})

    from ttcross_tpu_torch.ops import _build
    from ttcross_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    lib_path, nvcc_s, report = _build.build()      # one nvcc per source, all at once
    _build.load()
    _emit({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": nvcc_s,
           "library": str(lib_path.relative_to(_build.BUILD_ROOT.parent.parent))})
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    gen = torch.Generator().manual_seed(1234)
    a_cases, b_cases = kernel_cases(dev, gen)
    i_cases = integrand_cases(dev, gen)
    a_rows, b_rows = check_kernels(dev, a_cases, b_cases)
    i_rows = check_integrand(i_cases)
    ab_rows = check_batched(dev, gen)
    # the f32 instantiations of every kernel
    a32, b32, i32, p32 = f32_cases(dev, gen)
    a32_rows, b32_rows = check_kernels(dev, a32, b32)
    a_rows, b_rows = a_rows + a32_rows, b_rows + b32_rows
    i_rows = i_rows + check_integrand(i32)
    ab_rows = ab_rows + check_batched(dev, gen, p32, torch.float32)
    del a32, b32, i32
    # phase 3's row of every (kernel, shape) it held against the plain version
    # (the first at a shape: the integrand's kind C, which every driven run uses)
    checked = {name: {tuple(r["shape"]): r for r in reversed(rows)} for name, rows in
               [("score_residual_argmax", a_rows), ("score_residual_argmax_batched", ab_rows),
                ("small_table_lookup", b_rows), ("ising_integrand_fused", i_rows)]}
    checked.update({name: {} for name in DD_KERNELS})   # held by phase 15 at its runs' shapes
    checked.update({name: {} for name in QD_KERNELS})   # held by phase 17 at its runs' shapes
    held = {name: set(by) for name, by in checked.items()}
    args = sys.argv[1:]
    if "--parent" in args:
        _emit(compare_with(args[args.index("--parent") + 1], a_cases, b_cases, i_cases))
    del a_cases, b_cases, i_cases

    K.reset_launch_counts()
    res, first, digits = run_headline(dev, oversample=6)
    launches, shapes = K.launch_counts(), K.launch_shapes()
    K.reset_launch_counts()
    res2, steady, digits2 = run_headline(dev, oversample=6)
    steady_launches = K.launch_counts()
    runs = [(res, digits)] + [run_headline(dev, oversample=6, key=k)[::2] for k in KEYS[1:]]
    runs_res, by_key = [r for r, _ in runs], [dg for _, dg in runs]
    median = statistics.median(by_key)
    _emit({"phase": "headline", "config": "C_6 n=65 rank 24 oversample=6 pivoting=1",
           "digits": digits, "n_evals": res.neval, "padded_evals": res.padded_evals,
           "ranks": list(res.ranks), "sweeps": res.sweeps, "first_s": first,
           "steady_s": steady, "steady_digits": digits2, "launches": launches,
           "launches_by_shape": _by_shape(shapes),
           "steady_launches": steady_launches, "digits_by_key": by_key,
           "median_digits": median})
    if "--profile" in args:
        profile_run("C_6 headline", lambda: run_headline(dev, oversample=6))
    if median < DIGITS_MEDIAN or min(by_key) < DIGITS_FLOOR:
        raise AssertionError(f"headline digits over keys {by_key}: median {median} < "
                             f"{DIGITS_MEDIAN} or a key < {DIGITS_FLOOR}")
    # the headline's integrand runs on the fused kernel; the standalone
    # lookup (the chain lift's) is held on the long chain's run below
    if min(launches[k] for k in MAIN_PATH_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")
    _require_held("C_6 headline", shapes, held)
    if (res2.neval, res2.ranks, digits2, steady_launches) != (res.neval, res.ranks, digits, launches):
        raise AssertionError("the repeated headline run took another path")
    _emit(check_rounding(dev, [r.values[-1] for r, _ in runs]))
    _emit(check_small_against_cpu(dev))

    res_g, wall_g, digits_g = run_headline(dev, oversample=0, return_state=True)
    on_card = all(t.device.type == "cuda" for t in res_g.state)
    _emit({"phase": "greedy", "config": "C_6 n=65 rank 24 pivoting=1", "digits": digits_g,
           "n_evals": res_g.neval, "ranks": list(res_g.ranks), "sweeps": res_g.sweeps,
           "wall_s": wall_g, "state_on_card": on_card})
    if digits_g < DIGITS_GREEDY:
        raise AssertionError(f"greedy digits {digits_g} < {DIGITS_GREEDY}")
    if not on_card:
        raise AssertionError("the cross state left the card")

    _, lc_shapes = check_long_chain(dev, held)
    if "--profile" in args:
        profile_run("C_256 jacobi-rb chain", lambda: run_long_chain(dev))
        profile_run("C_256 jacobi-rb, black-box integrand",
                    lambda: run_long_chain(dev, chain=False))
        profile_run("C_1024 jacobi-rb chain", lambda: run_long_chain(dev, m=1024))
        profile_long_chain_parts(dev)

    mvn_runs = check_mvn_path(dev, held)
    if "--profile" in args:
        profile_run("mvn_d6 greedy", lambda: run_mvn(dev))
        profile_run("mvn_d6 refine_sweeps=2", lambda: run_mvn(dev, refine_sweeps=2))
        profile_maxvol_parts(dev)

    new_runs = [("C_6 headline host_reeval",
                 check_headline_host_reeval(dev, gen, held, checked, list(zip(runs_res, by_key)))),
                ("mvn_d6 family", check_family(dev, held)),
                ("Greeks", check_greeks(dev, gen, held, checked)),
                ("C_6 capped + chunked", check_capped(dev, gen, held, checked)),
                ("stdnorm_d10 adaptive", check_adaptive(dev, held)),
                ("quantics", check_quantics(dev, gen, held, checked))]
    new_runs += list(zip(("C_6 f32", "mvn_d6 f32"), check_f32(dev, gen, held, checked)))
    if "--profile" in args:
        profile_run("C_6 capped + chunked", lambda: run_capped(dev))
        profile_run("C_6 f32", lambda: run_f32(dev, "C_6"))
    dd_paths = check_dd(dev, gen, held, checked)
    new_runs += [(path, shapes) for path, shapes, _ in dd_paths]
    par_paths = check_parallel(dev, gen, held, checked)
    new_runs += [(path, shapes) for path, shapes, _ in par_paths]
    t17 = time.perf_counter()
    qd_paths = check_qd(dev, gen, held, checked, profile=True)
    _emit({"phase": "qd_done", "seconds": time.perf_counter() - t17,
           "script_elapsed_s": time.perf_counter() - T_START})
    new_runs += [(path, shapes) for path, shapes, _ in qd_paths]
    t18 = time.perf_counter()
    drv_paths = check_mp_native_drivers(dev, gen, held, checked)
    _emit({"phase": "phase18_done", "seconds": time.perf_counter() - t18,
           "script_elapsed_s": time.perf_counter() - T_START})
    new_runs += [(path, shapes) for path, shapes, _ in drv_paths]
    if "--profile" in args:
        for name in ("c4_n65_r32", "c6_n65_r48"):
            profile_run(f"dd {name}", lambda name=name: run_dd(dev, name))

    # one entry for every (kernel, shape) that a path's run launched at: the
    # launches are those of that run, counted from 0 (the C_6 headline's
    # first run, the C_256 long chain's, the first run of each configuration
    # of the MVN / COS phase); the error, the times and the bound are those of
    # phase 3's check of the kernel at that shape
    entries = []
    for path, by_kernel in [("C_6 headline", shapes), ("C_256 long chain", lc_shapes)] + mvn_runs + new_runs:
        for name, by in sorted(by_kernel.items()):
            if name in QD_KERNELS and by:
                # the qd tier launches at hundreds of shapes (the ranks grow
                # sweep by sweep): one entry per (kernel, path), every shape
                # held bit for bit (max_abs_err over them), times and bound
                # at the shape that holds most of the path's work (launches
                # times the bound)
                shape = max(by, key=lambda sh: (by[sh] * checked[name][sh]["bound_us"], str(sh)))
                row = time_qd_row(dev, gen, name, shape, checked[name][shape])
                entries.append({
                    "name": name, "route": "cuda", "source": QD_KERNEL_SOURCE, "dtype": "qd",
                    "replaces": KERNEL_REPLACES[name], "path": path, "shape": row["shape"],
                    "shapes_on_path": len(by), "launches": sum(by.values()),
                    "launches_at_shape": by[shape],
                    "bound_ms_on_path": sum(by[sh] * checked[name][sh]["bound_us"]
                                            for sh in by) * 1e-3,
                    "max_abs_err": max(checked[name][sh]["max_abs_err"] for sh in by),
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "device_ms": row["device_us"] * 1e-3, "bound_ms": row["bound_us"] * 1e-3,
                    "bound_by": row["bound_by"], "library_ms": None})
                continue
            for shape, count in sorted(by.items()):
                row = checked[name][shape]
                f32 = shape[-1] == "f32"
                entries.append({
                    "name": name + ("_f32" if f32 else ""), "route": "cuda",
                    "source": DD_KERNEL_SOURCE if name in DD_KERNELS else KERNEL_SOURCE,
                    "dtype": "float32" if f32 else "float64",
                    "replaces": KERNEL_REPLACES[name], "path": path, "shape": row["shape"],
                    "launches": count, "launches_of_kernel_on_path": sum(by.values()),
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "device_ms": row["device_us"] * 1e-3, "bound_ms": row["bound_us"] * 1e-3,
                    "bound_by": row["bound_by"], "library_ms": row.get("library_ms")})
    missing = {(k, path) for path, need in [("C_6 headline", MAIN_PATH_KERNELS),
                                            ("C_256 long chain", LONG_CHAIN_KERNELS),
                                            ("mvn_d6 greedy", MVN_KERNELS),
                                            ("C_6 headline host_reeval", MAIN_PATH_KERNELS),
                                            ("mvn_d6 family", FAMILY_KERNELS),
                                            ("Greeks", MVN_KERNELS),
                                            ("C_6 capped + chunked", MAIN_PATH_KERNELS),
                                            ("stdnorm_d10 adaptive", MVN_KERNELS),
                                            ("quantics", ("score_residual_argmax",)),
                                            ("C_6 f32", [k + "_f32" for k in MAIN_PATH_KERNELS]),
                                            ("mvn_d6 f32", [k + "_f32" for k in MVN_KERNELS])]
                                           + [(path, need) for path, _, need in dd_paths]
                                           + [(path, need) for path, _, need in par_paths]
                                           + [(path, need) for path, _, need in qd_paths]
                                           + [(path, need) for path, _, need in drv_paths]
               for k in need if not any(e["name"] == k and e["path"] == path and e["launches"] > 0
                                        for e in entries)}
    if missing:
        raise AssertionError(f"kernels missing from their path's launches: {sorted(missing)}")
    unheld32 = {k + "_f32" for k in F32_KERNELS
                if not any(sh[-1] == "f32" for sh in checked[k])}
    if unheld32:
        raise AssertionError(f"f32 instantiations that phase 3 did not hold: {sorted(unheld32)}")
    _emit({"phase": "done", "script_elapsed_s": time.perf_counter() - T_START})
    print(smi, flush=True)
    _emit({"kernels": entries})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
