#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ttcross_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the check: build, kernels, main path
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of
                                     # one steady headline run, of the
                                     # steady long-chain runs, of the long
                                     # chain's parts per call, of the MVN
                                     # runs and of a maxvol sweep's parts
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
     the maxvol fiber crosses (26000, 6) and (43940, 6));
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
     lookup) and kernel A must have launched, at shapes that phase 3 held.
The line before the last is the kernels' JSON summary, one entry for every
(kernel, shape) that the C_6 headline, the C_256 long chain and each
configuration of phase 7 launched at, with that run's launches at the shape
beside phase 3's error, times and bound there; the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero.
It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

KERNEL_SOURCE = "ttcross_tpu_torch/csrc/kernels.cu"
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
KERNEL_REPLACES = {   # the TPU kernel each CUDA kernel stands for
    "score_residual_argmax": "ttcross_tpu/ops/pallas_kernels.py:62",
    "score_residual_argmax_batched": "ttcross_tpu/ops/pallas_kernels.py:62",
    "small_table_lookup": "ttcross_tpu/ops/pallas_kernels.py:151",
    "ising_integrand_fused": "ttcross_tpu/ops/pallas_kernels.py:151",
}
SCORE_RTOL = 1e-12          # kernel A vs cuBLAS: f64 sums in another order
                            # (the 2-D path's DMMA tiles in yet another)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, 700 W
F64_FLOPS = 67e12           # ... f64 on the tensor cores, the card's f64 peak


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


def _score_inputs(gen, M, K, R, dev):
    """Random kernel-A inputs whose best score is clear of the second best
    by more than rounding (so the index is well defined)."""
    import torch

    while True:
        vals = torch.randn((M, K), generator=gen, dtype=torch.float64).to(dev)
        colf = torch.randn((M, R), generator=gen, dtype=torch.float64).to(dev)
        rowf = torch.randn((R, K), generator=gen, dtype=torch.float64).to(dev)
        mask = (torch.rand((M, K), generator=gen) > 0.2).to(dev)
        resid = (vals - colf @ rowf).abs()
        top = torch.topk(torch.where(mask, resid, -1.0).reshape(-1), 2).values
        if float(top[0] - top[1]) > 1e-9 * float(top[0]):
            return vals, colf, rowf, mask


def _bound_us(nbytes: int, flops: int):
    """The least time the card could take: bytes over the memory rate or
    flops over the f64 peak, whichever is larger, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F64_FLOPS
    return max(t_bytes, t_ops) * 1e6, ("bytes" if t_bytes >= t_ops else "operations")


def _score_bound(M, K, R):
    # vals, colf, rowf and the mask read once; three 8-byte results written
    return _bound_us(8 * (M * K + M * R + R * K) + M * K + 24, 2 * M * K * R)


def _batched_bound(P, M, K, R):
    # per bond: vals, colf, rowf and the mask read once, three 8-byte results written
    return _bound_us(P * (8 * (M * K + M * R + R * K) + M * K + 24), 2 * P * M * K * R)


def _lookup_bound(L, E, n):
    # the tables and the int32 indices read once, L f64 outputs per index
    return _bound_us(8 * L * n + 4 * E + 8 * L * E, 0)


def _integrand_bound(kind, B, d, n):
    # the int32 indices and the (2, n) table read once, one f64 per row
    # written; per variable a prefix product and a weight product, for C
    # and D also the prefix sum and the suffix product and sum; for D and
    # E five operations per pair i < j (difference, sum, ratio, square,
    # product); four per row to combine
    per_row = 2 * d + (3 * d if kind in "CD" else 0) + (5 * d * (d + 1) // 2 if kind in "DE" else 0)
    return _bound_us(4 * B * d + 16 * n + 8 * B, B * (per_row + 4))


def _integrand_rtol(kind, d, on_card):
    """Fused kernel vs plain, per value.  The row path (d <= 8) keeps the
    order of the plain version on the CPU: a few ulps.  The plain version on
    the card forms its prefix products as a tree (torch's CUDA cumprod),
    and the a-term's ratios of nearby prefix products (P_j / P_i up to
    1 - 3e-4 at n = 65) magnify its one-ulp differences ~3000-fold, so D
    and E are held to it at 1e-11.  The warp path's tree scans give C's
    sums of prefix products to 1e-12 and D's and E's products of ~d^2/2
    ratios to 1e-10."""
    if d <= 8:
        return 1e-11 if on_card and kind != "C" else 1e-14
    return 1e-12 if kind == "C" else 1e-10


def _rel_errs(got, want, rtol):
    """(max |got - want|, max relative error over want != 0, within rtol per
    value); a zero of want must be a zero of got."""
    diff = (got - want).abs()
    nz = want != 0
    rel = float((diff[nz] / want[nz].abs()).max()) if bool(nz.any()) else 0.0
    return float(diff.max()), rel, bool((diff <= rtol * want.abs()).all())


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


def device_per_call(fn, calls: int = 50, tries: int = 3) -> dict:
    """Device-only time and kernels per call of fn (torch.profiler over
    `calls` back-to-back calls after one warm-up): the CUDA-event times
    include the host's launch overhead, which these leave out.  The
    profiler now and then records no device event at all for such a
    window (seen once in some 200 windows on an H100), so an empty window is
    profiled again, up to `tries` times."""
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
            "by_kernel_us": {e.key[:60]: _device_us(e) / calls for e in kern}}


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
    rank 8 on its 33-point rule, and the small run against the CPU (d = 4,
    n = 17, ranks 6 and 8)."""
    a, b = [], []
    for d, N, R, n, mv in [(6, 65, 20, 65, True), (6, 65, 26, 65, True), (10, 33, 8, 33, False),
                           (4, 17, 6, 17, True), (4, 17, 8, 17, False)]:
        sa, sb = mvn_shapes(d, N, R, mv)
        for shape in sa:
            if shape not in a:
                a.append(shape)
        for shape in sb:
            if (*shape, n) not in b:
                b.append((*shape, n))
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
        got = K.ising_integrand_fused(tables, ind, kind)
        want = K.ising_integrand_plain(tables, ind, kind)
        torch.cuda.synchronize()
        err = {}
        for where, w in (("card", want), ("cpu", K.ising_integrand_plain(tables.cpu(), ind.cpu(), kind))):
            rtol = _integrand_rtol(kind, d, where == "card")
            err[where] = _rel_errs(got.cpu(), w.cpu(), rtol)
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
        bound, by = _integrand_bound(kind, B, d, n)
        row = {"kernel": "ising_integrand_fused", "kind": kind, "shape": [B, d, n],
               "case": name, "max_abs_err": err["card"][0],
               "max_rel_err_vs_card_plain": err["card"][1],
               "max_rel_err_vs_cpu_plain": err["cpu"][1],
               "rtol_card": _integrand_rtol(kind, d, True),
               "rtol_cpu": _integrand_rtol(kind, d, False),
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
        got = K.score_residual_argmax(*args)
        want = K.score_residual_argmax_plain(*args)
        torch.cuda.synchronize()
        gi, gs, gr = (float(x) for x in got)
        wi, ws, wr = (float(x) for x in want)
        if int(gi) != int(wi):
            raise AssertionError(f"kernel A {name}: index {int(gi)} != plain {int(wi)}")
        err = max(abs(gs - ws), abs(gr - wr))
        if err > SCORE_RTOL * abs(ws):
            raise AssertionError(f"kernel A {name}: score {gs} vs plain {ws}")
        dev_k = device_per_call(lambda: K.score_residual_argmax(*args))
        dev_p = device_per_call(lambda: K.score_residual_argmax_plain(*args))
        bound, by = _score_bound(M, Kc, Rr)
        fiber = M == 1 or Kc == 1
        if fiber and not 0 < dev_k["kernels_per_call"] <= 1:
            raise AssertionError(f"kernel A {name}: {dev_k['kernels_per_call']} kernels "
                                 "per fiber call (one is the design)")
        row = {"kernel": "score_residual_argmax", "shape": [M, Kc, Rr],
               "case": name, "index": int(gi), "max_abs_err": err,
               "ms": _time_ms(lambda: K.score_residual_argmax(*args)),
               "plain_ms": _time_ms(lambda: K.score_residual_argmax_plain(*args)),
               "device_us": dev_k["device_us"], "kernels_per_call": dev_k["kernels_per_call"],
               "by_kernel_us": dev_k["by_kernel_us"],
               "plain_device_us": dev_p["device_us"], "bound_us": bound, "bound_by": by,
               "share_of_bound": bound / dev_k["device_us"],
               "l2": "warm: back-to-back calls" if 8 * M * Kc < 40e6 else "exceeds L2"}
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
        bound, by = _lookup_bound(L, ind.numel(), n)
        row = {"kernel": "small_table_lookup", "shape": [L, *ind.shape, n], "case": name,
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


def check_batched(dev, gen):
    """Phase 3, kernel A batched over bonds at the long chain's shapes, half
    of the bonds fully masked (a red-black phase's dead parity): the plain
    version's indices, scores and residuals within BATCHED_RTOL of the
    largest residual, and the bits of one single-fiber launch per bond; one
    kernel per call; times, bound and share.  No single PyTorch call
    computes it, so it has no library yardstick."""
    import torch

    from ttcross_tpu_torch.ops import kernels as K

    rows = []
    for name, P, M, Kc, R in [("col_pass_c256", 254, 170, 1, 10), ("row_pass_c256", 254, 1, 170, 10),
                              ("col_pass_c1024", 1022, 170, 1, 10),
                              ("row_pass_c1024", 1022, 1, 170, 10),
                              ("col_one_bond", 1, 170, 1, 10), ("row_one_bond", 1, 1, 170, 10)]:
        vals, colf, rowf = (torch.randn(sh, generator=gen, dtype=torch.float64).to(dev)
                            for sh in ((P, M, Kc), (P, M, R), (P, R, Kc)))
        mask = (torch.rand((P, M, Kc), generator=gen) > 0.2).to(dev)
        mask[1::2] = False
        args = (vals, colf, rowf, mask)
        got = K.score_residual_argmax_batched(*args)
        want = K.score_residual_argmax_batched_plain(*args)
        single = [K.score_residual_argmax(*(a[p] for a in args)) for p in range(P)]
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"batched kernel A {name}: indices differ from the plain version's")
        scale = float(want[2].abs().max())
        err = max(float((g - w).abs().max()) for g, w in zip(got[1:], want[1:]))
        if err > BATCHED_RTOL * scale:
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
        bound, by = _batched_bound(P, M, Kc, R)
        row = {"kernel": "score_residual_argmax_batched", "shape": [P, M, Kc, R], "case": name,
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
    lib_path, nvcc_s, report = _build.build()
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
    # phase 3's row of every (kernel, shape) it held against the plain version
    # (the first at a shape: the integrand's kind C, which every driven run uses)
    checked = {name: {tuple(r["shape"]): r for r in reversed(rows)} for name, rows in
               [("score_residual_argmax", a_rows), ("score_residual_argmax_batched", ab_rows),
                ("small_table_lookup", b_rows), ("ising_integrand_fused", i_rows)]}
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
    by_key = [dg for _, dg in runs]
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

    # one entry for every (kernel, shape) that a path's run launched at: the
    # launches are those of that run, counted from 0 (the C_6 headline's
    # first run, the C_256 long chain's, the first run of each configuration
    # of the MVN / COS phase); the error, the times and the bound are those of
    # phase 3's check of the kernel at that shape
    entries = []
    for path, by_kernel in [("C_6 headline", shapes), ("C_256 long chain", lc_shapes)] + mvn_runs:
        for name, by in sorted(by_kernel.items()):
            for shape, count in sorted(by.items()):
                row = checked[name][shape]
                entries.append({
                    "name": name, "route": "cuda", "source": KERNEL_SOURCE,
                    "replaces": KERNEL_REPLACES[name], "path": path, "shape": row["shape"],
                    "launches": count, "launches_of_kernel_on_path": sum(by.values()),
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "device_ms": row["device_us"] * 1e-3, "bound_ms": row["bound_us"] * 1e-3,
                    "bound_by": row["bound_by"], "library_ms": row.get("library_ms")})
    missing = {(k, path) for path, need in [("C_6 headline", MAIN_PATH_KERNELS),
                                            ("C_256 long chain", LONG_CHAIN_KERNELS),
                                            ("mvn_d6 greedy", MVN_KERNELS)]
               for k in need if not any(e["name"] == k and e["path"] == path and e["launches"] > 0
                                        for e in entries)}
    if missing:
        raise AssertionError(f"kernels missing from their path's launches: {sorted(missing)}")
    print(smi, flush=True)
    _emit({"kernels": entries})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
