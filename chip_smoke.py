#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ttcross_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the check: build, kernels, main path
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of
                                     # one steady headline run
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
     and at C_256's (100584, 255), one kernel per call;
  4. the main path: the f64 cross on the Ising C_6 integrand at rank 24
     with oversample=6 (bench.py's headline configuration) on the card,
     twice with key 0 (first and steady time; the kernels' launch counts
     of the first run: kernel A and the fused integrand must have
     launched; the standalone lookup, off this path, is reported), then
     keys 1-7; the digits against the analytic
     C_6; the rounding of each key's rank-30 train on the card against
     the same rounding on the host; and a small C_5 cross on the card
     against the same cross on the CPU, with rook and with full pivoting
     (kernel A's 2-D path);
  5. the greedy (no oversample) C_6 cross, holding its state on the card.
The line before the last is the kernels' JSON summary; the last line is
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


def kernel_cases(dev, gen):
    """Kernel A's and kernel B's inputs: the main path's shapes (the rook
    passes, the integrand's batches) and the larger ones of full pivoting
    and long chains."""
    import torch

    R, N, B = 30, 65, 1950            # the headline's padded rank and mode size
    a = [(name, _score_inputs(gen, M, Kc, Rr, dev)) for name, M, Kc, Rr in
         [("col_pass", B, 1, R), ("row_pass", 1, B, R), ("superblock", B, B, R),
          ("random", 8192, 8192, 32), ("long_col", 100000, 1, R), ("long_row", 1, 70001, R)]]
    b = []
    for name, Bb, d, n in [("rook_fiber", B, 5, N), ("lottery", 190, 5, N),
                           ("init_diag", 520, 5, N), ("init_fibers", 325, 5, N),
                           ("long_chain", 100584, 255, 33)]:
        tables = torch.randn((2, n), generator=gen, dtype=torch.float64).to(dev)
        ind = torch.randint(-2, n + 2, (Bb, d), generator=gen, dtype=torch.int32).to(dev)
        b.append((name, (tables, ind)))
    return a, b


def integrand_cases(dev, gen):
    """The fused integrand's inputs: the headline's four batch shapes (C_6,
    n = 65), the rook fiber's at D_6 and E_6, and C_256's long chain at
    n = 33; tables from make_ising, indices in range but for two rows."""
    import torch

    from ttcross_tpu_torch.apps import make_ising

    cases = []
    for name, kind, m, n, B in [("rook_fiber", "C", 6, 64, 1950), ("lottery", "C", 6, 64, 190),
                                ("init_diag", "C", 6, 64, 520), ("init_fibers", "C", 6, 64, 325),
                                ("rook_fiber_D", "D", 6, 64, 1950),
                                ("rook_fiber_E", "E", 6, 64, 1950),
                                ("long_chain", "C", 256, 33, 100584)]:
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

    rows, abs_err = [], 0.0
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
        abs_err = max(abs_err, row["max_abs_err"])
    return rows, abs_err


def check_kernels(dev, a_cases, b_cases):
    """Phase 3: kernel vs plain on the card, with times, bounds and shares."""
    import torch

    from ttcross_tpu_torch.ops import kernels as K

    a_err, a_rows = 0.0, []
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
        a_err = max(a_err, err)
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
        if not torch.equal(got, want):
            raise AssertionError(f"kernel B {name}: not bitwise equal to the plain version")
        inside = ind.clamp(0, n - 1)   # the library gather takes in-range indices only
        flat = inside.view(-1)
        if not torch.equal(K.small_table_lookup(tables, inside).view(L, -1),
                           torch.index_select(tables, 1, flat)):
            raise AssertionError(f"kernel B {name}: index_select disagrees")
        dev_k = device_per_call(lambda: K.small_table_lookup(tables, ind))
        dev_l = device_per_call(lambda: torch.index_select(tables, 1, flat))
        bound, by = _lookup_bound(L, ind.numel(), n)
        row = {"kernel": "small_table_lookup", "shape": [L, *ind.shape, n], "case": name,
               "max_abs_err": 0.0,
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
    return a_rows, a_err, b_rows


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
    ising_integrand at the rook fiber's shape and at C_256's (e.g. the
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
               (ind, tables, kind)) for c, kind, tables, ind in (i_cases[0], i_cases[-1])]
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
    return {"phase": "small_vs_cpu", **rows}


def profile_headline(dev) -> None:
    """torch.profiler over one steady headline run: kernel time by name and
    the device's busy share of the run's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_headline(dev, oversample=6)
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    print(avgs.table(sort_by="self_cuda_time_total", row_limit=30), flush=True)
    # device kernels only: an aten op's self device time repeats its kernels'
    kernels = [e for e in avgs if "CUDA" in str(getattr(e, "device_type", ""))]
    busy_us = sum(_device_us(e) for e in kernels)
    _emit({"phase": "profile", "wall_s": wall, "device_busy_s": busy_us * 1e-6,
           "device_busy_share": busy_us * 1e-6 / wall,
           "kernel_launches": sum(e.count for e in kernels),
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
    a_rows, a_err, b_rows = check_kernels(dev, a_cases, b_cases)
    i_rows, i_err = check_integrand(i_cases)
    args = sys.argv[1:]
    if "--parent" in args:
        _emit(compare_with(args[args.index("--parent") + 1], a_cases, b_cases, i_cases))
    del a_cases, b_cases, i_cases

    K.reset_launch_counts()
    res, first, digits = run_headline(dev, oversample=6)
    launches = K.launch_counts()
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
           "steady_launches": steady_launches, "digits_by_key": by_key,
           "median_digits": median})
    if "--profile" in args:
        profile_headline(dev)
    if median < DIGITS_MEDIAN or min(by_key) < DIGITS_FLOOR:
        raise AssertionError(f"headline digits over keys {by_key}: median {median} < "
                             f"{DIGITS_MEDIAN} or a key < {DIGITS_FLOOR}")
    # the headline's integrand runs on the fused kernel, so the standalone
    # lookup (the chain lift's) is reported, at 0, and not required
    if min(launches[k] for k in MAIN_PATH_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")
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

    def summary(row, launched, err):
        return {"launches": launched, "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "device_ms": row["device_us"] * 1e-3,
                "bound_ms": row["bound_us"] * 1e-3, "bound_us": row["bound_us"],
                "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
                "shape": row["shape"]}

    print(smi, flush=True)
    _emit({"kernels": [
        {"name": "score_residual_argmax", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "ttcross_tpu/ops/pallas_kernels.py:62",
         **summary(a_rows[0], launches["score_residual_argmax"], a_err)},
        {"name": "small_table_lookup", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "ttcross_tpu/ops/pallas_kernels.py:151",
         **summary(b_rows[0], launches["small_table_lookup"], 0.0)},
        {"name": "ising_integrand_fused", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "ttcross_tpu/ops/pallas_kernels.py:151",
         **summary(i_rows[0], launches["ising_integrand_fused"], i_err)},
    ]})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
