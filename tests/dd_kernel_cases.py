"""Inputs and comparisons shared by the dd kernels' tests: the host
emulation's tests (tests/test_torch_dd_kernels.py,
tests/test_torch_dd_gather_dot_kernels.py) and the card's
(tests/test_torch_cuda_dd.py); ROWS_PLANS also by the qd tests of Q1.

Operands are made from a numpy Generator, so a case is the same on the CPU
and on the card; `dev` places them."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ttcross_tpu_torch.ops import kernels as K
from ttcross_tpu_torch.ops.dd import DD
from ttcross_tpu_torch.tt.types import TT

SRC = Path(__file__).resolve().parent.parent / "ttcross_tpu_torch" / "csrc" / "dd_kernels.cu"

SPECIALS = [0.0, -0.0, 5e-324, -2.5e-310, np.inf, -np.inf, np.nan, 2.0 ** 1000, -2.0 ** -1000,
            2.0 ** -1000, 1e-300]


# the rows a block D2 and Q1 take (csrc/ising_rows.cuh: 10 rows a warp),
# held by their host and card tests: one row, 7, a warp's rows, a warp and a
# part of the next, four warps' rows
ROWS_PLANS = [1, 7, 10, 13, 40]

_HOST_LIB = {}


def host_lib(tmp_path_factory):
    """csrc/dd_kernels.cu built for the host (-DTTD_HOST, -ffp-contract=off)
    under pytest's temporary directory and loaded, once a process; None
    without a host C++ compiler."""
    if "lib" not in _HOST_LIB:
        cxx = shutil.which("g++") or shutil.which("c++")
        lib = None
        if cxx is not None:
            out = tmp_path_factory.mktemp("ddhost") / "libddhost.so"
            subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                            "-DTTD_HOST", "-x", "c++", str(SRC), "-o", str(out)], check=True,
                           capture_output=True, text=True)
            lib = ctypes.CDLL(str(out))
        _HOST_LIB["lib"] = lib
    return _HOST_LIB["lib"]


def pair(gen, shape, dev="cpu", scale=1.0):
    """A DD of normal hi and lo about 2^-54 of it."""
    hi = gen.standard_normal(shape) * scale
    lo = hi * gen.standard_normal(shape) * 2.0 ** -54
    return DD(torch.as_tensor(hi).to(dev), torch.as_tensor(lo).to(dev))


def dd_map(f, x):
    return DD(f(x.hi), f(x.lo))


def bits_same(got, want):
    """Each part bit-equal, a signed zero too, NaN where the other has NaN."""
    for g, w in zip(got, want):
        g, w = g.reshape(-1), w.reshape(-1)
        gn, wn = torch.isnan(g), torch.isnan(w)
        if not torch.equal(gn, wn):
            return False
        z = torch.zeros_like(g)
        if not torch.equal(torch.where(gn, z, g).view(torch.int64),
                           torch.where(wn, z, w).view(torch.int64)):
            return False
    return True


def strew(gen, t, finite=False):
    """t with the special values (the finite ones) at random places."""
    vals = [v for v in SPECIALS if np.isfinite(v)] if finite else SPECIALS
    flat = t.reshape(-1)
    for k, pick in enumerate(gen.choice(flat.numel(), size=len(vals), replace=False)):
        flat[int(pick)] = vals[k]
    return t


def d4_operands(gen, layout, M, N, T, dev="cpu"):
    """(x, y) (M, N, T) as D4's callers give them: the _mm broadcast (A @ B),
    also with A a transposed view (the row pass's operand); value_mat's
    permuted core against weights broadcast over two axes; _contract_pairs'
    (1, r2, r) vector against m.T (M = 1); a general strided view of both."""
    if layout == "mm":
        a, b = pair(gen, (M, T), dev), pair(gen, (T, N), dev)
        return (dd_map(lambda t: t[:, None, :].expand(M, N, T), a),
                dd_map(lambda t: t.T[None].expand(M, N, T), b))
    if layout == "mm_t":
        a, b = pair(gen, (T, M), dev), pair(gen, (T, N), dev)
        return (dd_map(lambda t: t.T[:, None, :].expand(M, N, T), a),
                dd_map(lambda t: t.T[None].expand(M, N, T), b))
    if layout == "value":
        g, w = pair(gen, (M, T, N), dev), pair(gen, (T,), dev)
        return (dd_map(lambda t: t.permute(0, 2, 1), g),
                dd_map(lambda t: t[None, None].expand(M, N, T), w))
    if layout == "pairs":
        v, m = pair(gen, (1, T), dev), pair(gen, (T, N), dev)
        return dd_map(lambda t: t[:, None].expand(1, N, T), v), dd_map(lambda t: t.T[None], m)
    big_x, big_y = pair(gen, (2 * M, N + 3, 2 * T), dev), pair(gen, (T, N, 3 * M), dev)
    return (dd_map(lambda t: t[::2, 1:N + 1, ::2], big_x),
            dd_map(lambda t: t[:, :, ::3].permute(2, 1, 0), big_y))


def d4_specials(gen, dev="cpu"):
    """(x, y) of a (40, 30, 9) GEMM with the special values in the left
    factor, the finite ones in the right, and a row of -0 (its outputs +0
    after the scan's first add from (0, 0))."""
    M, N, T = 40, 30, 9
    a, b = pair(gen, (M, T), dev), pair(gen, (T, N), dev)
    a = DD(strew(gen, a.hi), strew(gen, a.lo))
    b = DD(strew(gen, b.hi, finite=True), b.lo)
    a.hi[5], a.lo[5] = -0.0, -0.0
    return (dd_map(lambda t: t[:, None, :].expand(M, N, T), a),
            dd_map(lambda t: t.T[None].expand(M, N, T), b))


def train(gen, ranks, n, dev="cpu", R=None, N=None):
    """A random f64 train with `ranks` and modes `n` (an int: every mode),
    packed (pack_tt) or, given R / N, zero-padded to a larger packed rank
    and mode."""
    d = len(ranks) - 1
    n = [n] * d if isinstance(n, int) else list(n)
    cores = tuple(torch.as_tensor(gen.standard_normal((ranks[c], n[c], ranks[c + 1]))).to(dev)
                  for c in range(d))
    packed = K.pack_tt(TT(cores))
    if R is None and N is None:
        return packed
    R, N = R or max(ranks), N or max(n)
    big = torch.zeros((d, R, N, R), dtype=torch.float64, device=dev)
    big[:, : packed.cores.shape[1], : packed.cores.shape[2], : packed.cores.shape[3]] = packed.cores
    return K.PackedTT(big, packed.ranks, packed.ranks_t, packed.n)


def indices(gen, B, n, dev="cpu", low=0, high=None):
    """(B, d) int32 indices, column c in [low, high or n[c])."""
    return torch.from_numpy(np.stack([gen.integers(low, high or m, B) for m in n], axis=1)).to(
        torch.int32).to(dev)


def d3_specials(gen, dev="cpu"):
    """A (1, 4, 5, 3, 1) train of modes 7 with signed zeros, subnormals and
    2^+-1000 in every core, inf and NaN in the last, and a slice of -0."""
    tt = train(gen, (1, 4, 5, 3, 1), 7, dev)
    for c in range(4):
        r, r2 = tt.ranks[c], tt.ranks[c + 1]
        vals = SPECIALS if c == 3 else [v for v in SPECIALS if np.isfinite(v)]
        for k, pick in enumerate(gen.choice(r * 7 * r2, size=len(vals), replace=False)):
            t, rest = divmod(int(pick), 7 * r2)
            tt.cores[c, t, rest // r2, rest % r2] = vals[k]
    tt.cores[0, 0, 6, :4] = -0.0
    return tt
