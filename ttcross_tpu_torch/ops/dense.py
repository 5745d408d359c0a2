"""Dense helpers on the main path.

Counterpart of the parts of ttcross_tpu/ops/dense.py that the sequential
f64 engine uses (:110-163, :335-380).  The one-hot split-f32 lookups and
power-of-2 range rescales that the TPU needed are not ported: the lookups
here are plain f64 gathers, and the small-table one runs on kernel B (the
Ising integrand does its own lookup inside its fused kernel).
"""

from __future__ import annotations

import torch

from .kernels import small_table_lookup

__all__ = ["table_lookup", "row_lookup", "pow2_balance_mats",
           "balanced_matmul_chain", "exact_pow2"]


def table_lookup(table, ind):
    """out[...] = table[ind] for a small f64 table, 0 out of range.

    table (n,) or (L, n); ind (B, d) int32.  Returns (B, d), or (L, B, d)
    for L stacked tables: all L come from one kernel-B launch on CUDA."""
    if table.dim() == 1:
        return small_table_lookup(table[None], ind)[0]
    return small_table_lookup(table, ind)


def row_lookup(mat, lin, axis: int = 0):
    """Rows (axis=0) or columns (axis=1) of a 2-D matrix as rows:
    out[b, :] = mat[lin[b], :] or mat[:, lin[b]]."""
    if axis == 0:
        return mat[lin]
    return mat[:, lin].T


def exact_pow2(e):
    """2**e for an integer-valued float tensor e (torch.ldexp)."""
    return torch.ldexp(torch.ones_like(e), e)


def pow2_balance_mats(x):
    """Per-matrix exact power-of-2 rescale of a (K, R, R) stack: returns
    (x * 2^-e, e) with max|x * 2^-e| near 1 (zero or non-finite matrices
    pass through with e = 0)."""
    m = x.abs().amax(dim=(-2, -1))
    ok = (m > 0) & torch.isfinite(m)
    e = torch.floor(torch.log2(torch.where(ok, m, torch.ones_like(m))))
    e = torch.where(torch.isfinite(e), e, torch.zeros_like(e))
    return x * exact_pow2(-e)[..., None, None], e


def balanced_matmul_chain(mats):
    """Ordered product of a (K, R, R) stack as a log2(K)-depth pairwise
    tree with an exact power-of-2 rebalance per level.  Returns (P, e) with
    mats[0] @ ... @ mats[K-1] = P * 2^e and max|P| ~ 1, so long chains
    whose partial products leave the f64 range stay representable."""
    K, R = mats.shape[0], mats.shape[-1]
    mats, ex = pow2_balance_mats(mats)
    P = 1 << max(K - 1, 1).bit_length()        # next power of two >= K
    if P > K:
        eye = torch.eye(R, dtype=mats.dtype, device=mats.device)
        mats = torch.cat([mats, eye.expand(P - K, R, R)], dim=0)
        ex = torch.cat([ex, ex.new_zeros(P - K)])
    while mats.shape[0] > 1:
        prod, e = pow2_balance_mats(mats[0::2] @ mats[1::2])
        mats, ex = prod, ex[0::2] + ex[1::2] + e
    return mats[0], ex[0]
