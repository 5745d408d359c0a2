"""Dense helpers on the main path.

Counterpart of the parts of ttcross_tpu/ops/dense.py that the f64 engines
use (:110-178, :335-380).  The one-hot split-f32 lookups and
power-of-2 range rescales that the TPU needed are not ported: the lookups
here are plain f64 gathers, and the small-table one runs on kernel B (the
Ising integrand does its own lookup inside its fused kernel).
"""

from __future__ import annotations

import torch

from .kernels import small_table_lookup

__all__ = ["table_lookup", "row_lookup", "batched_row_lookup",
           "masked_slot_write", "pow2_balance_mats", "balanced_matmul_chain",
           "scale_pow2"]


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


def batched_row_lookup(tabs, lin):
    """Rows of a stack of matrices: out[b, l, :] = tabs[b, lin[b, l], :]
    for tabs (B, M, K) and lin (B, L); lin (B,) gives (B, K)."""
    single = lin.dim() == 1
    if single:
        lin = lin[:, None]
    B, L = lin.shape
    out = tabs.gather(1, lin.long()[:, :, None].expand(B, L, tabs.shape[2]))
    return out[:, 0] if single else out


def masked_slot_write(buf, dim: int, slot, new, upd) -> None:
    """In place, for every p: buf[p]'s slot slot[p] along dim becomes new[p]
    where upd[p] and stays as it was elsewhere.

    buf (P, ...) with dim >= 1; slot (P,) int64 in range; new has buf's
    shape without dim; upd (P,) bool.  One slot per p, so no index repeats,
    and nothing here waits for the device (JAX: a one-hot where)."""
    shape = list(buf.shape)
    shape[dim] = 1
    lead = (-1,) + (1,) * (buf.dim() - 1)
    idx = slot.view(lead).expand(shape)
    old = buf.gather(dim, idx)
    buf.scatter_(dim, idx, torch.where(upd.view(lead), new.unsqueeze(dim), old))


def _scale_by_halves(x, biased):
    """x * 2**(biased - 2046) for an int64 tensor biased in [2, 4090]: two
    normal f64 factors made from exponent bits (exact on every device), of
    exponents floor and ceiling of half the shift, one after the other.  Both
    scale the same way, so no intermediate leaves the range between x and the
    result."""
    lo = biased >> 1
    x = x * (lo << 52).view(torch.float64)
    return x * ((biased - lo) << 52).view(torch.float64)


def scale_pow2(x, e):
    """x * 2**e for an integer-valued tensor e (int64, or a float holding
    integers; broadcast against x), exact wherever the result is
    representable.

    2**e itself leaves the f64 range beyond |e| = 1023, while the value
    chain of a long train balances matrices whose largest entry may be
    subnormal (e down to -1074) and ends on an exponent of either sign.  So
    the shift is applied as two in-range factors (_scale_by_halves).  Beyond
    |e| = 2044 the result of any normal x overflows or vanishes, as it does
    here."""
    return _scale_by_halves(x, e.to(torch.int64).clamp(-2044, 2044) + 2046)


def pow2_balance_mats(x):
    """Per-matrix exact power-of-2 rescale of a (K, R, R) stack: returns
    (x * 2^-e, e) with max|x * 2^-e| in [1, 2) and e int64 (zero or
    non-finite matrices pass through with e = 0).  The exponent is read
    from the bits (frexp), so it is the true floor(log2 max|x|), subnormal
    maxima included."""
    m = x.abs().amax(dim=(-2, -1))
    ok = (m > 0) & (m < float("inf"))                  # false for NaN too
    ex = torch.where(ok, torch.frexp(m).exponent.long(), 1)    # m = mantissa in [0.5, 1) * 2^ex
    return _scale_by_halves(x, (2047 - ex)[..., None, None]), ex - 1


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
