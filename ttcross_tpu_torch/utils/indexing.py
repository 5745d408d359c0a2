"""Multi-index arithmetic over TT mode grids.

Counterpart of ttcross_tpu/utils/indexing.py (ttind.f90: linear <->
multi-index conversion, :91-105; lexicographic comparison, sorted search
and insertion, :132-212).  The conversions are vectorized over (B, d) index
tensors (a tensor is worked on where it lies, an array-like goes to
``device``, the card by default); the lexicographic helpers are host-side
numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dense import as_tensor

__all__ = ["lin_to_multi", "multi_to_lin", "lex_compare", "lex_sort", "lex_find", "lex_push"]


def lin_to_multi(lin, n, device=None) -> torch.Tensor:
    """Linear index -> multi-index (0-based, first mode fastest, the
    reference's Fortran column-major convention, ttind.f90:91-105)."""
    lin = as_tensor(lin, device)
    out = []
    for nc in n:
        out.append(lin % int(nc))
        lin = lin // int(nc)
    return torch.stack(out, dim=-1)


def multi_to_lin(ind, n, device=None) -> torch.Tensor:
    ind = as_tensor(ind, device)
    n = np.asarray(n)
    stride = np.concatenate([[1], np.cumprod(n[:-1])]).astype(np.int64)
    return (ind.long() * torch.from_numpy(stride).to(ind.device)).sum(dim=-1)


def lex_compare(a, b) -> int:
    """-1 / 0 / +1 lexicographic comparison, last mode most significant
    (ttind comparison operators, ttind.f90:132-168)."""
    a, b = np.asarray(a), np.asarray(b)
    for c in range(a.shape[0] - 1, -1, -1):
        if a[c] != b[c]:
            return -1 if a[c] < b[c] else 1
    return 0


def lex_sort(inds) -> np.ndarray:
    inds = np.asarray(inds)
    return inds[np.lexsort(inds.T)]


def lex_find(sorted_inds, ind) -> int:
    """Binary search in a lexicographically sorted index list: the position
    of the match, or -1 (find, ttind.f90:170-196)."""
    lo, hi = 0, len(sorted_inds)
    while lo < hi:
        mid = (lo + hi) // 2
        c = lex_compare(sorted_inds[mid], ind)
        if c == 0:
            return mid
        if c < 0:
            lo = mid + 1
        else:
            hi = mid
    return -1


def lex_push(sorted_inds, ind) -> np.ndarray:
    """Insert keeping lexicographic order, dropping duplicates (push,
    ttind.f90:198-212)."""
    sorted_inds = np.asarray(sorted_inds)
    if len(sorted_inds) and lex_find(sorted_inds, ind) >= 0:
        return sorted_inds
    out = np.concatenate([sorted_inds.reshape(-1, len(ind)), np.asarray(ind)[None]], axis=0)
    return lex_sort(out)
