"""TT algebra on the main path: element evaluation and contraction.

Counterpart of ttcross_tpu/tt/ops.py (gather, value, full, contract; the
real-weight path of dtt_quad, dmrgg.f90:1323-1345).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .types import TT

__all__ = ["gather", "value", "full", "contract"]


def gather(t: TT, ind) -> torch.Tensor:
    """Batched element evaluation: ind (B, d) int -> values (B,)."""
    ind = torch.as_tensor(ind, device=t.device)
    squeeze = ind.dim() == 1
    if squeeze:
        ind = ind[None, :]
    v = torch.ones((ind.shape[0], 1), dtype=t.dtype, device=t.device)
    for c in range(t.d):
        g = t.cores[c][:, ind[:, c].long(), :]           # (r, B, r')
        v = torch.einsum("bi,ibj->bj", v, g)
    out = v[:, 0]
    return out[0] if squeeze else out


def value(t: TT, x, dd: int = 1) -> torch.Tensor:
    """Quantics-style evaluation of coordinates x in [0,1]^dd (dtt_value,
    tt.f90:702-728): each coordinate expands over d/dd modes by repeated
    base-n digit extraction, then the element is gathered."""
    x = torch.as_tensor(x, dtype=t.dtype, device=t.device)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    d, n = t.d, t.n
    mm = d // dd
    ind_cols = [None] * d
    for id_ in range(dd):
        xx = x[:, id_]
        xx = torch.where(xx > 1.0, xx - torch.floor(xx), xx)
        for j in range(mm):
            pos = id_ * mm + mm - 1 - j
            i = torch.floor(n[pos] * xx).long().clamp(max=n[pos] - 1)
            ind_cols[pos] = i
            xx = xx * n[pos] - i
    out = gather(t, torch.stack(ind_cols, dim=1))
    return out[0] if squeeze else out


def full(t: TT) -> torch.Tensor:
    """The dense tensor of shape n (for tests; exponential in d)."""
    out = t.cores[0][0]
    for c in range(1, t.d):
        out = torch.tensordot(out, t.cores[c], dims=([-1], [0]))
    return out[..., 0]


def contract(t: TT, weights: Sequence | None = None) -> torch.Tensor:
    """Contraction against real per-mode weight vectors (weights=None sums
    all entries), as a 0-d tensor on the train's device."""
    if weights is None:
        ws = [torch.ones(ni, dtype=t.dtype, device=t.device) for ni in t.n]
    else:
        ws = [torch.as_tensor(np.asarray(w) if not torch.is_tensor(w) else w,
                              dtype=t.dtype, device=t.device) for w in weights]
    v = torch.ones((1,), dtype=t.dtype, device=t.device)
    for g, w in zip(t.cores, ws):
        v = v @ torch.einsum("inj,n->ij", g, w)
    return v[0]
