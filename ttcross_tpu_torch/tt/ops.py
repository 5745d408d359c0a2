"""TT algebra: element evaluation, contraction and structural operations.

Counterpart of ttcross_tpu/tt/ops.py (tt.f90's generic interfaces tijk /
value / sumall / dot / norm / + / * / group, tt.f90:54-124; dtt_quad and
ztt_quad, dmrgg.f90:1323-1345, 1418-1523).  The card has complex128, so a
contraction against complex weights, or of a complex-cored train, runs in
complex128 on the train's device: the JAX package's (re, im) pair chain
and its host branch for complex cores have no counterpart here.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.dense import as_tensor, scale_pow2
from .types import TT

__all__ = ["gather", "value", "full", "sumall", "contract", "dot", "norm",
           "add", "scale", "hadamard", "group"]


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
    """Contraction against per-mode weight vectors (weights=None sums all
    entries), as a 0-d tensor on the train's device (local part of
    dtt_quad / ztt_quad).  The result has the promoted dtype of the cores
    and the weights: complex128 as soon as either is complex."""
    if weights is None:
        ws = [torch.ones(ni, dtype=t.dtype, device=t.device) for ni in t.n]
    else:
        ws = [as_tensor(w, t.device) for w in weights]
    dt = t.dtype
    for w in ws:
        dt = torch.promote_types(dt, w.dtype)
    v = torch.ones((1,), dtype=dt, device=t.device)
    for g, w in zip(t.cores, ws):
        v = v @ torch.einsum("inj,n->ij", g.to(dt), w.to(dt))
    return v[0]


def sumall(t: TT) -> torch.Tensor:
    return contract(t, None)


def dot(a: TT, b: TT) -> torch.Tensor:
    """Inner product <a, b> via the two-sided core contraction (dtt_dot,
    tt.f90:1155-1175); a is conjugated where it is complex."""
    if a.n != b.n:
        raise ValueError(f"mode mismatch: {a.n} vs {b.n}")
    dt = torch.promote_types(a.dtype, b.dtype)
    x = torch.ones((1, 1), dtype=dt, device=a.device)
    for ga, gb in zip(a.cores, b.cores):
        x = torch.einsum("inj,ik,knl->jl", ga.conj().to(dt), x, gb.to(dt))
    return x[0, 0]


def norm(a: TT) -> torch.Tensor:
    """Frobenius norm, sqrt(<a, a>) with every core first rescaled by the
    exact power of 2 that brings its largest entry into [1, 2), so that long
    trains neither overflow nor vanish.  The exponents are summed on the
    device (no host read per core, unlike the JAX package's log
    bookkeeping)."""
    cores, ex = [], torch.zeros((), dtype=torch.int64, device=a.device)
    for c in a.cores:
        m = c.abs().max()
        ok = (m > 0) & (m < float("inf"))
        e = torch.where(ok, torch.frexp(m).exponent.long() - 1, 0)
        # a complex core scales through its (re, im) view
        flat = torch.view_as_real(c) if c.is_complex() else c
        flat = scale_pow2(flat, -e)
        cores.append(torch.view_as_complex(flat) if c.is_complex() else flat)
        ex = ex + e
    t = TT(tuple(cores))
    return scale_pow2(torch.sqrt(dot(t, t).abs()), ex)


def _block_cat(ga, gb, shared_left: bool, shared_right: bool):
    """[ga gb] along the unshared ranks: side by side where the left rank
    is shared, stacked where the right one is, block diagonal otherwise."""
    if shared_left:
        return torch.cat([ga, gb], dim=2)
    if shared_right:
        return torch.cat([ga, gb], dim=0)
    top = torch.cat([ga, ga.new_zeros((ga.shape[0], ga.shape[1], gb.shape[2]))], dim=2)
    bot = torch.cat([gb.new_zeros((gb.shape[0], gb.shape[1], ga.shape[2])), gb], dim=2)
    return torch.cat([top, bot], dim=0)


def add(a: TT, b: TT) -> TT:
    """Rank-padded sum (dtt_plus_dtt, tt.f90:928-965)."""
    if a.n != b.n:
        raise ValueError("mode mismatch")
    d = a.d
    dt = torch.promote_types(a.dtype, b.dtype)
    if d == 1:
        return TT((a.cores[0].to(dt) + b.cores[0].to(dt),))
    return TT(tuple(_block_cat(a.cores[c].to(dt), b.cores[c].to(dt), c == 0, c == d - 1)
                    for c in range(d)))


def scale(a: TT, c) -> TT:
    """Scalar multiply, applied to the first core (dtt_mul_dt, tt.f90:989-998)."""
    c = c if torch.is_tensor(c) else torch.as_tensor(c)
    dt = torch.promote_types(a.dtype, c.dtype)
    cores = tuple(g.to(dt) for g in a.cores)
    return TT((cores[0] * c.to(device=a.device, dtype=dt),) + cores[1:])


def hadamard(a: TT, b: TT) -> TT:
    """Elementwise product via Kronecker products of the ranks."""
    if a.n != b.n:
        raise ValueError("mode mismatch")
    cores = []
    for ga, gb in zip(a.cores, b.cores):
        g = torch.einsum("inj,knl->iknjl", ga, gb)
        cores.append(g.reshape(ga.shape[0] * gb.shape[0], ga.shape[1],
                               ga.shape[2] * gb.shape[2]))
    return TT(tuple(cores))


def group(grp: TT, arg: TT, side: int | None = None) -> TT:
    """Block-diagonal concatenation grp <- [grp arg] (dtt_group,
    tt.f90:527-575).  side=0 shares the right border rank, side=1 the left."""
    if grp.n != arg.n:
        raise ValueError("mode mismatch")
    d = grp.d
    r = grp.r
    if side is None:
        side = 0 if r[0] >= r[d] else 1
    dt = torch.promote_types(grp.dtype, arg.dtype)
    cores = []
    for c in range(d):
        left_shared = side == 1 and c == 0
        right_shared = side == 0 and c == d - 1
        if left_shared and right_shared:
            raise ValueError("cannot group a single-core train")
        cores.append(_block_cat(grp.cores[c].to(dt), arg.cores[c].to(dt),
                                left_shared, right_shared))
    return TT(tuple(cores))
