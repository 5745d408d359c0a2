"""Pivot index-chain reconstruction.

Counterpart of ttcross_tpu/cross/chains.py (:27-214).  Each sampled entry
at bond p is a tuple (i, j, k, q): i links into bond p-1's pivots, j and k
are the mode indices of cores p and p+1, q links into bond p+1's pivots.
The left (right) table of a bond holds, for every link value, the mode
indices of the row (column) chain it enters; candidates then gather from
the tables.  vip[b, s] = (i, j, k, q) of pivot s of bond b.  Tables and
assembled indices are int32 like vip; index arguments may be any integer
dtype.  The sequential engine loops over bonds in Python and passes the
bond p as an int; the all-bonds-batched sweeps pass a tensor of bonds to
assemble_indices and take every bond's tables from all_left_tables /
all_right_tables, which loop over log2(d) levels, not over bonds.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["left_table", "right_table", "advance_left", "advance_right",
           "all_left_tables", "all_right_tables", "pivot_index_sets",
           "assemble_indices"]


def left_table(vip, p: int, d: int) -> torch.Tensor:
    """tab[t, s] = index of mode s (s < p) on the row chain entered with
    link t at bond p-1; shape (R, d), columns >= p zero."""
    R = vip.shape[1]
    tab = torch.zeros((R, d), dtype=vip.dtype, device=vip.device)
    t = torch.arange(R, device=vip.device)
    for s in range(p - 1, -1, -1):
        vs = vip[s][t]                   # (R, 4)
        tab[:, s] = vs[:, 1]
        t = vs[:, 0].long()
    return tab


def right_table(vip, p: int, d: int) -> torch.Tensor:
    """tab[t, s] = index of mode s (s > p+1) on the column chain entered
    with link t at bond p+1; shape (R, d)."""
    R = vip.shape[1]
    tab = torch.zeros((R, d), dtype=vip.dtype, device=vip.device)
    t = torch.arange(R, device=vip.device)
    for s in range(p + 1, d - 1):       # bond s writes mode s+1
        vs = vip[s][t]
        tab[:, s + 1] = vs[:, 2]
        t = vs[:, 3].long()
    return tab


def advance_left(ltab, vip_p, p: int) -> torch.Tensor:
    """Left table of bond p+1 from bond p's: ltab[vip_p[t, 0]] with column
    p set to vip_p[t, 1].  ltab (..., R, d) and vip_p (..., R, 4): a
    leading lane axis advances every lane's table."""
    nt = torch.take_along_dim(ltab, vip_p[..., 0:1].long(), dim=-2)
    nt[..., p] = vip_p[..., 1]
    return nt


def advance_right(rtab, vip_p1, p: int) -> torch.Tensor:
    """Right table of bond p from bond p+1's: rtab[vip_p1[t, 3]] with
    column p+2 set to vip_p1[t, 2] (p+2 < d; p = -1 writes column 1);
    lane axes as advance_left."""
    nt = torch.take_along_dim(rtab, vip_p1[..., 3:4].long(), dim=-2)
    nt[..., p + 2] = vip_p1[..., 2]
    return nt


def _scan_tables(vip, d: int, left: bool) -> torch.Tensor:
    """The inclusive compositions of the per-bond table operators, as
    their (d-1, R, d) overlays, by pointer doubling.

    Bond p acts on a table as A_p(tab) = tab[g_p] with column c_p
    overwritten by v_p: for the left tables (g, v, c) = (vip[p, :, 0],
    vip[p, :, 1], p), for the right ones (vip[p, :, 3], vip[p, :, 2],
    p + 1).  A run of bonds is again such an operator (g, w), w holding the
    columns the run writes and 0 elsewhere; distinct bonds write distinct
    columns, so "u, then v" is (g_u[g_v], w_v + w_u[g_v]).  Level s of the
    scan composes every run with the run s bonds before it (left: the
    earlier bonds act first) or after it (right: the later bonds act
    first); the values are integers, so any order of composition is exact
    (JAX: lax.associative_scan of the same operators).  vip (d-1, ..., R,
    4): lane axes after the bond axis scan every lane at once."""
    nb = d - 1
    ps = torch.arange(nb, device=vip.device)
    g = vip[..., 0 if left else 3].long()                            # (nb, ..., R)
    w = torch.zeros(g.shape + (d,), dtype=vip.dtype, device=vip.device)
    w[ps, ..., ps + (0 if left else 1)] = vip[..., 1 if left else 2]
    shift = 1
    while shift < nb:
        first = slice(0, nb - shift) if left else slice(shift, nb)   # acts first
        second = slice(shift, nb) if left else slice(0, nb - shift)
        gs = g[second]
        w_new, g_new = w.clone(), g.clone()
        w_new[second] += w[first].gather(-2, gs[..., None].expand(*gs.shape, d))
        g_new[second] = g[first].gather(-1, gs)
        w, g = w_new, g_new
        shift *= 2
    return w


def all_left_tables(vip, d: int) -> torch.Tensor:
    """LT (d-1, R, d): the left table of every bond; LT[p] is what bonds
    0..p-1 write into an empty table, in log2(d) levels.  A lane state's
    vip (d-1, L, R, 4) gives (d-1, L, R, d)."""
    W = _scan_tables(vip, d, left=True)
    return torch.cat([torch.zeros_like(W[:1]), W[:-1]])


def all_right_tables(vip, d: int) -> torch.Tensor:
    """RT (d-1, R, d): the right table of every bond (RT[d-2] = 0); RT[p]
    is what bonds d-2..p+1 write into an empty table."""
    W = _scan_tables(vip, d, left=False)
    return torch.cat([W[1:], torch.zeros_like(W[:1])])


def pivot_index_sets(vip, rk):
    """Host-side decode of the pivot chains into explicit index sets:
    I[b] = list of left prefix tuples (modes 0..b), J[b] = right suffix
    tuples (modes b+1..d-1) for every bond b.  vip and rk are read from
    their device once."""
    vip = vip.cpu().numpy() if torch.is_tensor(vip) else np.asarray(vip)
    rk = rk.cpu().numpy() if torch.is_tensor(rk) else np.asarray(rk)
    nb = vip.shape[0]
    d = nb + 1
    I, J = [], []
    for b in range(nb):
        Is, Js = [], []
        for s in range(rk[b + 1]):
            pre = [0] * (b + 1)
            pre[b] = int(vip[b, s, 1])
            t = int(vip[b, s, 0])
            for sb in range(b - 1, -1, -1):
                pre[sb] = int(vip[sb, t, 1])
                t = int(vip[sb, t, 0])
            Is.append(tuple(pre))
            suf = [0] * (d - b - 1)
            suf[0] = int(vip[b, s, 2])
            t = int(vip[b, s, 3])
            for sb in range(b + 1, d - 1):
                suf[sb - b] = int(vip[sb, t, 2])
                t = int(vip[sb, t, 3])
            Js.append(tuple(suf))
        I.append(Is)
        J.append(Js)
    return I, J


def assemble_indices(ltab, rtab, p, i, j, k, q, d: int) -> torch.Tensor:
    """Full int32 multi-index for candidates (i, j, k, q) at bond p.

    p an int: ltab, rtab (R, d) and candidates (B,) give (B, d); lane
    tables (L, R, d) and candidates (L, B) give (L, B, d), each lane's
    candidates from its own tables.  p a tensor (P,) of bonds: ltab, rtab
    (P, R, d) and candidates (P, B) give (P, B, d), each bond's candidates
    from its own tables."""
    if isinstance(p, torch.Tensor):
        P, B = i.shape
        col = torch.arange(d, device=ltab.device)
        pb = p.view(P, 1, 1)
        left = ltab.gather(1, i.long()[:, :, None].expand(P, B, d))
        right = rtab.gather(1, q.long()[:, :, None].expand(P, B, d))
        ind = torch.where(col < pb, left, right)
        ind = torch.where(col == pb, j[:, :, None].to(ind.dtype), ind)
        return torch.where(col == pb + 1, k[:, :, None].to(ind.dtype), ind)
    ind = torch.empty(i.shape + (d,), dtype=torch.int32, device=ltab.device)
    if ltab.dim() == 3:
        ind[..., :p] = torch.take_along_dim(ltab[..., :p], i.long()[..., None], dim=-2)
        ind[..., p + 2:] = torch.take_along_dim(rtab[..., p + 2:], q.long()[..., None], dim=-2)
    else:
        ind[:, :p] = ltab[i.long(), :p]
        ind[:, p + 2:] = rtab[q.long(), p + 2:]
    ind[..., p] = j
    ind[..., p + 1] = k
    return ind
