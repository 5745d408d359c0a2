"""Pivot index-chain reconstruction.

Counterpart of ttcross_tpu/cross/chains.py (:27-214).  Each sampled entry
at bond p is a tuple (i, j, k, q): i links into bond p-1's pivots, j and k
are the mode indices of cores p and p+1, q links into bond p+1's pivots.
The left (right) table of a bond holds, for every link value, the mode
indices of the row (column) chain it enters; candidates then gather from
the tables.  vip[b, s] = (i, j, k, q) of pivot s of bond b.  Tables and
assembled indices are int32 like vip; index arguments may be any integer
dtype.  The bond p is a Python int: the engine loops over bonds in Python.
"""

from __future__ import annotations

import torch

__all__ = ["left_table", "right_table", "advance_left", "advance_right",
           "all_left_tables", "all_right_tables", "assemble_indices"]


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
    p set to vip_p[t, 1]."""
    nt = ltab[vip_p[:, 0].long()]
    nt[:, p] = vip_p[:, 1]
    return nt


def advance_right(rtab, vip_p1, p: int) -> torch.Tensor:
    """Right table of bond p from bond p+1's: rtab[vip_p1[t, 3]] with
    column p+2 set to vip_p1[t, 2] (p+2 < d; p = -1 writes column 1)."""
    nt = rtab[vip_p1[:, 3].long()]
    nt[:, p + 2] = vip_p1[:, 2]
    return nt


def all_left_tables(vip, d: int) -> torch.Tensor:
    """LT (d-1, R, d): the left table of every bond, by the advance_left
    recurrence (JAX builds it with an associative scan; the values are
    integers, so both are exact)."""
    R = vip.shape[1]
    tabs = [torch.zeros((R, d), dtype=vip.dtype, device=vip.device)]
    for p in range(d - 2):
        tabs.append(advance_left(tabs[-1], vip[p], p))
    return torch.stack(tabs)


def all_right_tables(vip, d: int) -> torch.Tensor:
    """RT (d-1, R, d): the right table of every bond (RT[d-2] = 0)."""
    R = vip.shape[1]
    tabs = [torch.zeros((R, d), dtype=vip.dtype, device=vip.device)]
    for p in range(d - 3, -1, -1):
        tabs.append(advance_right(tabs[-1], vip[p + 1], p))
    return torch.stack(tabs[::-1])


def assemble_indices(ltab, rtab, p: int, i, j, k, q, d: int) -> torch.Tensor:
    """Full (B, d) int32 multi-index for candidates (i, j, k, q) at bond p."""
    B = i.shape[0]
    ind = torch.empty((B, d), dtype=torch.int32, device=ltab.device)
    ind[:, :p] = ltab[i.long(), :p]
    ind[:, p] = j
    ind[:, p + 1] = k
    ind[:, p + 2:] = rtab[q.long(), p + 2:]
    return ind
