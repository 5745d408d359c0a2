"""Alternating-maxvol TT-cross refinement: pivot replacement sweeps.

Counterpart of ttcross_tpu/cross/maxvol.py.  The greedy DMRG-append engine
(cross/engine.py) appends pivots and never revisits them, which leaves a
fixed-rank quality ceiling set by the greedy nesting of the index sets.
This module re-selects whole pivot sets: the alternating maxvol TT-cross
iteration (Oseledets & Tyrtyshnikov 2010).  Starting from the greedy
cross's index sets (or a random draw), left-to-right sweeps re-evaluate
each bond's fiber cross A(I_{b-1} x n_b, J_b) and replace the bond's row
set I_b by the rows of a dominant r x r submatrix; right-to-left sweeps do
the same for the column sets J_b.  Each exchange step grows
|det A(I_b, J_b)|, and a (1+tol)-dominant cross is quasioptimal at its rank.

Index sets are padded (R, d) multi-index tables on the device, each bond
visit is one batched integrand call over the padded fiber cross
((R*N*R, d) indices), the selection is a masked partial-pivot elimination
followed by masked exchange steps, all as fixed-trip loops of tensor
operations: a sweep makes no host round trip.

Evaluation cost: one sweep costs ~ 2 sum_b r_{b-1} n_b r_b integrand
calls (counted like the reference's n_evals, dmrgg.f90:372)."""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

__all__ = ["cross_maxvol", "maxvol_refine", "maxvol_select", "masked_solve"]


def maxvol_select(M, row_mask, r_act, n_exchange: int = 8, tol: float = 1.01):
    """Select `r_act` rows of M (P, R) whose submatrix has (1+tol)-dominant
    volume: masked partial-pivot elimination for the initial set, then
    masked maxvol exchange steps (swap in the row argmax|B| while
    max|B| > tol, where B = M inv(M[sel])).

    row_mask (P,) bool marks candidate rows (they may be strided, not a
    prefix); active columns are 0..r_act-1 (r_act an int or a 0-d tensor)
    and padded entries of M must already be zero.  Returns sel (R,) int64
    row indices (entries >= r_act are padding) and B (P, R), the
    interpolation coefficients, with B[sel[t]] = e_t on the active block.

    The pivot order is the algorithm: the elimination takes the first
    largest residual of column t, and the exchange stops for good at its
    first non-improving step (the `done` latch), as in the JAX package.  B
    is built alongside the elimination (two outer products per pivot) and
    each exchange is the Sherman-Morrison rank-1 update
        B' = B - B[:, t*] (B[i*, :] - e_{t*}) / B[i*, t*];
    R + n_exchange steps of masked tensor updates, no host read."""
    P, R = M.shape
    dev = M.device
    rows = torch.arange(P, device=dev)
    cols = torch.arange(R, device=dev)
    colm = cols < r_act
    keep = row_mask[:, None] & colm[None, :]

    # ---- init: partial-pivot elimination, building B alongside.
    # Invariant: res = M - B @ M[sel_t] (residual after t pivots) and
    # B = M @ inv(M[sel_t]) restricted to the chosen columns.
    res, B = M, torch.zeros_like(M)
    sel = torch.zeros((R,), dtype=torch.int64, device=dev)
    used = torch.zeros((P,), dtype=torch.bool, device=dev)
    for t in range(R):
        live = colm[t]
        col = res[:, t]
        rsel = torch.argmax(torch.where(row_mask & ~used, col.abs(), -1.0)).view(1)
        piv = col.index_select(0, rsel)
        c = col / torch.where(piv.abs() > 0, piv, 1.0)        # (P,) new coeff column
        res2 = res - torch.outer(c, res.index_select(0, rsel)[0])
        B2 = B - torch.outer(c, B.index_select(0, rsel)[0])   # re-express old columns
        B2[:, t] = c
        res = torch.where(live, res2, res)
        B = torch.where(live, B2, B)
        sel[t:t + 1] = torch.where(live, rsel, 0)
        used = used | (live & (rows == rsel))
    B = torch.where(keep, B, 0.0)

    # ---- maxvol exchange steps (rank-1 B updates)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(n_exchange):
        a = B.abs()
        i_star = torch.argmax(a.amax(dim=1)).view(1)
        brow = B.index_select(0, i_star)[0]                   # (R,)
        t_star = torch.argmax(brow.abs()).view(1)
        denom = brow.index_select(0, t_star)
        improve = (denom.abs()[0] > tol) & ~done
        denom = torch.where(denom.abs() > 0, denom, 1.0)
        u = B.index_select(1, t_star)[:, 0]
        v = brow - (cols == t_star).to(B.dtype)
        B2 = torch.where(keep, B - torch.outer(u, v) / denom, 0.0)
        B = torch.where(improve, B2, B)
        sel.index_copy_(0, t_star, torch.where(improve, i_star, sel.index_select(0, t_star)))
        done = done | ~improve
    return sel, B


def masked_solve(S, M, r_act):
    """X = inv(S_act) @ M_act for the active r_act x r_act block of S
    (R, R) applied to M (R, K); padded rows of X are zero.

    One LU solve (torch.linalg.solve: partial pivoting, as the JAX
    package's Gauss-Jordan elimination has) of the active block embedded
    in the identity, so the padding solves to itself and is masked away.
    The JAX package eliminates by hand because its platform has no f64 LU;
    the card has."""
    R_ = S.shape[0]
    act = torch.arange(R_, device=S.device) < r_act
    blk = act[:, None] & act[None, :]
    emb = torch.where(blk, S, torch.eye(R_, dtype=S.dtype, device=S.device))
    X = torch.linalg.solve(emb, torch.where(act[:, None], M, 0.0))
    return torch.where(act[:, None], X, 0.0)


class MaxvolKit(NamedTuple):
    """The refinement run plus its per-bond parts (each takes the bond as
    an int)."""

    run: Callable
    visit_lr: Callable
    visit_rl: Callable
    first_core: Callable
    emit_core: Callable


def _refine_engine(fun: Callable, n: tuple, R: int, n_exchange: int, tol: float,
                   device) -> MaxvolKit:
    """Build the multi-sweep refinement run: (LI, RJ, rr, n_sweeps) ->
    (cores, LI, RJ, neval, padded).  LI / RJ (d-1, R, d) int32 are the left
    / right pivot multi-index tables (LI[b, t, :b+1] and RJ[b, t, b+1:]
    valid), rr (d-1,) the per-bond ranks (fixed), all on `device`."""
    d = len(n)
    N = max(n)
    dev = torch.device(device)
    iR = torch.arange(R, device=dev)
    iN = torch.arange(N, device=dev)
    col = torch.arange(d, device=dev)
    rep_R, tile_N = iR.repeat_interleave(N), iN.repeat(R)     # flat (i, j) = i*N + j
    rep_N, tile_R = iN.repeat_interleave(R), iR.repeat(N)     # flat (k, q) = k*R + q
    one = torch.ones((), dtype=torch.int32, device=dev)

    def row_prefixes(LI, b: int):
        """Candidate left prefixes at bond b: (R*N, d), flat (i, j) =
        i*N + j: LI[b-1] row i extended with mode b = j (at b = 0 the
        prefix is just j)."""
        li = LI[b - 1] if b > 0 else torch.zeros_like(LI[0])
        pre = li.repeat_interleave(N, dim=0)                   # (R*N, d)
        return torch.where(col[None, :] == b, tile_N[:, None].to(torch.int32), pre)

    def suffixes(RJ, b: int):
        """Candidate right suffixes at bond b: (N*R, d), flat (k, q) =
        k*R + q: mode b+1 = k, the rest RJ[b+1][q]."""
        rj = RJ[b + 1] if b < d - 2 else torch.zeros_like(RJ[0])
        suf = rj.repeat(N, 1)                                  # (N*R, d)
        return torch.where(col[None, :] == b + 1, rep_N[:, None].to(torch.int32), suf)

    def visit_lr(b: int, LI, RJ, rr, neval, padded):
        """L->R bond visit: evaluate the fiber cross A(I_{b-1} x n_b, J_b)
        in one batched call and re-select I_b by maxvol (LI[b] is written
        in place).  Returns the interpolation core B too."""
        pre = row_prefixes(LI, b)                              # (R*N, d)
        ind = torch.where(col[None, None, :] <= b, pre[:, None, :], RJ[b][None, :, :])
        vals = fun(ind.reshape(-1, d)).reshape(R * N, R)
        r_l = rr[b - 1] if b > 0 else one
        rowm = (rep_R < r_l) & (tile_N < n[b])
        M = torch.where(rowm[:, None] & (iR < rr[b])[None, :], vals, 0.0)
        neval = neval + (r_l * n[b] * rr[b]).long()
        padded = padded + R * N * R
        sel, B = maxvol_select(M, rowm, rr[b], n_exchange=n_exchange, tol=tol)
        LI[b] = pre.index_select(0, sel)
        return LI, B.reshape(R, N, R), neval, padded

    def visit_rl(b: int, LI, RJ, rr, neval, padded):
        """R->L bond visit: evaluate M = A(I_b, n_{b+1} x J_{b+1}) and
        re-select J_b by maxvol on the transpose (RJ[b] is written in
        place).

        Also returns core b+1: maxvol's coefficient matrix is
        B = M^T inv(S_b^T) with S_b = A(I_b, J_b-new), so
        B^T = inv(S_b) A(I_b, n_{b+1} x J_{b+1}), the (b+1)-th core of the
        cross interpolant A ~ A(i_0, J_0) prod_b [inv(S_{b-1})
        A(I_{b-1}, i_b, J_b)]: no assembly pass is needed."""
        suf = suffixes(RJ, b)                                  # (N*R, d)
        ind = torch.where(col[None, None, :] <= b, LI[b][:, None, :], suf[None, :, :])
        vals = fun(ind.reshape(-1, d)).reshape(R, N * R)
        r_r = rr[b + 1] if b < d - 2 else one
        colm_k = (rep_N < n[b + 1]) & (tile_R < r_r)
        M = torch.where((iR < rr[b])[:, None] & colm_k[None, :], vals, 0.0)
        neval = neval + (rr[b] * n[b + 1] * r_r).long()
        padded = padded + R * N * R
        sel, B = maxvol_select(M.T.contiguous(), colm_k, rr[b], n_exchange=n_exchange, tol=tol)
        RJ[b] = suf.index_select(0, sel)
        return RJ, B.T.reshape(R, N, R), neval, padded        # inv(S_b) M, cols (k, q)

    def emit_core(b: int, LI, RJ, rr, neval, padded):
        """Core b+1 = inv(S_b) A(I_b, n_{b+1} x J_{b+1}) from frozen index
        tables: S_b = A(I_b, J_b), both evaluated in one batched call, then
        a masked solve.  Exact for arbitrary frozen sets (the CUR-chain
        identity needs no nestedness)."""
        cand = torch.cat([suffixes(RJ, b), RJ[b]], dim=0)      # (N*R + R, d)
        ind = torch.where(col[None, None, :] <= b, LI[b][:, None, :], cand[None, :, :])
        vals = fun(ind.reshape(-1, d)).reshape(R, N * R + R)
        r_r = rr[b + 1] if b < d - 2 else one
        rowm = iR < rr[b]
        colm_k = (rep_N < n[b + 1]) & (tile_R < r_r)
        M = torch.where(rowm[:, None] & colm_k[None, :], vals[:, : N * R], 0.0)
        S = torch.where(rowm[:, None] & rowm[None, :], vals[:, N * R:], 0.0)
        neval = neval + (rr[b] * (n[b + 1] * r_r + rr[b])).long()
        padded = padded + R * (N * R + R)
        return masked_solve(S, M, rr[b]).reshape(R, N, R), neval, padded

    def first_core(RJ, rr, neval, padded):
        """Core 0 = A(grid_0, J_0): raw fiber values (N, R)."""
        ind = torch.where(col[None, None, :] == 0, iN[:, None, None].to(torch.int32),
                          RJ[0][None, :, :])                   # (N, R, d)
        vals = fun(ind.reshape(-1, d)).reshape(N, R)
        m = (iN[:, None] < n[0]) & (iR[None, :] < rr[0])
        return torch.where(m, vals, 0.0), neval + (n[0] * rr[0]).long(), padded + N * R

    def run(LI, RJ, rr, n_sweeps: int):
        neval = torch.zeros((), dtype=torch.int64, device=dev)
        padded = torch.zeros((), dtype=torch.int64, device=dev)
        cores = torch.zeros((d, R, N, R), dtype=torch.float64, device=dev)
        LI, RJ = LI.clone(), RJ.clone()
        for _ in range(n_sweeps):
            for b in range(d - 1):
                LI, _, neval, padded = visit_lr(b, LI, RJ, rr, neval, padded)
            for b in range(d - 2, -1, -1):
                RJ, cores[b + 1], neval, padded = visit_rl(b, LI, RJ, rr, neval, padded)
        firstc, neval, padded = first_core(RJ, rr, neval, padded)
        cores[0, 0] = firstc
        return cores, LI, RJ, neval, padded

    return MaxvolKit(run=run, visit_lr=visit_lr, visit_rl=visit_rl,
                     first_core=first_core, emit_core=emit_core)


def _pad_sets(I, J, d, R):
    """Pad host-side nested index sets (chains.pivot_index_sets layout)
    into the (d-1, R, d) LI / RJ tables + per-bond ranks."""
    LI = np.zeros((d - 1, R, d), np.int32)
    RJ = np.zeros((d - 1, R, d), np.int32)
    rr = np.zeros((d - 1,), np.int32)
    for b in range(d - 1):
        rr[b] = len(I[b])
        for t, pre in enumerate(I[b]):
            LI[b, t, : b + 1] = pre
        for t, suf in enumerate(J[b]):
            RJ[b, t, b + 1:] = suf
    return LI, RJ, rr


def _rank_vector(ranks, n):
    """Per-bond ranks from a scalar or sequence, capped by the unfolding
    dimensions min(prod n[:b+1], prod n[b+1:])."""
    d = len(n)
    if np.isscalar(ranks):
        lcap = np.minimum(np.cumprod(np.asarray(n[:-1], np.float64)), 1e18)
        rcap = np.minimum(np.cumprod(np.asarray(n[:0:-1], np.float64))[::-1], 1e18)
        return np.minimum(float(ranks), np.minimum(lcap, rcap)).astype(np.int32)
    rr = np.asarray(ranks, np.int32)
    if rr.shape != (d - 1,):
        raise ValueError(f"ranks must be scalar or length d-1, got {rr.shape}")
    return rr


def _seed_from_key(key) -> int:
    """Integer seed from an int or an array-like key (its last word)."""
    if isinstance(key, (int, np.integer)):
        return int(key)
    return int(np.asarray(key).ravel()[-1])


def _prepare_refine_sets(init_sets, ranks, n, d: int, max_rank, key):
    """Padded (LI, RJ) host index tables + rank vector from either explicit
    pivot sets or a seeded random column-set draw (classic TT-cross init,
    from numpy's Generator as in the JAX package)."""
    if init_sets is not None:
        I, J = init_sets
        rr_probe = max(len(I[b]) for b in range(d - 1))
        R = int(max_rank if max_rank is not None else rr_probe)
        LI, RJ, rr = _pad_sets(I, J, d, R)
    else:
        if ranks is None:
            raise ValueError("ranks is required without init_sets")
        rr = _rank_vector(ranks, n)
        R = int(max_rank if max_rank is not None else rr.max())
        rng = np.random.default_rng(_seed_from_key(key))
        LI = np.zeros((d - 1, R, d), np.int32)
        RJ = np.zeros((d - 1, R, d), np.int32)
        for b in range(d - 1):
            for c in range(b + 1, d):
                RJ[b, :, c] = rng.integers(0, n[c], size=R)
    if np.any(rr > R):
        raise ValueError(f"ranks {rr.max()} exceed the padding R={R}")
    return LI, RJ, rr, R


def maxvol_refine(fun, n: Sequence[int], ranks=None, init_sets=None, sweeps: int = 2,
                  quad=None, truth=None, key=0, n_exchange: int = 8, tol: float = 1.01,
                  max_rank: int | None = None, device: str | torch.device = "cuda"):
    """Refine (or build from scratch) a TT-cross of `fun` at fixed per-bond
    `ranks` by alternating maxvol sweeps on ``device`` (the card unless the
    caller asks for ``device="cpu"``; fun must take int32 index tensors
    there).

    init_sets: (I, J) nested pivot index sets in chains.pivot_index_sets
    layout, e.g. a greedy cross's pivots (cross(..., refine_sweeps=k) wires
    this); ranks are then taken from the sets.  When None, the column sets
    start from a random draw seeded by key and `ranks` is required.
    Returns a CrossResult whose tt is the refined interpolant; padded_evals
    counts the full padded batches."""
    from ..tt.ops import contract
    from ..tt.types import TT
    from .engine import CrossResult

    n = tuple(int(x) for x in n)
    d = len(n)
    if d < 2:
        raise ValueError("maxvol_refine requires d >= 2")
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1 (the cores are emitted during the last "
                         "R->L half sweep)")
    t0 = time.perf_counter()
    LI, RJ, rr, R = _prepare_refine_sets(init_sets, ranks, n, d, max_rank, key)
    dev = torch.device(device)
    run = _refine_engine(fun, n, R, n_exchange, tol, dev).run
    cores, _, _, neval, padded = run(torch.from_numpy(LI).to(dev), torch.from_numpy(RJ).to(dev),
                                         torch.from_numpy(rr).to(dev), int(sweeps))
    rk = [1, *rr.tolist(), 1]
    tt = TT(tuple(cores[c, : rk[c], : n[c], : rk[c + 1]].clone() for c in range(d)))

    values, errors = [], []
    if quad is not None:
        val = float(contract(tt, list(quad)))
        values.append(val)
        if truth is not None:
            errors.append(abs(1.0 - val / truth))
    return CrossResult(
        tt=tt, neval=int(neval), sweeps=int(sweeps), ranks=tuple(rk), values=values,
        errors=errors, time=time.perf_counter() - t0, converged=True, history=None,
        padded_evals=int(padded))


def cross_maxvol(fun, n: Sequence[int], max_rank: int = 20, sweeps: int = 3,
                 device: str | torch.device = "cuda", **kw):
    """Classic alternating-maxvol TT-cross from a random init: the second
    cross algorithm next to the greedy DMRG engine (engine.py)."""
    return maxvol_refine(fun, n, ranks=max_rank, init_sets=None, sweeps=sweeps,
                         device=device, **kw)
