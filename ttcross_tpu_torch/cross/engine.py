"""Sequential DMRG-greedy TT-cross engine, run eagerly on one device.

Counterpart of ttcross_tpu/cross/engine.py for sweep_mode="sequential"
(dtt_dmrgg, dmrgg.f90:11-1050): the same padded state, the same
rook/lottery/full pivot hunts, the same two-threshold acceptance and the
same strike-based stop.  A Python loop runs over sweeps and bonds, and
every decision inside a sweep stays on the device as a branch-free masked
update (the accept flag ``upd`` and the rook ``done`` flags are tensors),
so a sweep makes no host round trip; the one host sync per sweep is the
stopping rule.  The large state arrays are updated in place.

Kernels on this path (ops/kernels.py): every integrand call of the Ising
problem is one small-table lookup (kernel B); every rook pass and the
full-pivoting hunt score their residual with the masked argmax (kernel A).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..config import precision_thresholds
from ..ops import lu as lulib
from ..ops.dense import balanced_matmul_chain, exact_pow2, row_lookup
from ..ops.kernels import score_residual_argmax
from ..tt.ops import contract
from ..tt.ortho import svd_round
from ..tt.types import TT
from ..utils.metrics import SweepRecord, history_from_run
from .chains import (advance_left, advance_right, all_left_tables,
                     all_right_tables, assemble_indices)
from .state import CrossState, empty_state

__all__ = ["CrossConfig", "CrossResult", "cross", "make_engine",
           "round_and_revalue"]


@dataclass(frozen=True)
class CrossConfig:
    d: int
    n: tuple[int, ...]   # per-mode sizes
    N: int               # padded mode size = max(n)
    R: int               # padded rank = maxrank
    piv: int             # -1 full, 0 lottery, >=1 rook searches
    small_element: float
    small_pivot: float
    snum: int = 8        # shifted diagonals in the initial search (dmrgg.f90:29)


@dataclass
class CrossResult:
    tt: TT
    neval: int
    sweeps: int
    ranks: tuple[int, ...]
    values: list
    errors: list
    time: float
    converged: bool
    history: list | None = None   # SweepRecords (utils/metrics.py)
    state: CrossState | None = None   # final state when return_state=True
    padded_evals: int | None = None   # integrand calls incl. padding


class EngineKit(NamedTuple):
    cfg: CrossConfig
    init_fn: Callable       # () -> CrossState
    sweep_fn: Callable      # (st, it, U (d-1, 2, NLOT)) -> CrossState
    value_fn: Callable      # (st, w (d, N)) -> 0-d tensor
    finalize_fn: Callable   # (st) -> (d, R, N, R) solved cores


def round_and_revalue(res: CrossResult, max_rank: int, quad, truth) -> CrossResult:
    """Oversample post-pass: TT-SVD-truncate the train to max_rank and
    append the rounded train's quadrature value and error (history gets a
    direction 'rd' record; rounding evaluates nothing)."""
    res.tt = svd_round(res.tt, tol=0.0, rmax=max_rank)
    res.ranks = tuple(res.tt.r)
    if quad is not None:
        val = float(contract(res.tt, list(quad)))
        res.values.append(val)
        if truth is not None:
            res.errors.append(abs(1.0 - val / truth))
        else:
            prev = res.values[-2]
            res.errors.append(abs(1.0 - val / prev) if prev != 0 else float("nan"))
        if res.history is not None:
            res.history.append(SweepRecord(
                it=res.sweeps + 1, direction="rd", n_evals=res.neval,
                pivotmax=float(res.history[-1].pivotmax) if res.history else 0.0,
                value=val,
                err=res.errors[-1] if truth is not None else None,
                cnv=None if truth is not None else res.errors[-1]))
    return res


def _values_errors(vals, last_it: int, truth, with_quad: bool):
    values, errors = [], []
    if with_quad:
        values = [float(v) for v in vals[: last_it + 1]]
        for i in range(1, last_it + 1):
            if truth is not None:
                errors.append(abs(1.0 - vals[i] / truth))
            else:
                prev = vals[i - 1]
                errors.append(abs(1.0 - vals[i] / prev) if prev != 0 else float("nan"))
    return values, errors


def _masked_write(buf, dim: int, slot, new, upd) -> None:
    """In place: buf's slot `slot` (1-element long tensor) along dim
    becomes where(upd, new, old) (JAX: dynamic_update_slice)."""
    old = buf.index_select(dim, slot)
    buf.index_copy_(dim, slot, torch.where(upd, new, old))


def make_engine(fun: Callable, cfg: CrossConfig, device,
                dtype: torch.dtype = torch.float64) -> EngineKit:
    """Build the engine phases for integrand fun: ind (B, d) int32 tensor on
    `device` -> (B,) values."""
    d, N, R = cfg.d, cfg.N, cfg.R
    n = cfg.n
    NLOT = 2 * (R + N)
    dev = torch.device(device)
    iR = torch.arange(R, device=dev)
    iN = torch.arange(N, device=dev)
    n_t = torch.tensor(n, device=dev)
    # candidate enumerations: column fibers vary (i, j) over (R, N), row
    # fibers (k, q) over (N, R), lottery slots over NLOT
    ci_g, cj_g = iR.repeat_interleave(N), iN.repeat(R)
    rk_g, rq_g = iN.repeat_interleave(R), iR.repeat(N)
    lot = torch.arange(NLOT, device=dev)

    # ---------------------------------------------------------------- init
    def init_fn() -> CrossState:
        """Initial pivot search over shifted diagonals + rank-1 cross
        (dmrgg.f90:151-248)."""
        st = empty_state(d, N, R, dtype, dev)
        nn = int(min(n))
        ks = torch.arange(nn, device=dev)[None, :, None]
        ss = torch.arange(cfg.snum, device=dev)[:, None, None]
        ps = torch.arange(d, device=dev)[None, None, :]
        cand = ((ks + ss * ps) % n_t[None, None, :]).reshape(-1, d).to(torch.int32)
        vals = fun(cand)
        best = torch.argmax(vals.abs()).view(1)
        amax = vals.abs().max()
        ind0 = cand.index_select(0, best)[0]               # (d,)
        # in place: initial vip (0, ind0[b], ind0[b+1], 0) per bond
        st.vip[:, 0, 1] = ind0[:-1]
        st.vip[:, 0, 2] = ind0[1:]

        # rank-1 fibers: for each core c vary mode c over its grid
        mode_pos = torch.arange(d, device=dev).repeat_interleave(N)
        mode_val = iN.repeat(d)
        col = torch.arange(d, device=dev)
        fib_ind = torch.where(col[None, :] == mode_pos[:, None],
                              torch.minimum(mode_val, n_t[mode_pos] - 1)[:, None],
                              ind0[None, :].long())
        fvals = fun(fib_ind.to(torch.int32)).reshape(d, N)
        fvals = torch.where(iN[None, :] < n_t[:, None], fvals, 0.0)
        amax = torch.maximum(amax, fvals.abs().max())

        delta = fvals[0].index_select(0, ind0[:1].long())[0]   # = A(ind0)
        st.cores[:, 0, :, 0] = fvals
        st.lu_d[:, 0] = delta
        st.itt[:, 0, 0] = 1.0 / delta
        st.colf[:, 0, :, 0] = fvals / delta
        st.rowf[:, 0, :, 0] = fvals
        neval = torch.tensor(cfg.snum * nn + sum(n), dtype=torch.int64, device=dev)
        padded = torch.tensor(cfg.snum * nn + d * N, dtype=torch.int64, device=dev)
        return st._replace(amax=amax, pivotmax_prev=amax, neval=neval,
                           padded=padded)

    # ----------------------------------------------------------- bond visit
    def _col_mask(st, p):
        return (iR[:, None] < st.rk[p]) & (iN[None, :] < n[p])          # (R, N)

    def _row_mask(st, p):
        return (iN[:, None] < n[p + 1]) & (iR[None, :] < st.rk[p + 2])  # (N, R)

    def _col_fiber(st, p, ltab, rtab, kk, qq):
        """Raw column fiber (R, N) at fixed (kk, qq), masked to the active
        (rk[p], n_p) block, and its count of active evaluations."""
        ind = assemble_indices(ltab, rtab, p, ci_g, cj_g,
                               kk.expand(R * N), qq.expand(R * N), d)
        vals = torch.where(_col_mask(st, p), fun(ind).reshape(R, N), 0.0)
        return vals, (st.rk[p] * n[p]).long()

    def _row_fiber(st, p, ltab, rtab, ii, jj):
        """Raw row fiber (N, R) at fixed (ii, jj), masked to
        (n_{p+1}, rk[p+2]), and its count of active evaluations."""
        ind = assemble_indices(ltab, rtab, p, ii.expand(N * R), jj.expand(N * R),
                               rk_g, rq_g, d)
        vals = torch.where(_row_mask(st, p), fun(ind).reshape(N, R), 0.0)
        return vals, (n[p + 1] * st.rk[p + 2]).long()

    def _rank_mask(st, p):
        return (iR < st.rk[p + 1]).to(dtype)

    def _col_residual_argmax(st, p, acol, kk, qq):
        """argmax of |acol - colf[p] @ rowf[p+1][:, kk, qq]| over the
        active block (dmrgg.f90:537-539): kernel A at (R*N, 1)."""
        u = (st.rowf[p + 1].reshape(R, N * R).index_select(1, (kk * R + qq).view(1))
             * _rank_mask(st, p)[:, None])                              # (R, 1)
        flat, _, resid = score_residual_argmax(
            acol.reshape(R * N, 1), st.colf[p].reshape(R * N, R), u,
            _col_mask(st, p).reshape(R * N, 1))
        return flat // N, flat % N, resid

    def _row_residual_argmax(st, p, arow, ii, jj):
        """argmax of |arow - colf[p][ii, jj, :] @ rowf[p+1]| over the
        active block (dmrgg.f90:570-572): kernel A at (1, N*R)."""
        c = (st.colf[p].reshape(R * N, R).index_select(0, (ii * N + jj).view(1))
             * _rank_mask(st, p)[None, :])                              # (1, R)
        flat, _, resid = score_residual_argmax(
            arow.reshape(1, N * R), c, st.rowf[p + 1].reshape(R, N * R),
            _row_mask(st, p).reshape(1, N * R))
        return flat // R, flat % R, resid

    def _hunt_lottery(st, p, ltab, rtab, u2):
        """Uniform lottery over the unused candidate columns (i, j) and rows
        (q, k) (lottery2, rnd.f90:105-144; dmrgg.f90:410-487), residual
        scoring, seed pivot.  u2 (2, NLOT) f64 uniforms in [0, 1).

        The draw rounds exactly as the JAX engine's: the 0/1 CDF is an
        integer cumsum held in f32 (JAX's triangular-ones f32 matmul gives
        the same exact counts), the target is f32(u) * f32(total) clamped
        to total * f32(1 - 2^-20), and the pick is searchsorted(right)."""
        # layouts: columns (i, j) flattened i*N + j; rows (q, k) q*N + k
        colmask = ((iR[:, None] < st.rk[p]) & (iN[None, :] < n[p])).reshape(-1)
        rowmask = ((iR[:, None] < st.rk[p + 2]) & (iN[None, :] < n[p + 1])).reshape(-1)
        # zero weight on already-used pivots (dmrgg.f90:432-439); padding
        # rows of vip repeat index 0, so the scatter takes the max
        vb = st.vip[p].long()                                 # (R, 4)
        smask = (iR < st.rk[p + 1]).to(torch.int32)
        used_col = torch.zeros(R * N, dtype=torch.int32, device=dev).scatter_reduce_(
            0, vb[:, 0] * N + vb[:, 1], smask, "amax")
        used_row = torch.zeros(N * R, dtype=torch.int32, device=dev).scatter_reduce_(
            0, vb[:, 3] * N + vb[:, 2], smask, "amax")
        cdf_c = torch.cumsum((colmask & (used_col == 0)).to(torch.int32), 0).to(torch.float32)
        cdf_r = torch.cumsum((rowmask & (used_row == 0)).to(torch.int32), 0).to(torch.float32)
        below = 1.0 - 2.0 ** -20          # exact in f32
        tot_c, tot_r = cdf_c[-1], cdf_r[-1]
        t_c = torch.minimum(u2[0].to(torch.float32) * torch.where(tot_c > 0, tot_c, 1.0),
                            tot_c * below)
        t_r = torch.minimum(u2[1].to(torch.float32) * torch.where(tot_r > 0, tot_r, 1.0),
                            tot_r * below)
        lin_c = torch.searchsorted(cdf_c, t_c, right=True).clamp(max=R * N - 1)
        lin_r = torch.searchsorted(cdf_r, t_r, right=True).clamp(max=N * R - 1)
        i_c, j_c = lin_c // N, lin_c % N
        q_c, k_c = lin_r // N, lin_r % N

        nlot_act = st.rk[p] + n[p] + n[p + 1] + st.rk[p + 2]
        candmask = lot < nlot_act
        b = fun(assemble_indices(ltab, rtab, p, i_c, j_c, k_c, q_c, d))
        amax = torch.maximum(st.amax, torch.where(candmask, b.abs(), 0.0).max())
        neval = st.neval + nlot_act.long()

        # residual b - colf[p][i,j,:] . rowf[p+1][:,k,q]  (dmrgg.f90:469-476)
        cf = row_lookup(st.colf[p].reshape(R * N, R), lin_c)                 # (NLOT, R)
        rf = row_lookup(st.rowf[p + 1].reshape(R, N * R), k_c * R + q_c, axis=1)
        resid = b - (cf * rf * _rank_mask(st, p)[None, :]).sum(dim=1)
        best = torch.argmax(torch.where(candmask, resid.abs(), -1.0)).view(1)
        seed = tuple(x.index_select(0, best)[0] for x in (i_c, j_c, k_c, q_c))
        st = st._replace(amax=amax, neval=neval, padded=st.padded + NLOT)
        return st, seed, resid.index_select(0, best)[0]

    def _rook(st, p, ltab, rtab, seed, pivot0, fwd: bool):
        """Rook pivoting (dmrgg.f90:515-582): alternate column/row
        maximization until stationary or 2*piv passes, as exactly 2*piv
        masked passes ('>>' sweeps start with a column pass, '<<' with a
        row pass; skipcol, dmrgg.f90:517).  A pass after the tensor flag
        `done` is set changes nothing; whether the budget ends a pass is
        known on the host (it depends only on the pass number)."""
        ii, jj, kk, qq = seed
        pivot = pivot0
        acol = torch.zeros((R, N), dtype=dtype, device=dev)
        arow = torch.zeros((N, R), dtype=dtype, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        amax, neval = st.amax, st.neval
        havecol = haverow = False
        for t in range(2 * cfg.piv):
            live = ~done
            if fwd == (t % 2 == 0):      # column pass
                new, dnev = _col_fiber(st, p, ltab, rtab, kk, qq)
                a2, b2, resid = _col_residual_argmax(st, p, new, kk, qq)
                budget = haverow and t + 1 >= 2 * cfg.piv
                stat = ((a2 == ii) & (b2 == jj)) if haverow else torch.zeros_like(done)
                havecol = True
                acol = torch.where(live, new, acol)
                if not budget:
                    ii = torch.where(live, a2, ii)
                    jj = torch.where(live, b2, jj)
            else:                        # row pass
                new, dnev = _row_fiber(st, p, ltab, rtab, ii, jj)
                a2, b2, resid = _row_residual_argmax(st, p, new, ii, jj)
                budget = havecol and t + 1 >= 2 * cfg.piv
                stat = ((a2 == kk) & (b2 == qq)) if havecol else torch.zeros_like(done)
                haverow = True
                arow = torch.where(live, new, arow)
                if not budget:
                    kk = torch.where(live, a2, kk)
                    qq = torch.where(live, b2, qq)
            if not budget:
                pivot = torch.where(live, resid, pivot)
            amax = torch.where(live, torch.maximum(amax, new.abs().max()), amax)
            neval = neval + torch.where(live, dnev, zero)
            done = done | budget | stat
        # padded work: every pass calls fun on a full (R, N) batch
        st = st._replace(amax=amax, neval=neval,
                         padded=st.padded + 2 * cfg.piv * R * N)
        return st, (ii, jj, kk, qq), pivot, acol, arow

    def _hunt_piv0(st, p, ltab, rtab, seed, pivot0):
        """piv = 0: evaluate the seed's full column and row once
        (dmrgg.f90:492-513)."""
        ii, jj, kk, qq = seed
        acol, dn_c = _col_fiber(st, p, ltab, rtab, kk, qq)
        arow, dn_r = _row_fiber(st, p, ltab, rtab, ii, jj)
        amax = torch.maximum(torch.maximum(st.amax, acol.abs().max()), arow.abs().max())
        st = st._replace(amax=amax, neval=st.neval + dn_c + dn_r,
                         padded=st.padded + 2 * R * N)
        return st, seed, pivot0, acol, arow

    def _hunt_full(st, p, ltab, rtab):
        """piv = -1: full superblock residual pivoting (dmrgg.f90:341-408),
        scored by kernel A at (R*N, N*R)."""
        gr = torch.arange(R * N * N * R, device=dev)
        qg, kg = gr % R, (gr // R) % N
        jg, ig = (gr // (R * N)) % N, gr // (R * N * N)
        vals = fun(assemble_indices(ltab, rtab, p, ig, jg, kg, qg, d))
        mask = (_col_mask(st, p).reshape(R * N, 1)
                & _row_mask(st, p).reshape(1, N * R))                   # (RN, NR)
        vals = torch.where(mask, vals.reshape(R * N, N * R), 0.0)
        amax = torch.maximum(st.amax, vals.abs().max())
        neval = st.neval + (st.rk[p] * n[p] * n[p + 1] * st.rk[p + 2]).long()
        st = st._replace(amax=amax, neval=neval, padded=st.padded + R * N * N * R)

        colf_m = st.colf[p].reshape(R * N, R) * _rank_mask(st, p)[None, :]
        flat, _, pivot = score_residual_argmax(
            vals, colf_m, st.rowf[p + 1].reshape(R, N * R), mask)
        row, colx = (flat // (N * R)).view(1), (flat % (N * R)).view(1)
        ii, jj = row[0] // N, row[0] % N
        kk, qq = colx[0] // R, colx[0] % R
        acol = vals.index_select(1, colx).reshape(R, N)
        arow = vals.index_select(0, row).reshape(N, R)
        return st, (ii, jj, kk, qq), pivot, acol, arow

    def _accept(st, p, piv_idx, pivot, acol, arow, upd) -> CrossState:
        """Append the accepted pivot: extend vip / LU / cores / factors
        (dmrgg.f90:602-757), all IN PLACE at slot s = rk[p+1] and masked by
        the tensor flag upd, so a rejected pivot leaves the state as it was
        (JAX: dynamic_update_slice of where(upd, new, old))."""
        ii, jj, kk, qq = piv_idx
        s = st.rk[p + 1].long()
        slot = s.clamp(max=R - 1).view(1)   # a saturated bond never accepts
        rmask = (iR < s).to(dtype)

        c_new = st.colf[p].reshape(R * N, R).index_select(0, (ii * N + jj).view(1))[0] * rmask
        u_new = st.rowf[p + 1].reshape(R, N * R).index_select(1, (kk * R + qq).view(1))[:, 0] * rmask
        # maintained triangular inverses (bordered-inverse recurrences):
        # L_{s+1}^-1 = [[L^-1, 0], [-c L^-1, 1]],
        # T_{s+1}^-1 = [[T^-1, -T^-1 u / delta], [0, 1/delta]]
        new_row = torch.where(iR == s, 1.0, -(c_new @ st.itl[p]))
        new_col = torch.where(iR == s, 1.0 / pivot, -(st.itt[p] @ u_new) / pivot)
        # incremental factor updates (dmrgg.f90:687-713), from the factors
        # as they were before this accept
        new_colf = lulib.apply_new_col(st.colf[p], u_new, pivot, acol, s)
        new_rowf = lulib.apply_new_row(st.rowf[p + 1], c_new, arow, s)

        _masked_write(st.vip[p], 0, slot,
                      torch.stack([ii, jj, kk, qq]).to(torch.int32)[None], upd)
        _masked_write(st.lu_c[p], 0, slot, c_new[None], upd)
        _masked_write(st.lu_u[p], 0, slot, u_new[None], upd)
        _masked_write(st.lu_d[p], 0, slot, pivot.view(1), upd)
        _masked_write(st.itl[p], 0, slot, new_row[None], upd)
        _masked_write(st.itt[p], 1, slot, new_col[:, None], upd)
        # raw fibers into cores (dmrgg.f90:662-685)
        _masked_write(st.cores[p], 2, slot, acol[:, :, None], upd)
        _masked_write(st.cores[p + 1], 0, slot, arow[None], upd)
        _masked_write(st.colf[p], 2, slot, new_colf[:, :, None], upd)
        _masked_write(st.rowf[p + 1], 0, slot, new_rowf[None], upd)
        if p > 0:
            # row factor of bond p-1 on core p gains the new column with the
            # bond p-1 L-solve applied (dmrgg.f90:715-728)
            _masked_write(st.rowf[p], 2, slot, (st.itl[p - 1] @ acol)[:, :, None], upd)
        if p < d - 2:
            # col factor of bond p+1 on core p+1 gains the new row with the
            # bond p+1 T-solve applied (dmrgg.f90:730-749)
            _masked_write(st.colf[p + 1], 0, slot, (arow @ st.itt[p + 1])[None], upd)

        apiv = pivot.abs()
        pivotmax = torch.where(upd & (st.pivotmax < 0), apiv,
                               torch.where(upd, torch.maximum(st.pivotmax, apiv),
                                           st.pivotmax))
        pivotmin = torch.where(upd & (st.pivotmin < 0), apiv,
                               torch.where(upd, torch.minimum(st.pivotmin, apiv),
                                           st.pivotmin))
        st.rk[p + 1:p + 2] += upd.to(torch.int32)     # in place
        return st._replace(pivotmax=pivotmax, pivotmin=pivotmin)

    def visit_bond(st: CrossState, p: int, fwd: bool, ltab, rtab, u2) -> CrossState:
        """Hunt + (maybe) accept at bond p; u2 (2, NLOT) lottery uniforms."""
        if cfg.piv == -1:
            st, piv_idx, pivot, acol, arow = _hunt_full(st, p, ltab, rtab)
        else:
            st, seed, pivot0 = _hunt_lottery(st, p, ltab, rtab, u2)
            if cfg.piv == 0:
                st, piv_idx, pivot, acol, arow = _hunt_piv0(st, p, ltab, rtab, seed, pivot0)
            else:
                st, piv_idx, pivot, acol, arow = _rook(st, p, ltab, rtab, seed, pivot0, fwd)
        upd = ((pivot.abs() > cfg.small_element * st.amax)
               & (pivot.abs() > cfg.small_pivot * st.pivotmax_prev)
               & (st.rk[p + 1] < R))
        return _accept(st, p, piv_idx, pivot, acol, arow, upd)

    def sweep_fn(st: CrossState, it: int, U) -> CrossState:
        """One sweep over all bonds: '>>' on odd it, '<<' on even
        (dmrgg.f90:314-323).  The chain tables of the direction swept away
        from are built once; those swept into advance per bond."""
        fwd = it % 2 == 1
        neg = torch.full((), -1.0, dtype=dtype, device=dev)
        st = st._replace(pivotmax=neg, pivotmin=neg)
        AT = all_right_tables(st.vip, d) if fwd else all_left_tables(st.vip, d)
        tab = torch.zeros((R, d), dtype=st.vip.dtype, device=dev)
        for idx in range(d - 1):
            p = idx if fwd else d - 2 - idx
            ltab = tab if fwd else AT[p]
            rtab = AT[p] if fwd else tab
            st = visit_bond(st, p, fwd, ltab, rtab, U[p])
            tab = (advance_left(tab, st.vip[p], p) if fwd
                   else advance_right(tab, st.vip[p], p - 1))
        return st._replace(pivotmax_prev=st.pivotmax)

    def value_fn(st: CrossState, w) -> torch.Tensor:
        """Quadrature value of the current cross against per-mode weights
        w (d, N), with the growing-LU inverses applied (ttqq + dtt_lua +
        dtt_quad, dmrgg.f90:975-1006), as a norm-balanced product chain."""
        mats = torch.einsum("cinj,cn->cij", st.cores, w)       # (d, R, R)
        mats[1:] = st.itl @ mats[1:]
        mats[:-1] = mats[:-1] @ st.itt
        P, ex = balanced_matmul_chain(mats)
        return P[0, 0] * exact_pow2(ex)

    def finalize_fn(st: CrossState) -> torch.Tensor:
        """Apply the LU inverses to all raw cores (dtt_lua,
        dmrgg.f90:1169-1258): (d, R, N, R) solved cores."""
        g = st.cores.clone()
        g[1:] = torch.einsum("cab,cbnj->canj", st.itl, st.cores[1:])
        g[:-1] = torch.einsum("canb,cbj->canj", g[:-1], st.itt)
        return g

    return EngineKit(cfg=cfg, init_fn=init_fn, sweep_fn=sweep_fn,
                     value_fn=value_fn, finalize_fn=finalize_fn)


def finalize(st: CrossState, kit: EngineKit) -> TT:
    """The solved cores trimmed to the active ranks, as a TT."""
    cfg = kit.cfg
    rk = st.rk.tolist()
    solved = kit.finalize_fn(st)
    return TT(tuple(solved[c, : rk[c], : cfg.n[c], : rk[c + 1]].clone()
                    for c in range(cfg.d)))


# kwargs of ttcross_tpu's cross() that the port does not run yet, with the
# ROADMAP queue 1 item that ports them
_NOT_PORTED = {
    "host_reeval": 7, "return_pivots": 7, "rank_chunks": 7, "rank_caps": 7,
    "adaptive": 7, "weighted_lottery": 7, "refine_sweeps": 7, "init_state": 7,
    "chain": 5,
}


def cross(
    fun: Callable,
    n: Sequence[int],
    max_rank: int = 20,
    accuracy: float | None = None,
    pivoting: int = 1,
    quad: Sequence | None = None,
    truth: float | None = None,
    key: int = 0,
    dtype: torch.dtype = torch.float64,
    verbose: bool = False,
    use_pallas: bool = False,
    init_state: CrossState | None = None,
    return_state: bool = False,
    return_pivots: bool = False,
    host_reeval=None,
    max_sweeps: int | None = None,
    small_element: float | None = None,
    small_pivot: float | None = None,
    rank_chunks=None,
    weighted_lottery: bool = False,
    oversample: int = 0,
    refine_sweeps: int = 0,
    sweep_mode: str = "sequential",
    rank_caps=None,
    adaptive: float | bool = 0.0,
    chain=None,
    device: str | torch.device = "cpu",
) -> CrossResult:
    """Approximate the black-box tensor fun in TT format by DMRG-greedy
    cross interpolation; the signature of ttcross_tpu.cross.cross plus
    ``device``, which places the state (fun must accept int32 index
    tensors on that device).

    fun: batched integrand, ind (B, d) int32 -> (B,) values.
    n: per-mode sizes.  max_rank: padded/maximum TT rank.  accuracy: stop
    when max accepted pivot <= accuracy * amax for 3 consecutive sweeps.
    pivoting: -1 full / 0 lottery / k>=1 rook with up to 2k passes.
    quad: per-mode weight vectors -> per-sweep value and error.
    oversample: cross at max_rank + oversample, then TT-SVD-round to
    max_rank.  key: seed of the CPU torch.Generator that draws the lottery
    uniforms, so CPU and CUDA runs see the same draws.
    use_pallas: accepted for API parity and changes nothing: on a CUDA
    state the hand-written kernels always run, on a CPU state their plain
    versions.  Not ported yet (NotImplementedError): host_reeval,
    return_pivots, rank_chunks, rank_caps, adaptive, weighted_lottery,
    refine_sweeps, init_state, chain, and sweep_mode 'jacobi'/'jacobi-rb'."""
    return _cross(fun, n, max_rank=max_rank, accuracy=accuracy,
                  pivoting=pivoting, quad=quad, truth=truth, key=key,
                  dtype=dtype, verbose=verbose, return_state=return_state,
                  max_sweeps=max_sweeps, small_element=small_element,
                  small_pivot=small_pivot, oversample=oversample,
                  sweep_mode=sweep_mode, device=device,
                  not_ported=dict(host_reeval=host_reeval,
                                  return_pivots=return_pivots,
                                  rank_chunks=rank_chunks, rank_caps=rank_caps,
                                  adaptive=adaptive,
                                  weighted_lottery=weighted_lottery,
                                  refine_sweeps=refine_sweeps,
                                  init_state=init_state, chain=chain))


def _cross(fun, n, *, max_rank, accuracy, pivoting, quad, truth, key, dtype,
           verbose, return_state, max_sweeps, small_element, small_pivot,
           oversample, sweep_mode, device, not_ported=None, uniforms=None):
    """cross() with one more input: uniforms, (max_sweeps, d-1, 2, NLOT)
    lottery uniforms of the (possibly oversampled) run in place of the
    key's draws; the tests feed the JAX engine's draws through it."""
    for name, val in (not_ported or {}).items():
        if val is not None and val is not False and val != 0:
            raise NotImplementedError(
                f"cross({name}=...) is not ported to ttcross_tpu_torch yet "
                f"(ROADMAP queue 1 item {_NOT_PORTED[name]})")
    if sweep_mode in ("jacobi", "jacobi-rb"):
        raise NotImplementedError(
            f"sweep_mode={sweep_mode!r} is not ported to ttcross_tpu_torch "
            "yet (ROADMAP queue 1 item 5)")
    if sweep_mode != "sequential":
        raise ValueError(f"unknown sweep_mode {sweep_mode!r}")
    if dtype != torch.float64:
        raise NotImplementedError("only dtype=torch.float64 is ported "
                                  "(ROADMAP queue 1 item 7)")
    n = tuple(int(x) for x in n)
    d = len(n)
    if d < 2:
        raise ValueError("cross requires d >= 2")
    if max_rank < 2:
        raise ValueError("max_rank must be >= 2")
    if oversample:
        if return_state:
            raise ValueError("oversample is incompatible with state passing")
        res = _cross(fun, n, max_rank=max_rank + int(oversample),
                     accuracy=accuracy, pivoting=pivoting, quad=quad,
                     truth=truth, key=key, dtype=dtype, verbose=verbose,
                     return_state=False, max_sweeps=max_sweeps,
                     small_element=small_element, small_pivot=small_pivot,
                     oversample=0, sweep_mode=sweep_mode, device=device,
                     uniforms=uniforms)
        return round_and_revalue(res, max_rank, quad, truth)

    se, sp = precision_thresholds(dtype)
    if small_element is not None:
        se = float(small_element)
    if small_pivot is not None:
        sp = float(small_pivot)
    cfg = CrossConfig(d=d, n=n, N=max(n), R=max_rank, piv=int(pivoting),
                      small_element=se, small_pivot=sp)
    dev = torch.device(device)
    kit = make_engine(fun, cfg, dev, dtype)
    if max_sweeps is None:
        max_sweeps = max_rank - 1
    NLOT = 2 * (cfg.R + cfg.N)
    if uniforms is None:
        gen = torch.Generator(device="cpu").manual_seed(int(key))
        uniforms = torch.rand((max(max_sweeps, 1), d - 1, 2, NLOT), generator=gen,
                              dtype=torch.float64)
    uniforms = torch.as_tensor(uniforms, dtype=torch.float64).to(dev)
    if uniforms.shape[0] < max_sweeps or uniforms.shape[1:] != (d - 1, 2, NLOT):
        raise ValueError(f"uniforms must be ({max_sweeps}, {d - 1}, 2, {NLOT}), "
                         f"got {tuple(uniforms.shape)}")

    t0 = time.perf_counter()
    with_quad = quad is not None
    w = torch.zeros((d, cfg.N), dtype=dtype, device=dev)
    if with_quad:
        for c in range(d):
            w[c, : n[c]] = torch.as_tensor(np.asarray(quad[c]), dtype=dtype)

    st = kit.init_fn()
    vals = torch.zeros(max_sweeps + 1, dtype=dtype, device=dev)
    pmax = torch.zeros(max_sweeps + 1, dtype=dtype, device=dev)
    nev = torch.zeros(max_sweeps + 1, dtype=torch.int64, device=dev)
    if with_quad:
        vals[0] = kit.value_fn(st, w)
    last_it, strike = 0, 0
    for it in range(1, max_sweeps + 1):
        st = kit.sweep_fn(st, it, uniforms[it - 1])
        if with_quad:
            vals[it] = kit.value_fn(st, w)
        pmax[it] = st.pivotmax
        nev[it] = st.neval
        last_it = it
        if accuracy is not None:
            # the one host sync per sweep: the strike-based stop
            # (dmrgg.f90:1010-1019)
            quiet = bool(st.pivotmax <= accuracy * st.amax)
            strike = strike + 1 if quiet else 0
            if strike >= 3:
                break

    vals_h, pmax_h, nev_h = vals.cpu().numpy(), pmax.cpu().numpy(), nev.cpu().numpy()
    values, errors = _values_errors(vals_h, last_it, truth, with_quad)
    history = history_from_run(last_it, vals_h, pmax_h, nev_h, truth, with_quad)
    if verbose:
        for rec in history:
            line = (f"{rec.it:3d}{rec.direction} n_evals: {rec.n_evals:10d} "
                    f"pivotmax {rec.pivotmax:9.3e}")
            if rec.err is not None:
                line += f" err {rec.err:9.3e} val {rec.value:.14e}"
            elif rec.cnv is not None:
                line += f" cnv {rec.cnv:9.3e} val {rec.value:.14e}"
            print(line)
    res = CrossResult(
        tt=finalize(st, kit), neval=int(st.neval), sweeps=last_it,
        ranks=tuple(st.rk.tolist()), values=values, errors=errors,
        time=time.perf_counter() - t0,
        converged=accuracy is not None and last_it < max_sweeps,
        history=history, padded_evals=int(st.padded))
    if return_state:
        res.state = st
    return res
