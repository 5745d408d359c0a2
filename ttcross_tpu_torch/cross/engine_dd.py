"""Double-double DMRG-greedy cross engine (pivot selection beyond f64).

Counterpart of ttcross_tpu/cross/engine_dd.py, the full mptt_dmrgg
analogue (dmrggmp.f90:11-704): every value the engine touches (fibers,
factors, residuals, the maintained inverses) is a double-double pair, so
the greedy residual hunt keeps finding pivots far below the f64 noise
floor (~1e-16 |A|), where the f64 engine (and hence defect correction,
cross/defect.py) stalls.  Selection decisions (argmax, thresholds) compare
the hi parts.  Single device, rook pivoting, stopping on maxrank /
quiet-pivot strikes; per-sweep values via dd contraction of the current
cross.  The integrand is a dd function fun_dd(ind (B, d) int32) -> DD,
e.g. apps/ising.py::make_ising_dd's.

The engine is eager, like the port's f64 engine: a Python loop over bonds
and over the 2 max(piv, 1) rook passes, the sweep direction a host int,
the accept a masked write of every piece (a rejected pivot leaves the
state as it was), so nothing inside a sweep waits for the device; the one
host sync per sweep is the stop rule's read of pivotmax and amax.  The dd
arithmetic runs in the dd kernels of ops/kernels.py: the lottery and the
rook passes' residual argmax (D1), the accept's products (D1 without a
mask) and small GEMMs (D4); the rest are ops/dd.py's plain operations.
The state is updated in place.

Thresholds and magnitude tracking live in the LOG10 DOMAIN, exactly like
the reference's mp engine (dmrggmp.f90:50-53, 107, 364): DDState.amax /
pivotmax / pivotmax_prev hold log10 magnitudes, and acceptance compares
log10|pivot| > log10(small) + log10(amax).  A linear-domain product
small_element * amax underflows (flushes to 0, accepting everything and
never stopping) once amax drops below ~1e-278 on binary64, while integrand
families like the rescaled Ising D/E span exactly such ranges.

The lottery: the JAX engine splits its PRNG key once per bond visit and
draws integers below a bound that depends on the state
(jax.random.randint, :249-259).  The port draws the same kind of integer,
floor(u * count) from uniforms u that a torch.Generator seeded by `key`
makes for the whole run up front (one copy to the device, no sync); the
test-only hook ``draws`` replaces them (the tests replay JAX's key chain).

While a torch.profiler session is active, cross_dd records the qd engine's
spans (utils/metrics.py::span) where they mean the same: the root cross_dd
[d, n, max_rank], engine.init (the kit, the initial cross, the draws),
engine.sweep [it] (its bond visits and the stop rule's read),
engine.hunt [bond] (the lottery, the rook passes and the accept test),
engine.accept [bond] (the masked writes and the inverses' update),
engine.value (the dd contraction: the solve's value, and each sweep's with
verbose) and dd.solve (the solved cores and their host copies).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from decimal import Decimal, localcontext
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..ops.dd import DD, _contract_pairs, dd_div, dd_neg
from ..ops.dense import masked_slot_write
from ..ops.kernels import MASK_X, MASK_Y, dd_dot, dd_score_residual_argmax
from ..utils.metrics import span
from .chains import (advance_left, advance_right, all_left_tables, all_right_tables,
                     assemble_indices)

__all__ = ["DDConfig", "DDState", "DDCrossResult", "DDKit", "cross_dd", "dd_quad_cores",
           "get_dd_engine", "key_draws"]


@dataclass(frozen=True)
class DDConfig:
    d: int
    n: tuple
    N: int
    R: int
    piv: int
    small_element: float
    small_pivot: float
    snum: int = 8


class DDState(NamedTuple):
    cores: DD   # (d, R, N, R)
    colf: DD
    rowf: DD
    itl: DD     # (d-1, R, R) maintained L^-1
    itt: DD     # (d-1, R, R) maintained T^-1
    rk: torch.Tensor          # (d+1,) int32
    vip: torch.Tensor         # (d-1, R, 4) int32
    amax: torch.Tensor        # LOG10 of the max |entry| seen (dmrggmp.f90:107)
    pivotmax: torch.Tensor    # LOG10 of the sweep's max accepted |pivot|
    pivotmax_prev: torch.Tensor  # LOG10; -inf marks "nothing yet"
    neval: torch.Tensor       # int64


@dataclass
class DDCrossResult:
    cores_hi: list
    cores_lo: list
    value: tuple              # (hi, lo) quadrature value
    neval: int
    sweeps: int
    ranks: tuple
    vip: np.ndarray = None    # (d-1, R, 4) the pivots (i, j, k, q) of every bond, host numpy


class DDKit(NamedTuple):
    """The dd engine's phases and the per-bond pieces the distributed dd
    engine (parallel/engine_dd.py) builds on."""

    init_fn: Callable
    sweep_fn: Callable
    finalize_fn: Callable
    visit_bond: Callable
    eval_col: Callable
    eval_row: Callable
    cfg: "DDConfig"
    value_fn: Callable = None
    value_mat: Callable = None


def _ddz(shape, dev) -> DD:
    return DD(torch.zeros(shape, dtype=torch.float64, device=dev),
              torch.zeros(shape, dtype=torch.float64, device=dev))


def _sel(x: DD, *idx) -> DD:
    return DD(x.hi[idx], x.lo[idx])


def _map(f, x: DD) -> DD:
    return DD(f(x.hi), f(x.lo))


def _l10max(x) -> torch.Tensor:
    """log10(max|x|); -inf for an all-zero block (no NaN): magnitudes stay
    in the log domain end to end, so no threshold product can underflow
    (dmrggmp.f90:50-53)."""
    return torch.log10(x.abs().max())


def _mm(a: DD, b: DD) -> DD:
    """(M, T) @ (T, K) in dd, a the left factor of every product
    (dd_sum(dd_mul(a[:, :, None], b[None]), axis=1)): D4."""
    M, T = a.hi.shape
    K = b.hi.shape[1]
    return dd_dot(_map(lambda t: t[:, None, :].expand(M, K, T), a),
                  _map(lambda t: t.T[None].expand(M, K, T), b))


def _vm(v: DD, m: DD) -> DD:
    """(T,) @ (T, K) in dd, v the left factor: dd_sum(dd_mul(v[:, None], m),
    axis=0)."""
    out = _mm(_map(lambda t: t[None], v), m)
    return _sel(out, 0)


def get_dd_engine(fun_dd: Callable, cfg: DDConfig, device="cuda") -> DDKit:
    """The dd engine's phases for (fun_dd, cfg) on `device` (eager: nothing
    is compiled, so nothing is cached as the JAX package caches its jitted
    kit)."""
    d, N, R = cfg.d, cfg.N, cfg.R
    n = cfg.n
    dev = torch.device(device)
    n_t = torch.tensor(n, device=dev)
    NLOT = 2 * (R + N)
    iR = torch.arange(R, device=dev)
    iN = torch.arange(N, device=dev)
    lot = torch.arange(NLOT, device=dev)
    col_i, col_j = iR.repeat_interleave(N), iN.repeat(R)     # (R*N,): i*N + j
    row_k, row_q = iN.repeat_interleave(R), iR.repeat(N)     # (N*R,): k*R + q
    # acceptance thresholds in log10 (dmrggmp.f90:50-53); the public API
    # keeps linear small_element / small_pivot for parity with the f64 tier
    lse = float(np.log10(cfg.small_element))
    lsp = float(np.log10(cfg.small_pivot))

    def mask2(st, p, rows_rank: bool):
        if rows_rank:
            return (iR[:, None] < st.rk[p]) & (iN[None, :] < n[p])          # (R, N)
        return (iN[:, None] < n[p + 1]) & (iR[None, :] < st.rk[p + 2])      # (N, R)

    def _zero_masked(x: DD, m) -> DD:
        return DD(torch.where(m, x.hi, 0.0), torch.where(m, x.lo, 0.0))

    def init_fn() -> DDState:
        """Initial pivot search over shifted diagonals + rank-1 cross
        (dmrgg.f90:151-248)."""
        nn = int(min(n))
        ks = torch.arange(nn, device=dev)[None, :, None]
        ss = torch.arange(cfg.snum, device=dev)[:, None, None]
        ps = torch.arange(d, device=dev)[None, None, :]
        cand = ((ks + ss * ps) % n_t[None, None, :]).reshape(-1, d).to(torch.int32)
        vals = fun_dd(cand)
        best = torch.argmax(vals.hi.abs()).view(1)   # a (1,) index: no host sync
        amax = torch.log10(vals.hi.index_select(0, best).abs())[0]
        ind0 = cand.index_select(0, best)[0]                          # (d,)

        vip = torch.zeros((d - 1, R, 4), dtype=torch.int32, device=dev)
        vip[:, 0, 1] = ind0[:-1]
        vip[:, 0, 2] = ind0[1:]

        mode_pos = torch.arange(d, device=dev).repeat_interleave(N)
        mode_val = iN.repeat(d)
        col = torch.arange(d, device=dev)
        fib_ind = torch.where(col[None, :] == mode_pos[:, None],
                              torch.minimum(mode_val, n_t[mode_pos] - 1)[:, None],
                              ind0[None, :].long())
        fv = fun_dd(fib_ind.to(torch.int32))
        fvals = _zero_masked(DD(fv.hi.reshape(d, N), fv.lo.reshape(d, N)),
                             iN[None, :] < n_t[:, None])
        amax = torch.maximum(amax, _l10max(fvals.hi))

        cores = _ddz((d, R, N, R), dev)
        cores.hi[:, 0, :, 0] = fvals.hi
        cores.lo[:, 0, :, 0] = fvals.lo
        delta = _map(lambda t: t[0].index_select(0, ind0[:1].long())[0], fvals)
        colf0 = dd_div(fvals, _map(lambda t: t.expand(d, N), delta))
        colf = _ddz((d, R, N, R), dev)
        colf.hi[:, 0, :, 0] = colf0.hi
        colf.lo[:, 0, :, 0] = colf0.lo
        rowf = DD(cores.hi.clone(), cores.lo.clone())
        eye = torch.eye(R, dtype=torch.float64, device=dev).expand(d - 1, R, R)
        inv_delta = dd_div(DD(torch.ones_like(delta.hi), torch.zeros_like(delta.hi)), delta)
        itl = DD(eye.clone(), torch.zeros_like(eye))
        itt = DD(eye.clone(), torch.zeros_like(eye))
        itt.hi[:, 0, 0] = inv_delta.hi
        itt.lo[:, 0, 0] = inv_delta.lo
        neval = torch.tensor(cfg.snum * nn + int(sum(n)), dtype=torch.int64, device=dev)
        return DDState(cores=cores, colf=colf, rowf=rowf, itl=itl, itt=itt,
                       rk=torch.ones((d + 1,), dtype=torch.int32, device=dev), vip=vip,
                       amax=amax, pivotmax=torch.full((), -math.inf, dtype=torch.float64,
                                                      device=dev),
                       pivotmax_prev=amax.clone(), neval=neval)

    def eval_col(st, p, ltab, rtab, kk, qq):
        """Column fiber (R, N) at fixed (kk, qq), masked, with amax / neval."""
        ind = assemble_indices(ltab, rtab, p, col_i, col_j, kk.expand(R * N), qq.expand(R * N), d)
        v = fun_dd(ind)
        vals = _zero_masked(DD(v.hi.reshape(R, N), v.lo.reshape(R, N)), mask2(st, p, True))
        amax = torch.maximum(st.amax, _l10max(vals.hi))
        neval = st.neval + (st.rk[p] * n[p]).long()
        return vals, amax, neval

    def eval_row(st, p, ltab, rtab, ii, jj):
        """Row fiber (N, R) at fixed (ii, jj), masked, with amax / neval."""
        ind = assemble_indices(ltab, rtab, p, ii.expand(N * R), jj.expand(N * R), row_k, row_q, d)
        v = fun_dd(ind)
        vals = _zero_masked(DD(v.hi.reshape(N, R), v.lo.reshape(N, R)), mask2(st, p, False))
        amax = torch.maximum(st.amax, _l10max(vals.hi))
        neval = st.neval + (n[p + 1] * st.rk[p + 2]).long()
        return vals, amax, neval

    def visit_bond(st: DDState, p: int, fwd: bool, ltab, rtab, draw, own_lo=0, own_hi=d - 1):
        """Lottery, rook passes and (maybe) accept at bond p.  draw(count_c,
        count_r) -> (u_c, u_r): NLOT integers below max(count, 1) each.
        Returns (state, tape_i, tape_f) as the JAX engine's visit_bond."""
        with span("engine.hunt", bond=p):
            rk1 = st.rk[p + 1:p + 2]                     # the bond's rank, read on the card
            colmask = ((iR[:, None] < st.rk[p]) & (iN[None, :] < n[p])).reshape(-1)
            rowmask = ((iR[:, None] < st.rk[p + 2]) & (iN[None, :] < n[p + 1])).reshape(-1)
            vb = st.vip[p].long()
            smask = (iR < st.rk[p + 1]).to(torch.int32)
            used_col = torch.zeros(R * N, dtype=torch.int32, device=dev).scatter_reduce_(
                0, vb[:, 0] * N + vb[:, 1], smask, "amax")
            used_row = torch.zeros(N * R, dtype=torch.int32, device=dev).scatter_reduce_(
                0, vb[:, 3] * N + vb[:, 2], smask, "amax")
            cdf_c = torch.cumsum((colmask & (used_col == 0)).long(), 0)
            cdf_r = torch.cumsum((rowmask & (used_row == 0)).long(), 0)
            u_c, u_r = draw(cdf_c[-1], cdf_r[-1])
            lin_c = torch.searchsorted(cdf_c, u_c.long(), right=True)
            lin_r = torch.searchsorted(cdf_r, u_r.long(), right=True)
            # a pick past the end (no candidate left) clamps per axis, as JAX's gathers do
            i_c, j_c = (lin_c // N).clamp(max=R - 1), lin_c % N
            q_c, k_c = (lin_r // N).clamp(max=R - 1), lin_r % N
            nlot_act = st.rk[p] + n[p] + n[p + 1] + st.rk[p + 2]
            candmask = lot < nlot_act

            b = fun_dd(assemble_indices(ltab, rtab, p, i_c, j_c, k_c, q_c, d))
            amax = torch.maximum(st.amax, _l10max(torch.where(candmask, b.hi.abs(), 0.0)))
            st = st._replace(amax=amax, neval=st.neval + nlot_act.long())

            colf_p = _sel(st.colf, p)                                       # (R, N, R)
            rowf_p1 = _sel(st.rowf, p + 1)
            cf = _map(lambda t: t.reshape(R * N, R).index_select(0, i_c * N + j_c), colf_p)
            rf = _map(lambda t: t.reshape(R, N * R).index_select(1, k_c * R + q_c).T, rowf_p1)
            _, best, pivot = dd_score_residual_argmax(b, cf, rf, rk1, candmask, MASK_X)
            # the pivot's (i, j, k, q) as (1,) tensors: indexing with a 0-d
            # tensor would read it on the host
            best = best.view(1)
            ii, jj, kk, qq = (x.index_select(0, best) for x in (i_c, j_c, k_c, q_c))

            def col_of_rowf(k, q):      # rowf[p+1][:, k, q], (R,)
                return _map(lambda x: x.reshape(R, N * R).index_select(1, k * R + q)[:, 0], rowf_p1)

            def row_of_colf(i, j):      # colf[p][i, j, :], (R,)
                return _map(lambda x: x.reshape(R * N, R).index_select(0, i * N + j)[0], colf_p)

            # rook passes (fixed 2*piv alternating passes; the LAST pass
            # evaluates the fiber at the chosen indices but does not move them)
            acol, arow = _ddz((R, N), dev), _ddz((N, R), dev)
            colf_flat = _map(lambda t: t.reshape(R * N, R), colf_p)
            rowf_t = _map(lambda t: t.reshape(R, N * R).T, rowf_p1)        # (N*R, R) view
            n_passes = 2 * max(cfg.piv, 1)
            for t in range(n_passes):
                last = t == n_passes - 1
                if (t % 2 == 0) == fwd:                                     # column pass
                    acol, amax, neval = eval_col(st, p, ltab, rtab, kk, qq)
                    st = st._replace(amax=amax, neval=neval)
                    u = _map(lambda x: x.expand(R * N, R), col_of_rowf(kk, qq))
                    _, flat, piv2 = dd_score_residual_argmax(
                        _map(lambda x: x.reshape(-1), acol), colf_flat, u, rk1,
                        mask2(st, p, True).reshape(-1), MASK_Y)
                    if not last:
                        ii, jj, pivot = flat.view(1) // N, flat.view(1) % N, piv2
                else:                                                       # row pass
                    arow, amax, neval = eval_row(st, p, ltab, rtab, ii, jj)
                    st = st._replace(amax=amax, neval=neval)
                    c = _map(lambda x: x.expand(N * R, R), row_of_colf(ii, jj))
                    _, flat, piv2 = dd_score_residual_argmax(
                        _map(lambda x: x.reshape(-1), arow), c, rowf_t, rk1,
                        mask2(st, p, False).reshape(-1), MASK_X)
                    if not last:
                        kk, qq, pivot = flat.view(1) // R, flat.view(1) % R, piv2

            # two-threshold acceptance in log10 (dmrggmp.f90:50-53, 364):
            # log10|pivot| must clear lse + lg(amax) and lsp + lg(pivotmax');
            # an exact-zero pivot gives -inf and is always rejected
            lpiv = torch.log10(pivot.hi.abs())
            upd = (lpiv > lse + st.amax) & (lpiv > lsp + st.pivotmax_prev) & (st.rk[p + 1] < R)

        with span("engine.accept", bond=p):
            s = st.rk[p + 1].long()
            rmask = (iR < s).to(torch.float64)
            c_new = _map(lambda x: x * rmask, row_of_colf(ii, jj))          # (R,)
            u_new = _map(lambda x: x * rmask, col_of_rowf(kk, qq))          # (R,)
            # tape rows for the distributed engine: (accepted, i, j, k, q) ints
            # + dd borders and pivot (the JAX engine's :360-372)
            tape_i = torch.where(
                upd, torch.cat([torch.ones_like(ii), ii, jj, kk, qq]).to(torch.int32), 0)
            tape_f = torch.where(upd, torch.cat([c_new.hi, c_new.lo, u_new.hi, u_new.lo,
                                                 pivot.hi[None], pivot.lo[None]]), 0.0)

            # the accept's pieces, all from the state as it was before it
            pivB = _map(lambda x: x.expand(R * N), pivot)
            acol_f = _map(lambda x: x.reshape(-1), acol)
            arow_f = _map(lambda x: x.reshape(-1), arow)
            r_col, _, _ = dd_score_residual_argmax(acol_f, colf_flat,
                                                   _map(lambda x: x.expand(R * N, R), u_new))
            new_colf = dd_div(r_col, pivB)                                  # (R*N,)
            new_rowf, _, _ = dd_score_residual_argmax(
                arow_f, _map(lambda x: x.expand(N * R, R), c_new), rowf_t)  # (N*R,)
            itl_p, itt_p = _sel(st.itl, p), _sel(st.itt, p)
            row_raw = dd_neg(dd_score_residual_argmax(
                None, _map(lambda x: x.expand(R, R), c_new), _map(lambda x: x.T, itl_p))[0])
            one_hot = iR == s
            new_row = DD(torch.where(one_hot, 1.0, row_raw.hi),
                         torch.where(one_hot, 0.0, row_raw.lo))
            col_raw = dd_div(dd_neg(dd_score_residual_argmax(
                None, itt_p, _map(lambda x: x.expand(R, R), u_new))[0]),
                _map(lambda x: x.expand(R), pivot))
            inv_piv = dd_div(DD(torch.ones_like(pivot.hi), torch.zeros_like(pivot.hi)), pivot)
            new_col = DD(torch.where(one_hot, inv_piv.hi, col_raw.hi),
                         torch.where(one_hot, inv_piv.lo, col_raw.lo))
            left = _mm(_sel(st.itl, max(p - 1, 0)), acol) if p > own_lo else None       # (R, N)
            right = _mm(arow, _sel(st.itt, min(p + 1, d - 2))) if p < own_hi - 1 else None  # (N, R)

            slot = s.clamp(max=R - 1).view(1)      # a saturated bond never accepts
            u1 = upd.view(1)

            def put(buf: DD, index, dim, new: DD):
                for part, val in zip(buf, new):
                    masked_slot_write(part[index:index + 1], dim, slot, val[None], u1)

            masked_slot_write(st.vip[p:p + 1], 1, slot,
                              torch.cat([ii, jj, kk, qq]).to(torch.int32)[None], u1)
            put(st.cores, p, 3, acol)
            put(st.cores, p + 1, 1, arow)
            put(st.colf, p, 3, _map(lambda x: x.reshape(R, N), new_colf))
            put(st.rowf, p + 1, 1, _map(lambda x: x.reshape(N, R), new_rowf))
            put(st.itl, p, 1, new_row)
            put(st.itt, p, 2, new_col)
            if left is not None:
                put(st.rowf, p, 3, left)
            if right is not None:
                put(st.colf, p + 1, 1, right)
            st.rk[p + 1:p + 2] += u1.to(torch.int32)
            pivotmax = torch.where(upd, torch.maximum(st.pivotmax, lpiv), st.pivotmax)
        return st._replace(pivotmax=pivotmax), tape_i, tape_f

    def sweep_fn(st: DDState, it: int, draw) -> DDState:
        """One sweep, '>>' for odd it; draw(b, count_c, count_r) gives the
        b-th bond visit's lottery integers."""
        fwd = it % 2 == 1
        st = st._replace(pivotmax=torch.full_like(st.pivotmax, -math.inf))
        LT = all_left_tables(st.vip, d)
        RT = all_right_tables(st.vip, d)
        tab = torch.zeros((R, d), dtype=st.vip.dtype, device=dev)
        for b in range(d - 1):
            p = b if fwd else d - 2 - b
            ltab = tab if fwd else LT[p]
            rtab = RT[p] if fwd else tab
            st = visit_bond(st, p, fwd, ltab, rtab, lambda cc, cr: draw(b, cc, cr))[0]
            tab = advance_left(tab, st.vip[p], p) if fwd else advance_right(tab, st.vip[p], p - 1)
        return st._replace(pivotmax_prev=st.pivotmax)

    def value_mat(st: DDState, wh, wl, c: int) -> DD:
        """The LU-solved (R, R) dd contraction matrix of core c against dd
        weights (wh, wl)[c] (the ttqq core + mptt_lua application,
        dmrggmp.f90:655-672)."""
        g = _sel(st.cores, c)                                           # (R, N, R)
        m = dd_dot(_map(lambda x: x.permute(0, 2, 1), g),
                   DD(wh[c][None, None].expand(R, R, N), wl[c][None, None].expand(R, R, N)))
        if c > 0:
            m = _mm(_sel(st.itl, c - 1), m)
        if c < d - 1:
            m = _mm(m, _sel(st.itt, c))
        return m

    def value_fn(st: DDState, wh, wl) -> DD:
        """Per-sweep dd quadrature value of the CURRENT cross (the mp tier's
        in-loop value line, dmrggmp.f90:655-672), as 0-d tensors."""
        v = _ddz((R,), dev)
        v.hi[0] = 1.0
        for c in range(d):
            v = _vm(v, value_mat(st, wh, wl, c))
        return _sel(v, 0)

    def finalize_fn(st: DDState) -> DD:
        """The solved dd cores (d, R, N, R): itl of the left bond and itt of
        the right one applied to each raw core."""
        out = _ddz((d, R, N, R), dev)
        for c in range(d):
            g = _map(lambda x: x.reshape(R, N * R), _sel(st.cores, c))
            if c > 0:
                g = _mm(_sel(st.itl, c - 1), g)
            g = _map(lambda x: x.reshape(R * N, R), g)
            if c < d - 1:
                g = _mm(g, _sel(st.itt, c))
            out.hi[c] = g.hi.reshape(R, N, R)
            out.lo[c] = g.lo.reshape(R, N, R)
        return out

    return DDKit(init_fn=init_fn, sweep_fn=sweep_fn, finalize_fn=finalize_fn,
                 visit_bond=visit_bond, eval_col=eval_col, eval_row=eval_row,
                 cfg=cfg, value_fn=value_fn, value_mat=value_mat)


def dd_quad_cores(cores_hi, cores_lo, weights_hi, weights_lo) -> tuple:
    """dd quadrature of a dd train (mptt_quad, dmrggmp.f90:778-888):
    contract each core against its dd weight vector and chain the (r, r)
    products left to right (ops/dd.py's dd_contract body, D4 on the card);
    where the cores lie when they are tensors, else on the CPU.  Returns
    (hi, lo)."""
    dev = cores_hi[0].device if torch.is_tensor(cores_hi[0]) else torch.device("cpu")

    def t(a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               dtype=torch.float64).to(dev)

    v = _contract_pairs([DD(t(h), t(lo)) for h, lo in zip(cores_hi, cores_lo)],
                        [DD(t(h), t(lo)) for h, lo in zip(weights_hi, weights_lo)])
    return (float(v.hi), float(v.lo))


def key_draws(key: int, sweeps: int, d: int, nlot: int, device) -> Callable:
    """The lottery integers of a run with this key: draw_of(it) is sweep
    it's draw(b, count_c, count_r) -> (u_c, u_r), NLOT integers below
    max(count, 1) each, floor(u * count) of uniforms u that one
    torch.Generator(cpu).manual_seed(key) makes for the whole run (sweeps,
    d-1, 2, nlot) and copies to `device` once: no host sync per visit, and
    the same integers on the card and the CPU."""
    gen = torch.Generator(device="cpu").manual_seed(int(key))
    U = torch.rand((sweeps, d - 1, 2, nlot), generator=gen, dtype=torch.float64).to(device)

    def draw_of(it):
        def draw(b, count_c, count_r):
            out = []
            for side, count in ((0, count_c), (1, count_r)):
                top = torch.clamp(count, min=1)
                out.append(torch.minimum(torch.floor(U[it - 1, b, side] * top).long(), top - 1))
            return tuple(out)

        return draw

    return draw_of


def _pad_weights(weights, n, N, dev) -> torch.Tensor:
    w = np.zeros((len(n), N))
    for c in range(len(n)):
        w[c, : n[c]] = np.asarray(weights[c])
    return torch.from_numpy(w).to(dev)


def cross_dd(
    fun_dd: Callable,
    n: Sequence[int],
    weights_hi, weights_lo,
    max_rank: int = 32,
    accuracy: float = 1e-28,
    pivoting: int = 1,
    key: int = 0,
    small_element: float = 1e-30,
    small_pivot: float = 1e-12,
    verbose: bool = False,
    truth=None,
    device: str | torch.device = "cuda",
    draws: Callable | None = None,
) -> DDCrossResult:
    """Cross interpolation with dd pivot selection; returns the dd train and
    its quadrature value against dd weights (computed in dd on the device).
    The signature of ttcross_tpu.cross.engine_dd.cross_dd plus ``device``:
    the card unless the caller asks for ``device="cpu"`` (fun_dd must take
    int32 indices on that device).

    key seeds the CPU torch.Generator whose uniforms make the lottery's
    draws (key_draws), so CPU and CUDA runs draw the same.  With verbose, prints the mp
    tier's per-iteration value line (dmrggmp.f90:655-672): the CURRENT
    cross contracted against the dd weights each sweep, with err vs `truth`
    (a Decimal-compatible string or float) or cnv vs the previous sweep.
    draws (test-only): (visit, count_c, count_r) -> (u_c, u_r), the lottery
    integers of bond visit `visit` (0, 1, ... over the run), two int
    tensors of 2 (max_rank + max(n)) below max(count, 1) each, in place of
    the generator's."""
    n = tuple(int(x) for x in n)
    d = len(n)
    dev = torch.device(device)
    cfg = DDConfig(d=d, n=n, N=max(n), R=max_rank, piv=int(pivoting),
                   small_element=small_element, small_pivot=small_pivot)
    with span("cross_dd", d=d, n=n, max_rank=int(max_rank)):
        with span("engine.init"):
            kit = get_dd_engine(fun_dd, cfg, dev)
            st = kit.init_fn()
            if draws is None:
                draw_of = key_draws(key, max(max_rank - 1, 1), d, 2 * (cfg.R + cfg.N), dev)
            else:
                def draw_of(it):
                    return lambda b, cc, cr: draws((it - 1) * (d - 1) + b, cc, cr)

            wh_pad = wl_pad = None
            if verbose:   # per-sweep value telemetry only; skip the transfer otherwise
                wh_pad = _pad_weights(weights_hi, n, cfg.N, dev)
                wl_pad = _pad_weights(weights_lo, n, cfg.N, dev)
        lacc = float(np.log10(accuracy))
        val_prev = None
        strike = 0
        it = 0
        while it + 1 < max_rank:
            it += 1
            with span("engine.sweep", it=it):
                st = kit.sweep_fn(st, it, draw_of(it))
                pm = float(st.pivotmax)     # log10 magnitudes (dmrggmp.f90:50-53)
                am = float(st.amax)
                if verbose:
                    with span("engine.value"):
                        v = kit.value_fn(st, wh_pad, wl_pad)
                        val_prev = _print_sweep(it, pm, am, int(st.neval), v, truth, val_prev)
                if pm <= lacc + am:
                    strike += 1
                else:
                    strike = 0
            if strike >= 3:
                break

        with span("dd.solve"):
            solved = kit.finalize_fn(st)
            rk = st.rk.cpu().numpy()
            cores = [_map(lambda x: x[c][: rk[c], : n[c], : rk[c + 1]], solved) for c in range(d)]
            cores_hi = [g.hi.cpu().numpy() for g in cores]
            cores_lo = [g.lo.cpu().numpy() for g in cores]
            vip, neval = st.vip.cpu().numpy(), int(st.neval)
        with span("engine.value"):
            # dd quadrature of the dd train (mptt_quad), on the run's device
            value = dd_quad_cores([g.hi for g in cores], [g.lo for g in cores], weights_hi,
                                  weights_lo)
    return DDCrossResult(cores_hi=cores_hi, cores_lo=cores_lo, value=value, neval=neval,
                         sweeps=it, ranks=tuple(int(x) for x in rk), vip=vip)


def _print_sweep(it, pm, am, neval, v, truth, val_prev):
    """The mp tier's per-iteration value line (dmrggmp.f90:655-672) of the
    sweep's dd value v; returns the value as a Decimal, the next line's
    val_prev."""
    with localcontext() as ctx:
        ctx.prec = 50
        val = Decimal(float(v.hi)) + Decimal(float(v.lo))
        if truth is not None:
            rel = abs(1 - val / Decimal(truth if isinstance(truth, str) else float(truth)))
            tag = f"err {float(rel):9.3e}"
        elif val_prev not in (None, 0):
            tag = f"cnv {float(abs(1 - val / val_prev)):9.3e}"
        else:
            tag = ""
        print(f"{it:3d}{'>>' if it % 2 == 1 else '<<'} dd "
              f"lg(pivotmax) {pm:8.2f} lg(amax) {am:8.2f} "
              f"n_evals {neval} {tag} val {val:.32e}")
    return val
