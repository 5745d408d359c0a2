"""Arbitrary-precision DMRG-greedy cross engine (the mptt_dmrgg analogue).

A copy of ttcross_tpu/cross/engine_mp.py, the full-precision mirror of the
reference's multiprecision tier (dmrggmp.f90:11-704): every value (fibers,
factors, residuals, the bordered triangular inverses, the per-sweep
quadrature) is an mpmath mpf at a configurable working precision (default
120 decimal digits, the reference's compile-time `mpipl`, mpfunf.f90:63).
Like the reference's MPFUN tier and the JAX package's, this path is host
code by design (ttcross_tpu/ops/mp.py:1-17): cross_mp takes no device and
touches no torch tensor; the card's tiers are f64, dd and qd.

Reference-fidelity notes:
  * thresholds and `amax` live in the log10 domain (dmrggmp.f90:50-53,
    107, 364): `small_element = -dps + 2`, `small_pivot = -7`, so crosses
    survive dynamic ranges far beyond f64 exponents (the D/E rescaling
    regime, test_crs_ising.f90:135-144).
  * a per-iteration quadrature value and err/cnv line is produced
    (dmrggmp.f90:655-672).
  * ragged host arrays grow rank by rank like the Fortran
    reallocate-on-accept pattern.

The hunt is rook pivoting (lottery seed + alternating column/row
maximization with stationarity exit, dmrgg.f90:410-582); the lottery draws
from np.random.default_rng(seed), so a run equals the JAX package's string
for string.  The engine body lives in the MpEngine class so the
distributed driver (parallel/engine_mp.py, the reference's MPI-parallel mp
path, dmrggmp.f90:518-629) reuses the bond-visit / accept / replay logic
per worker process while owning only a bond slab."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
from mpmath import mp, mpf

from ..ops.mp import mag10, mp_zeros, workdps
from .hostwalk import walk_index

__all__ = ["cross_mp", "MpCrossResult", "mp_tt_value", "MpEngine"]


@dataclass
class MpCrossResult:
    cores: list              # solved ragged object arrays (r, n, r')
    value: object            # mpf quadrature value (None without quad)
    neval: int
    sweeps: int
    ranks: tuple
    history: list            # per-sweep dicts {it, dir, pivotmax_log10, value, err}


def _value_chain(G, itl, itt, w, d):
    """LU-solved quadrature contraction: prod_c itl[c-1] (sum_j G_c w_cj)
    itt[c] (ttqq + mptt_lua + mptt_quad, dmrggmp.f90:640-672)."""
    v = None
    for c in range(d):
        M = np.tensordot(G[c], w[c][: G[c].shape[1]], axes=[[1], [0]])
        if c > 0:
            M = itl[c - 1] @ M
        if c < d - 1:
            M = M @ itt[c]
        v = M if v is None else v @ M
    return v[0, 0]


def mp_tt_value(cores, w):
    """Plain quadrature contraction of a solved mp train (mptt_quad)."""
    v = None
    for c, G in enumerate(cores):
        M = np.tensordot(G, w[c][: G.shape[1]], axes=[[1], [0]])
        v = M if v is None else v @ M
    return v[0, 0]


class MpEngine:
    """Host-side mp cross state + bond-visit machinery.

    The single-process driver (cross_mp) owns all bonds; a distributed
    worker (parallel/engine_mp.py) owns a slab [own_lo, own_hi) and calls
    visit_bond only there, replaying remote accepts from tape records."""

    def __init__(self, fun_mp, n, max_rank, pivoting, dps,
                 small_element_log10, small_pivot_log10, snum, seed):
        self.fun_mp = fun_mp
        self.n = tuple(int(x) for x in n)
        self.d = len(self.n)
        self.max_rank = int(max_rank)
        self.piv = max(int(pivoting), 0)
        self.dps = dps
        self.lse = (small_element_log10 if small_element_log10 is not None
                    else -dps + 2)
        self.lsp = small_pivot_log10
        self.snum = snum
        self.rng = np.random.default_rng(seed)
        self.neval = 0
        # distributed mode: the set of locally-owned (authoritative) cores;
        # None = single process, every core is local.  A slab's LAST bond
        # has its right core owned by the next worker, which stores the
        # accepted row fiber from the tape instead (dmrggmp.f90:518-629).
        self.own_cores = None

    # ------------------------------------------------ initial pivot search
    def init_state(self):
        """Shifted-diagonal search + rank-1 cross (dmrgg.f90:151-248).
        Deterministic: every distributed worker computes the identical
        initial state."""
        n, d = self.n, self.d
        nn = min(n)
        cand = np.zeros((self.snum * nn, d), dtype=np.int64)
        for s in range(self.snum):
            for k in range(nn):
                cand[s * nn + k] = [(k + s * p) % n[p] for p in range(d)]
        vals = self.fun_mp(cand)
        self.neval += len(cand)
        best = int(max(range(len(vals)), key=lambda i: abs(vals[i])))
        self.log_amax = mag10(vals[best])
        ind0 = cand[best]

        self.vip = [[(0, int(ind0[b]), int(ind0[b + 1]), 0)]
                    for b in range(d - 1)]
        self.r = [1] * (d + 1)

        self.G = []
        for c in range(d):
            fib = np.tile(ind0, (n[c], 1))
            fib[:, c] = np.arange(n[c])
            fv = self.fun_mp(fib)
            self.neval += n[c]
            self.log_amax = max(self.log_amax, max(mag10(v) for v in fv))
            self.G.append(fv.reshape(1, n[c], 1))
        delta = self.G[0][0, ind0[0], 0]
        self.Cf = [self.G[b] / delta for b in range(d - 1)]
        self.Rf = [self.G[b + 1].copy() for b in range(d - 1)]
        self.itl = [np.array([[mpf(1)]], dtype=object) for _ in range(d - 1)]
        self.itt = [np.array([[1 / delta]], dtype=object) for _ in range(d - 1)]
        self.log_pivotmax_prev = self.log_amax

    # ------------------------------------------------------- fiber batches
    def eval_col(self, b, kk, qq):
        """Raw column fiber (r[b], n[b]) at fixed (kk, qq)."""
        r, n, vip, d = self.r, self.n, self.vip, self.d
        idx = np.array([walk_index(vip, b, d, i, j, kk, qq)
                        for i in range(r[b]) for j in range(n[b])],
                       dtype=np.int64)
        v = self.fun_mp(idx)
        self.neval += len(idx)
        return v.reshape(r[b], n[b])

    def eval_row(self, b, ii, jj):
        r, n, vip, d = self.r, self.n, self.vip, self.d
        idx = np.array([walk_index(vip, b, d, ii, jj, k, q)
                        for k in range(n[b + 1]) for q in range(r[b + 2])],
                       dtype=np.int64)
        v = self.fun_mp(idx)
        self.neval += len(idx)
        return v.reshape(n[b + 1], r[b + 2])

    @staticmethod
    def _argmax_abs(a):
        flat = a.reshape(-1)
        bi = int(max(range(flat.size), key=lambda i: abs(flat[i])))
        return np.unravel_index(bi, a.shape)

    # --------------------------------------------------------- bond visit
    def visit_bond(self, b, dir_fwd):
        """Hunt + (maybe) accept at owned bond b.  Returns a tape record
        (dict) when a pivot was accepted, else None.  The tape carries
        everything a non-owner needs to replay: the pivot tuple, the LU
        border vectors, and the raw fibers (the reference ships the same
        boundary blocks over MPI, dmrggmp.f90:518-629)."""
        r, n, vip, d = self.r, self.n, self.vip, self.d
        Cf, Rf = self.Cf, self.Rf
        piv = self.piv
        used_c = {(pv[0], pv[1]) for pv in vip[b]}
        used_r = {(pv[2], pv[3]) for pv in vip[b]}
        all_c = [(i, j) for i in range(r[b]) for j in range(n[b])
                 if (i, j) not in used_c]
        all_r = [(k, q) for k in range(n[b + 1]) for q in range(r[b + 2])
                 if (k, q) not in used_r]
        if not all_c or not all_r:
            return None
        nlot = r[b] + n[b] + n[b + 1] + r[b + 2]
        sel_c = [all_c[i] for i in self.rng.integers(0, len(all_c), nlot)]
        sel_r = [all_r[i] for i in self.rng.integers(0, len(all_r), nlot)]
        idx = np.array([walk_index(vip, b, d, i, j, k, q)
                        for (i, j), (k, q) in zip(sel_c, sel_r)],
                       dtype=np.int64)
        bvals = self.fun_mp(idx)
        self.neval += nlot
        self.log_amax = max(self.log_amax, max(mag10(v) for v in bvals))
        resid = [bvals[t]
                 - np.dot(Cf[b][sel_c[t][0], sel_c[t][1], :],
                          Rf[b][:, sel_r[t][0], sel_r[t][1]])
                 for t in range(nlot)]
        bi = int(max(range(nlot), key=lambda t: abs(resid[t])))
        (ii, jj), (kk, qq) = sel_c[bi], sel_r[bi]
        pivot = resid[bi]

        # rook passes (dmrgg.f90:515-582)
        acol = arow = None
        havecol = haverow = False
        crs = 0
        skipcol = not dir_fwd
        done = piv == 0
        if piv == 0:
            acol = self.eval_col(b, kk, qq)
            arow = self.eval_row(b, ii, jj)
            havecol = haverow = True
        while not done:
            if not skipcol:
                acol = self.eval_col(b, kk, qq)
                havecol = True
                crs += 1
                if not (havecol and haverow and crs >= 2 * piv):
                    bcol = acol - np.tensordot(Cf[b], Rf[b][:, kk, qq],
                                               axes=[[2], [0]])
                    i2, j2 = self._argmax_abs(bcol)
                    stat = havecol and haverow and (i2, j2) == (ii, jj)
                    ii, jj, pivot = int(i2), int(j2), bcol[i2, j2]
                    if stat:
                        break
                else:
                    break
            skipcol = False
            arow = self.eval_row(b, ii, jj)
            haverow = True
            crs += 1
            if not (havecol and haverow and crs >= 2 * piv):
                brow = arow - np.tensordot(Cf[b][ii, jj, :], Rf[b],
                                           axes=[[0], [0]])
                k2, q2 = self._argmax_abs(brow)
                stat = havecol and haverow and (k2, q2) == (kk, qq)
                kk, qq, pivot = int(k2), int(q2), brow[k2, q2]
                if stat:
                    break
            else:
                break
        if not havecol:
            acol = self.eval_col(b, kk, qq)
        if not haverow:
            arow = self.eval_row(b, ii, jj)
        self.log_amax = max(self.log_amax,
                            max(mag10(v) for v in acol.reshape(-1)),
                            max(mag10(v) for v in arow.reshape(-1)))

        # two-threshold accept, log domain (dmrggmp.f90:364)
        lp = mag10(pivot)
        if not (lp > self.lse + self.log_amax
                and lp > self.lsp + self.log_pivotmax_prev
                and r[b + 1] < self.max_rank):
            return None
        c_new = Cf[b][ii, jj, :].copy()
        u_new = Rf[b][:, kk, qq].copy()
        self._accept_owner(b, ii, jj, kk, qq, pivot, acol, arow,
                           c_new, u_new)
        return {"b": b, "ijkq": (ii, jj, kk, qq), "pivot": pivot,
                "c_new": c_new, "u_new": u_new, "acol": acol, "arow": arow,
                "lp": lp}

    def _accept_owner(self, b, ii, jj, kk, qq, pivot, acol, arow,
                      c_new, u_new):
        """Owner-side accept: extend vip / cores / factors / inverses
        (dmrggmp.f90 mirror of dmrgg.f90:602-757), except the cross-slab
        neighbour slices (apply_left_slice / apply_right_slice)."""
        self.vip[b].append((int(ii), int(jj), int(kk), int(qq)))
        if self.own_cores is None or b in self.own_cores:
            self.G[b] = np.concatenate([self.G[b], acol[:, :, None]], axis=2)
        if self.own_cores is None or (b + 1) in self.own_cores:
            self.G[b + 1] = np.concatenate([self.G[b + 1], arow[None, :, :]],
                                           axis=0)
        new_colf = (acol - np.tensordot(self.Cf[b], u_new, axes=[[2], [0]])) / pivot
        self.Cf[b] = np.concatenate([self.Cf[b], new_colf[:, :, None]], axis=2)
        new_rowf = arow - np.tensordot(c_new, self.Rf[b], axes=[[0], [0]])
        self.Rf[b] = np.concatenate([self.Rf[b], new_rowf[None, :, :]], axis=0)
        self._extend_inverses(b, pivot, c_new, u_new)
        self.r[b + 1] += 1

    def _extend_inverses(self, b, pivot, c_new, u_new):
        """Bordered triangular inverse growth (replicated on every worker
        in the distributed mode, like the reference's tape replay)."""
        s = len(self.itl[b])
        row_new = np.concatenate([-(c_new @ self.itl[b]), [mpf(1)]])
        self.itl[b] = np.block([[self.itl[b], mp_zeros((s, 1))],
                                [row_new[None, :]]])
        col_new = np.concatenate([-(self.itt[b] @ u_new) / pivot, [1 / pivot]])
        self.itt[b] = np.block([[self.itt[b], col_new[:s, None]],
                                [mp_zeros((1, s)), col_new[s:, None]]])

    def replay_remote(self, rec):
        """Replay a remote worker's accept at non-owned bond b: vip / rank
        / inverses only (factors and cores are owner-authoritative; the
        slab-adjacent slices are applied separately)."""
        b = rec["b"]
        self.vip[b].append(tuple(int(x) for x in rec["ijkq"]))
        self._extend_inverses(b, rec["pivot"], rec["c_new"], rec["u_new"])
        self.r[b + 1] += 1

    def apply_left_slice(self, b, acol):
        """Rf[b-1] gains the L-solved new column of bond b
        (dmrgg.f90:715-728); called when bond b-1 is locally owned."""
        slc = self.itl[b - 1] @ acol
        self.Rf[b - 1] = np.concatenate([self.Rf[b - 1], slc[:, :, None]],
                                        axis=2)

    def apply_right_slice(self, b, arow):
        """Cf[b+1] gains the T-solved new row of bond b
        (dmrgg.f90:730-749); called when bond b+1 is locally owned."""
        slc = arow @ self.itt[b + 1]
        self.Cf[b + 1] = np.concatenate([self.Cf[b + 1], slc[None, :, :]],
                                        axis=0)

    def solve_core(self, c):
        """mptt_lua for one core (dmrggmp.f90:720-776)."""
        g = self.G[c]
        if c > 0:
            g = np.tensordot(self.itl[c - 1], g, axes=[[1], [0]])
        if c < self.d - 1:
            g = np.tensordot(g, self.itt[c], axes=[[2], [0]])
        return g


def cross_mp(
    fun_mp: Callable,
    n: Sequence[int],
    max_rank: int = 24,
    pivoting: int = 1,
    quad: Sequence | None = None,
    truth=None,
    dps: int = 120,
    accuracy_log10: float | None = None,
    small_element_log10: float | None = None,
    small_pivot_log10: float = -7.0,
    snum: int = 8,
    seed: int = 0,
    verbose: bool = False,
) -> MpCrossResult:
    """Arbitrary-precision TT-cross (mptt_dmrgg, dmrggmp.f90:11-704).

    fun_mp: batched integrand ind (B, d) int -> (B,) object array of mpf,
    evaluated at mp.dps = dps.  quad: per-mode mp weight vectors.  truth:
    optional mpf for per-sweep err reporting.  Thresholds are log10-domain:
    small_element defaults to -dps + 2 (dmrggmp.f90:50)."""
    with workdps(dps):
        return _cross_mp_impl(fun_mp, n, max_rank, pivoting, quad, truth,
                              dps, accuracy_log10, small_element_log10,
                              small_pivot_log10, snum, seed, verbose)


def _cross_mp_impl(fun_mp, n, max_rank, pivoting, quad, truth, dps,
                   accuracy_log10, small_element_log10, small_pivot_log10,
                   snum, seed, verbose):
    n = tuple(int(x) for x in n)
    d = len(n)
    if d < 2:
        raise ValueError("cross_mp requires d >= 2")
    lacc = accuracy_log10 if accuracy_log10 is not None else -dps + 4

    eng = MpEngine(fun_mp, n, max_rank, pivoting, dps,
                   small_element_log10, small_pivot_log10, snum, seed)
    eng.init_state()

    if quad is not None:
        w = [np.array([mpf(v) for v in np.asarray(quad[c], dtype=object)],
                      dtype=object) for c in range(d)]
    else:
        w = None

    history = []
    strike = 0
    it = 0
    while it + 1 < max_rank:
        it += 1
        dir_fwd = it % 2 == 1
        bonds = range(d - 1) if dir_fwd else range(d - 2, -1, -1)
        log_pivotmax = None
        for b in bonds:
            rec = eng.visit_bond(b, dir_fwd)
            if rec is None:
                continue
            log_pivotmax = (rec["lp"] if log_pivotmax is None
                            else max(log_pivotmax, rec["lp"]))
            # single-process: the neighbour slices are always local
            if b > 0:
                eng.apply_left_slice(b, rec["acol"])
            if b < d - 2:
                eng.apply_right_slice(b, rec["arow"])

        # per-iteration value / telemetry (dmrggmp.f90:655-672)
        rec = {"it": it, "dir": ">>" if dir_fwd else "<<",
               "pivotmax_log10": log_pivotmax, "n_evals": eng.neval,
               "value": None, "err": None}
        if w is not None:
            val = _value_chain(eng.G, eng.itl, eng.itt, w, d)
            rec["value"] = val
            if truth is not None:
                rel = abs(1 - val / mpf(truth))
                rec["err"] = rel
        history.append(rec)
        if verbose:
            lp = log_pivotmax if log_pivotmax is not None else float("-inf")
            line = f"{it:3d}{rec['dir']} n_evals {eng.neval:9d} log10|pivot| {lp:8.2f}"
            if rec["err"] is not None:
                line += f" err {mp.nstr(rec['err'], 5)} val {mp.nstr(rec['value'], min(dps, 40))}"
            print(line)

        if log_pivotmax is not None:
            eng.log_pivotmax_prev = log_pivotmax
        quiet = log_pivotmax is None or log_pivotmax <= lacc + eng.log_amax
        strike = strike + 1 if quiet else 0
        if strike >= 3:
            break

    solved = [eng.solve_core(c) for c in range(d)]
    value = mp_tt_value(solved, w) if w is not None else None
    return MpCrossResult(cores=solved, value=value, neval=eng.neval,
                         sweeps=it, ranks=tuple(eng.r), history=history)
