"""Quad-double DMRG-greedy cross engine (the ~62-digit tier).

Counterpart of ttcross_tpu/cross/engine_qd.py, the qd mirror of the
arbitrary-precision engine (the mptt_dmrgg analogue, dmrggmp.f90:11-704):
every value (fibers, factors, residuals, the bordered triangular inverses,
the per-sweep quadrature) is a four-limb qd number (ops/qd.py).  The tier
ladder is
  f64 engine   ~13 digits     cross/engine.py
  dd engine    ~31 digits     cross/engine_dd.py
  qd engine    ~60 digits     THIS MODULE
  mp engine   ~120 digits     (the JAX package's cross/engine_mp.py)

The JAX package runs this engine on the host in numpy: a TPU's emulated
f64 breaks Dekker's two_prod.  A CUDA card's f64 is IEEE, so here the qd
values live on the device (the card by default) and the arithmetic runs in
the qd kernels of ops/kernels.py: the lottery, the rook passes and the
accept's residual fibers in Q2, the products of _extend_inverses,
apply_*_slice, solve_core and the per-sweep value chain in Q4; the rest
(qd_div of a fiber by its pivot, the concatenations) are ops/qd.py's plain
operations.  The structure is the JAX package's: a ragged state that grows
rank by rank, the pivot chains (vip) and ranks on the host, index
bookkeeping through cross/hostwalk.py::walk_index, the lottery drawn by
np.random.default_rng(seed) (so both packages draw the same candidates).

The control flow reads the device per bond visit, as the host engine does:
the argmax of each residual, the log10 magnitudes of each fiber (amax) and
of the pivot; QdEngine.host_reads counts them.  Thresholds and amax live in
the log10 domain (dmrggmp.f90:50-53, 107, 364): small_element defaults to
-QD_DPS + 2, small_pivot -7.  The log10 of a fiber's leading limbs is taken
with numpy on the host copy, so it is the JAX package's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from decimal import Decimal, localcontext
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops.kernels import qd_score_residual_argmax
from ..ops.qd import (QD, qd, qd_concat, qd_div, qd_get, qd_matmul, qd_neg, qd_to_mp,
                      qd_tt_value, qd_vdot_axis, qd_zeros)
from .hostwalk import walk_index

__all__ = ["cross_qd", "QdCrossResult", "QdEngine", "QD_DPS", "as_qd"]

QD_DPS = 62   # four f64 limbs carry ~4*53 bits ~ 63.8 decimal digits


@dataclass
class QdCrossResult:
    cores: list              # solved QD cores (r, n, r'), on the engine's device
    value: QD | None         # qd quadrature value (0-d limbs; None without quad)
    neval: int
    sweeps: int
    ranks: tuple
    history: list            # per-sweep dicts {it, dir, pivotmax_log10, n_evals, value, err,
                             # host_reads}


def as_qd(x, device) -> QD:
    """A QD on `device` from a QD (of tensors or arrays), an (n, 4) limb
    array or a plain f64 array."""
    if isinstance(x, tuple) and len(x) == 4:
        return QD(*(torch.as_tensor(np.asarray(e) if not torch.is_tensor(e) else e,
                                    dtype=torch.float64).to(device) for e in x))
    a = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=torch.float64)
    if a.dim() == 2 and a.shape[1] == 4:
        return QD(*(a[:, i].contiguous().to(device) for i in range(4)))
    return qd(a.to(device))


def _expand(x: QD, pos: int) -> QD:
    return QD(*(e.unsqueeze(pos) for e in x))


def _value_chain_qd(G, itl, itt, w, d) -> QD:
    """LU-solved quadrature contraction: prod_c itl[c-1] (sum_j G_c w_cj)
    itt[c] (ttqq + mptt_lua + mptt_quad, dmrggmp.f90:640-672)."""
    v = None
    for c in range(d):
        M = qd_vdot_axis(G[c], qd_get(w[c], slice(0, G[c].e0.shape[1])), 1)
        if c > 0:
            M = qd_matmul(itl[c - 1], M)
        if c < d - 1:
            M = qd_matmul(M, itt[c])
        v = M if v is None else qd_matmul(v, M)
    return qd_get(v, (0, 0))


class QdEngine:
    """The qd cross state and its bond visit (the QD sibling of the JAX
    package's MpEngine: the same ragged layout and visit / accept / replay
    protocol, limb tensors on `device`)."""

    def __init__(self, fun_qd, n, max_rank, pivoting, small_element_log10,
                 small_pivot_log10, snum, seed, device="cuda"):
        self.fun_qd = fun_qd
        self.n = tuple(int(x) for x in n)
        self.d = len(self.n)
        self.max_rank = int(max_rank)
        self.piv = max(int(pivoting), 0)
        self.lse = small_element_log10 if small_element_log10 is not None else -QD_DPS + 2
        self.lsp = small_pivot_log10
        self.snum = snum
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        self.neval = 0
        self.host_reads = 0      # device-to-host reads the control flow made
        self.own_cores = None    # distributed hook: the cores this worker owns

    # ------------------------------------------------------ host reads
    def _e0(self, x: QD) -> np.ndarray:
        self.host_reads += 1
        return x.e0.detach().cpu().numpy()

    def _max_mag10(self, x: QD) -> float:
        """max log10|e0| over a fiber, from its host copy (numpy's log10)."""
        with np.errstate(divide="ignore"):
            return float(np.max(np.log10(np.abs(self._e0(x)))))

    def _mag10(self, x: QD) -> float:
        with np.errstate(divide="ignore"):
            return float(np.log10(np.abs(self._e0(x))))

    def _index(self, flat) -> int:
        self.host_reads += 1
        return int(flat)

    def _eval(self, ind) -> QD:
        ind = np.asarray(ind, np.int64).reshape(-1, self.d)
        v = self.fun_qd(torch.from_numpy(ind.astype(np.int32)).to(self.device))
        self.neval += len(ind)
        return as_qd(v, self.device)

    # ------------------------------------------------ initial pivot search
    def init_state(self):
        """Shifted-diagonal search + rank-1 cross (dmrgg.f90:151-248)."""
        n, d = self.n, self.d
        nn = min(n)
        cand = np.zeros((self.snum * nn, d), dtype=np.int64)
        for s in range(self.snum):
            for k in range(nn):
                cand[s * nn + k] = [(k + s * p) % n[p] for p in range(d)]
        vals = self._eval(cand)
        e0 = self._e0(vals)
        best = int(np.argmax(np.abs(e0)))
        with np.errstate(divide="ignore"):
            self.log_amax = float(np.log10(np.abs(e0[best])))
        ind0 = cand[best]

        self.vip = [[(0, int(ind0[b]), int(ind0[b + 1]), 0)] for b in range(d - 1)]
        self.r = [1] * (d + 1)

        self.G = []
        for c in range(d):
            fib = np.tile(ind0, (n[c], 1))
            fib[:, c] = np.arange(n[c])
            fv = self._eval(fib)
            self.log_amax = max(self.log_amax, self._max_mag10(fv))
            self.G.append(QD(*(e.reshape(1, n[c], 1) for e in fv)))
        delta = qd_get(self.G[0], (0, int(ind0[0]), 0))
        self.Cf = [qd_div(self.G[b], delta) for b in range(d - 1)]
        self.Rf = [QD(*(e.clone() for e in self.G[b + 1])) for b in range(d - 1)]
        one = qd(torch.ones((1, 1), dtype=torch.float64, device=self.device))
        self.itl = [one for _ in range(d - 1)]
        self.itt = [qd_div(one, delta) for _ in range(d - 1)]
        self.log_pivotmax_prev = self.log_amax

    # ------------------------------------------------------- fiber batches
    def eval_col(self, b, kk, qq) -> QD:
        """Raw column fiber (r[b], n[b]) at fixed (kk, qq)."""
        r, n, vip, d = self.r, self.n, self.vip, self.d
        idx = [walk_index(vip, b, d, i, j, kk, qq) for i in range(r[b]) for j in range(n[b])]
        return QD(*(e.reshape(r[b], n[b]) for e in self._eval(idx)))

    def eval_row(self, b, ii, jj) -> QD:
        r, n, vip, d = self.r, self.n, self.vip, self.d
        idx = [walk_index(vip, b, d, ii, jj, k, q)
               for k in range(n[b + 1]) for q in range(r[b + 2])]
        return QD(*(e.reshape(n[b + 1], r[b + 2]) for e in self._eval(idx)))

    def _col_resid(self, b, acol: QD, u: QD) -> tuple[QD, torch.Tensor]:
        """acol - qd_vdot_axis(Cf[b], u, 2) and the flat argmax of its |e0|
        (one launch of Q2 on the card)."""
        cf = self.Cf[b]
        R = cf.e0.shape[2]
        x = QD(*(e.reshape(-1, R) for e in cf))
        B = x.e0.shape[0]
        r, flat = qd_score_residual_argmax(QD(*(e.reshape(-1) for e in acol)), x,
                                           QD(*(e.expand(B, R) for e in u)))
        return QD(*(e.reshape(acol.e0.shape) for e in r)), flat

    def _row_resid(self, b, arow: QD, c: QD) -> tuple[QD, torch.Tensor]:
        """arow - qd_vdot_axis(Rf[b], c, 0) and the flat argmax of its |e0|
        (one launch of Q2 on the card)."""
        rf = self.Rf[b]
        R = rf.e0.shape[0]
        x = QD(*(e.reshape(R, -1).T for e in rf))
        B = x.e0.shape[0]
        r, flat = qd_score_residual_argmax(QD(*(e.reshape(-1) for e in arow)), x,
                                           QD(*(e.expand(B, R) for e in c)))
        return QD(*(e.reshape(arow.e0.shape) for e in r)), flat

    # --------------------------------------------------------- bond visit
    def visit_bond(self, b, dir_fwd):
        """Hunt + (maybe) accept at owned bond b.  Returns a tape record
        (dict) when a pivot was accepted, else None (the JAX package's
        record schema, QD payloads on the device)."""
        r, n, vip, d = self.r, self.n, self.vip, self.d
        Cf, Rf = self.Cf, self.Rf
        piv = self.piv
        used_c = {(pv[0], pv[1]) for pv in vip[b]}
        used_r = {(pv[2], pv[3]) for pv in vip[b]}
        all_c = [(i, j) for i in range(r[b]) for j in range(n[b]) if (i, j) not in used_c]
        all_r = [(k, q) for k in range(n[b + 1]) for q in range(r[b + 2]) if (k, q) not in used_r]
        if not all_c or not all_r:
            return None
        nlot = r[b] + n[b] + n[b + 1] + r[b + 2]
        sel_c = np.array([all_c[i] for i in self.rng.integers(0, len(all_c), nlot)])
        sel_r = np.array([all_r[i] for i in self.rng.integers(0, len(all_r), nlot)])
        idx = [walk_index(vip, b, d, i, j, k, q) for (i, j), (k, q) in zip(sel_c, sel_r)]
        bvals = self._eval(idx)
        self.log_amax = max(self.log_amax, self._max_mag10(bvals))
        sel = torch.from_numpy(np.concatenate([sel_c, sel_r], axis=1)).to(self.device)
        cf = QD(*(e[sel[:, 0], sel[:, 1], :] for e in Cf[b]))          # (B, R)
        rf = QD(*(e[:, sel[:, 2], sel[:, 3]].T for e in Rf[b]))        # (B, R)
        resid, flat = qd_score_residual_argmax(bvals, cf, rf)
        bi = self._index(flat)
        (ii, jj), (kk, qq) = sel_c[bi], sel_r[bi]
        ii, jj, kk, qq = int(ii), int(jj), int(kk), int(qq)
        pivot = qd_get(resid, bi)

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
                    u = qd_get(Rf[b], (slice(None), kk, qq))
                    bcol, flat = self._col_resid(b, acol, u)
                    i2, j2 = divmod(self._index(flat), n[b])
                    stat = havecol and haverow and (i2, j2) == (ii, jj)
                    ii, jj = i2, j2
                    pivot = qd_get(bcol, (i2, j2))
                    if stat:
                        break
                else:
                    break
            skipcol = False
            arow = self.eval_row(b, ii, jj)
            haverow = True
            crs += 1
            if not (havecol and haverow and crs >= 2 * piv):
                c = qd_get(Cf[b], (ii, jj, slice(None)))
                brow, flat = self._row_resid(b, arow, c)
                k2, q2 = divmod(self._index(flat), r[b + 2])
                stat = havecol and haverow and (k2, q2) == (kk, qq)
                kk, qq = k2, q2
                pivot = qd_get(brow, (k2, q2))
                if stat:
                    break
            else:
                break
        if not havecol:
            acol = self.eval_col(b, kk, qq)
        if not haverow:
            arow = self.eval_row(b, ii, jj)
        self.log_amax = max(self.log_amax, self._max_mag10(acol), self._max_mag10(arow))

        # two-threshold accept, log domain (dmrggmp.f90:364)
        lp = self._mag10(pivot)
        if not (lp > self.lse + self.log_amax
                and lp > self.lsp + self.log_pivotmax_prev
                and r[b + 1] < self.max_rank):
            return None
        c_new = qd_get(Cf[b], (ii, jj, slice(None)))
        u_new = qd_get(Rf[b], (slice(None), kk, qq))
        self._accept_owner(b, ii, jj, kk, qq, pivot, acol, arow, c_new, u_new)
        return {"b": b, "ijkq": (ii, jj, kk, qq), "pivot": pivot,
                "c_new": c_new, "u_new": u_new, "acol": acol, "arow": arow, "lp": lp}

    def _accept_owner(self, b, ii, jj, kk, qq, pivot, acol, arow, c_new, u_new):
        """Owner-side accept: extend vip / cores / factors / inverses."""
        self.vip[b].append((int(ii), int(jj), int(kk), int(qq)))
        if self.own_cores is None or b in self.own_cores:
            self.G[b] = qd_concat([self.G[b], _expand(acol, 2)], axis=2)
        if self.own_cores is None or (b + 1) in self.own_cores:
            self.G[b + 1] = qd_concat([self.G[b + 1], _expand(arow, 0)], axis=0)
        new_colf = qd_div(self._col_resid(b, acol, u_new)[0], pivot)
        self.Cf[b] = qd_concat([self.Cf[b], _expand(new_colf, 2)], axis=2)
        new_rowf = self._row_resid(b, arow, c_new)[0]
        self.Rf[b] = qd_concat([self.Rf[b], _expand(new_rowf, 0)], axis=0)
        self._extend_inverses(b, pivot, c_new, u_new)
        self.r[b + 1] += 1

    def _extend_inverses(self, b, pivot, c_new, u_new):
        """Bordered triangular inverse growth (replicated on every worker in
        a distributed run)."""
        s = self.itl[b].e0.shape[0]
        dev = self.device
        one = qd(torch.ones(1, dtype=torch.float64, device=dev))
        row_new = qd_concat([qd_neg(qd_vdot_axis(self.itl[b], c_new, 0)), one])
        self.itl[b] = qd_concat([qd_concat([self.itl[b], qd_zeros((s, 1), dev)], axis=1),
                                 _expand(row_new, 0)], axis=0)
        col_new = qd_concat([qd_div(qd_neg(qd_vdot_axis(self.itt[b], u_new, 1)), pivot),
                             qd_div(one, pivot)])
        top = qd_concat([self.itt[b], _expand(qd_get(col_new, slice(0, s)), 1)], axis=1)
        bot = qd_concat([qd_zeros((1, s), dev), _expand(qd_get(col_new, slice(s, s + 1)), 1)],
                        axis=1)
        self.itt[b] = qd_concat([top, bot], axis=0)

    def replay_remote(self, rec):
        """Replay a remote worker's accept at non-owned bond b: vip / rank
        / inverses only."""
        b = rec["b"]
        self.vip[b].append(tuple(int(x) for x in rec["ijkq"]))
        self._extend_inverses(b, rec["pivot"], rec["c_new"], rec["u_new"])
        self.r[b + 1] += 1

    def apply_left_slice(self, b, acol):
        """Rf[b-1] gains the L-solved new column of bond b
        (dmrgg.f90:715-728)."""
        slc = qd_matmul(self.itl[b - 1], acol)
        self.Rf[b - 1] = qd_concat([self.Rf[b - 1], _expand(slc, 2)], axis=2)

    def apply_right_slice(self, b, arow):
        """Cf[b+1] gains the T-solved new row of bond b
        (dmrgg.f90:730-749)."""
        slc = qd_matmul(arow, self.itt[b + 1])
        self.Cf[b + 1] = qd_concat([self.Cf[b + 1], _expand(slc, 0)], axis=0)

    def solve_core(self, c):
        """mptt_lua for one core (dmrggmp.f90:720-776)."""
        g = self.G[c]
        r1, nc, r2 = g.e0.shape
        if c > 0:
            m = qd_matmul(self.itl[c - 1], QD(*(e.reshape(r1, nc * r2) for e in g)))
            g = QD(*(e.reshape(r1, nc, r2) for e in m))
        if c < self.d - 1:
            m = qd_matmul(QD(*(e.reshape(r1 * nc, r2) for e in g)), self.itt[c])
            g = QD(*(e.reshape(r1, nc, r2) for e in m))
        return g


def qd_err(value: QD, truth) -> Decimal:
    """|1 - value / truth| in decimal at QD_DPS + 15 digits."""
    with localcontext() as ctx:
        ctx.prec = QD_DPS + 15
        return abs(1 - qd_to_mp(*(float(e) for e in value)) / Decimal(str(truth)))


def cross_qd(
    fun_qd: Callable,
    n: Sequence[int],
    max_rank: int = 24,
    pivoting: int = 1,
    quad: Sequence | None = None,
    truth=None,
    accuracy_log10: float | None = None,
    small_element_log10: float | None = None,
    small_pivot_log10: float = -7.0,
    snum: int = 8,
    seed: int = 0,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> QdCrossResult:
    """Quad-double TT-cross (the ~62-digit point of the mptt_dmrgg tier
    ladder, dmrggmp.f90:11-704); the signature of
    ttcross_tpu.cross.engine_qd.cross_qd plus ``device``: the card unless
    the caller asks for ``device="cpu"``.

    fun_qd: batched integrand ind (B, d) int32 tensor on `device` -> QD (B,)
    (e.g. apps.ising.make_ising_qd's fun).  quad: per-mode weight vectors,
    each a QD, an (n_c, 4) limb array or a plain f64 array.  truth: a
    decimal string (or Decimal) for the per-sweep err.  Thresholds are
    log10-domain: small_element defaults to -QD_DPS + 2 (dmrggmp.f90:50)."""
    n = tuple(int(x) for x in n)
    d = len(n)
    if d < 2:
        raise ValueError("cross_qd requires d >= 2")
    lacc = accuracy_log10 if accuracy_log10 is not None else -QD_DPS + 4
    dev = torch.device(device)

    eng = QdEngine(fun_qd, n, max_rank, pivoting, small_element_log10, small_pivot_log10,
                   snum, seed, dev)
    eng.init_state()
    w = [as_qd(quad[c], dev) for c in range(d)] if quad is not None else None
    history = []
    strike = 0
    it = 0
    while it + 1 < max_rank:
        it += 1
        dir_fwd = it % 2 == 1
        log_pivotmax = sweep_qd(eng, dir_fwd)
        rec = {"it": it, "dir": ">>" if dir_fwd else "<<", "pivotmax_log10": log_pivotmax,
               "n_evals": eng.neval, "value": None, "err": None, "host_reads": eng.host_reads}
        if w is not None:
            rec["value"] = _value_chain_qd(eng.G, eng.itl, eng.itt, w, d)
            if truth is not None:
                rec["err"] = qd_err(rec["value"], truth)
        history.append(rec)
        if verbose:
            print(_sweep_line(rec, eng.neval, log_pivotmax, "qd"))
        if log_pivotmax is not None:
            eng.log_pivotmax_prev = log_pivotmax
        quiet = log_pivotmax is None or log_pivotmax <= lacc + eng.log_amax
        strike = strike + 1 if quiet else 0
        if strike >= 3:
            break

    solved = [eng.solve_core(c) for c in range(d)]
    value = qd_tt_value(solved, w) if w is not None else None
    return QdCrossResult(cores=solved, value=value, neval=eng.neval, sweeps=it,
                         ranks=tuple(eng.r), history=history)


def sweep_qd(eng: QdEngine, dir_fwd: bool):
    """One sweep of every bond in its direction (visit, then the
    neighbours' factor slices of an accept); the sweep's largest accepted
    log10|pivot|, or None."""
    d = eng.d
    log_pivotmax = None
    for b in (range(d - 1) if dir_fwd else range(d - 2, -1, -1)):
        rec = eng.visit_bond(b, dir_fwd)
        if rec is None:
            continue
        log_pivotmax = rec["lp"] if log_pivotmax is None else max(log_pivotmax, rec["lp"])
        if b > 0:
            eng.apply_left_slice(b, rec["acol"])
        if b < d - 2:
            eng.apply_right_slice(b, rec["arow"])
    return log_pivotmax


def _sweep_line(rec, neval, log_pivotmax, tag) -> str:
    """The per-iteration value line (dmrggmp.f90:655-672)."""
    line = (f"{rec['it']:3d}{rec['dir']} {tag} n_evals {neval:9d} log10|pivot| "
            f"{log_pivotmax if log_pivotmax is not None else float('-inf'):8.2f}")
    if rec["err"] is not None:
        with localcontext() as ctx:
            ctx.prec = 40
            val = +qd_to_mp(*(float(e) for e in rec["value"]))
        line += f" err {float(rec['err']):.5g} val {val}"
    return line
