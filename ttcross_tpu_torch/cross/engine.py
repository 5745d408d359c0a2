"""DMRG-greedy TT-cross engine, run eagerly on one device.

Counterpart of ttcross_tpu/cross/engine.py (dtt_dmrgg, dmrgg.f90:11-1050):
the same padded state, the same rook/lottery/full pivot hunts, the same
two-threshold acceptance and the same strike-based stop.  The sequential
sweep is a Python loop over bonds whose every step carries a lane axis: one
run is its one-lane case, a parameter family (cross/batch.py::cross_batch)
runs all its lanes through the same ops, kernel A batched over the lanes.
The all-bonds-batched sweeps (sweep_mode "jacobi" / "jacobi-rb",
cross/engine_jacobi.py) hunt every bond of one run at once.  Every decision inside a sweep stays on the device as a
branch-free masked update (the accept flag ``upd`` and the rook ``done``
flags are tensors), so a sweep makes no host round trip; the one host sync
per sweep is the stopping rule.  The large state arrays are updated in
place.

Kernels on these paths (ops/kernels.py): every integrand call of the Ising
problem is one fused launch; every rook pass and the full-pivoting hunt
score their residual with the masked argmax (kernel A, batched over bonds
on the all-bonds sweeps); the chain evaluator's lift and the node lookup of
the MVN and stdnorm integrands are the small-table lookup (kernel B).
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, replace
from types import SimpleNamespace
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import precision_thresholds
from ..ops.dense import (balanced_matmul_chain, batched_row_lookup, masked_slot_write,
                         matmul_by_sums, scale_pow2)
from ..ops.kernels import score_residual_argmax, score_residual_argmax_batched
from ..tt.ops import contract
from ..tt.ortho import svd_round
from ..tt.types import TT
from ..utils.metrics import SweepRecord, history_from_run
from .chain_eval import ChainEvaluator
from .chains import (advance_left, advance_right, all_left_tables,
                     all_right_tables, assemble_indices, pivot_index_sets)
from .engine_jacobi import build_jacobi
from .state import CrossState, as_lanes, empty_state, lane, pad_state

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
    wlot: bool = False   # lottery weighted by the quad weights (weighted_lottery)
    jacobi: bool = False  # all-bonds-batched sweeps (sweep_mode "jacobi", "jacobi-rb")
    rb: bool = False      # red-black phases: even bonds accept, then odd bonds
    caps: tuple | None = None   # per-bond rank caps (d-1,): capped fiber batches (rank_caps)
    adaptive: float = 0.0  # > 0: gate a bond's fiber hunt by its lottery residual (adaptive)


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
    chain_states: tuple | None = None   # carried packed (Ls, Rs) when return_state=True


class EngineKit(NamedTuple):
    cfg: CrossConfig
    init_fn: Callable       # () -> CrossState
    sweep_fn: Callable      # (st, it, U, cs=None, lw=None, live=None) -> CrossState, or (st, cs')
    value_fn: Callable      # (st, w (d, N)) -> 0-d tensor, (L,) on a lane state
    finalize_fn: Callable   # (st) -> (d, R, N, R) solved cores, (d, L, R, N, R) on a lane state
    jacobi_hunt: Callable   # cross/engine_jacobi.py, window-wise for the distributed engine
    jacobi_apply: Callable
    chain_ev: ChainEvaluator | None   # the chain evaluator when chain= was given
    lanes: int = 0          # 0: one run's states; L >= 1: lane states of L runs
    # the pieces the distributed engine (parallel/engine.py) builds on, one run only
    visit_bond: Callable | None = None      # (st, p, fwd, own_lo, own_hi, ltab, rtab, u2)
    eval_col_fiber: Callable | None = None  # (st, p, ltab, rtab, kk, qq)
    eval_row_fiber: Callable | None = None  # (st, p, ltab, rtab, ii, jj)
    value_mats: Callable | None = None      # (st, w) -> (d, R, R)
    init_neval: int = 0     # evaluations of init_fn


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
        # Python floats: an f32 run's values are compared in f64
        values = [float(v) for v in vals[: last_it + 1]]
        for i in range(1, last_it + 1):
            if truth is not None:
                errors.append(abs(1.0 - values[i] / truth))
            else:
                prev = values[i - 1]
                errors.append(abs(1.0 - values[i] / prev) if prev != 0 else float("nan"))
    return values, errors


_SCALARS = ("amax", "pivotmax", "pivotmin", "pivotmax_prev", "neval", "padded")


def _mv(a, x):
    """a (L, M, K) @ x (L, K) -> (L, M), each lane as alone (matmul_by_sums)."""
    return matmul_by_sums(a, x[:, :, None])[:, :, 0]


def make_engine(fun: Callable, cfg: CrossConfig, device,
                dtype: torch.dtype = torch.float64, chain=None, lanes: int = 0) -> EngineKit:
    """Build the engine phases.

    lanes = 0: fun(ind (B, d) int32 tensor on `device`) -> (B,) values,
    and the phases take and return one run's CrossState.  lanes = L >= 1:
    fun(ind (L, B, d)) -> (L, B) evaluates every lane in one call, and the
    phases take and return a lane state of L runs (cross/state.py), every
    lane with its own pivots, ranks and counters; the sweep's lottery
    uniforms are then (L, d-1, 2, NLOT) and its ``live`` (L,) bool freezes
    the lanes that are not live.  There is one engine: lanes = 0 runs it
    as one lane on views of the state.  chain: optional
    chain_eval.ChainSpec of a chain-structured integrand, for O(1) hunt
    evaluation from interface states on the all-bonds-batched sweeps
    (lanes = 0 only)."""
    d, N, R = cfg.d, cfg.N, cfg.R
    n = cfg.n
    L = max(lanes, 1)
    RN = R * N
    NLOT = 2 * (R + N)
    dev = torch.device(device)
    fun_l = fun if lanes else (lambda ind: fun(ind[0])[None])
    iR = torch.arange(R, device=dev)
    iN = torch.arange(N, device=dev)
    n_t = torch.tensor(n, device=dev)
    # candidate enumerations: column fibers vary (i, j) over (Rl, N), row
    # fibers (k, q) over (N, Rr), lottery slots over NLOT; Rl = Rr = R but
    # on a capped sweep (rank_caps), whose bonds evaluate smaller batches
    lot = torch.arange(NLOT, device=dev)

    @functools.lru_cache(maxsize=None)
    def _col_grid(Rl: int):
        return (iR[:Rl].repeat_interleave(N).expand(L, Rl * N),
                iN.repeat(Rl).expand(L, Rl * N))

    @functools.lru_cache(maxsize=None)
    def _row_grid(Rr: int):
        return (iN.repeat_interleave(Rr).expand(L, N * Rr),
                iR[:Rr].repeat(N).expand(L, N * Rr))

    def per_lane(x, width):
        """A lane scalar (L,) against a candidate axis: (L, width)."""
        return x[:, None].expand(L, width)

    # ---------------------------------------------------------------- init
    def init_fn() -> CrossState:
        """Initial pivot search over shifted diagonals + rank-1 cross
        (dmrgg.f90:151-248), every lane at once."""
        st = empty_state(d, N, R, dtype, dev, lanes=L)
        nn = int(min(n))
        ks = torch.arange(nn, device=dev)[None, :, None]
        ss = torch.arange(cfg.snum, device=dev)[:, None, None]
        ps = torch.arange(d, device=dev)[None, None, :]
        cand = ((ks + ss * ps) % n_t[None, None, :]).reshape(-1, d).to(torch.int32)
        vals = fun_l(cand.expand(L, -1, -1)).abs()                  # (L, B)
        best = torch.argmax(vals, dim=1)
        amax = vals.amax(dim=1)
        ind0 = cand[best]                                           # (L, d)
        # in place: initial vip (0, ind0[b], ind0[b+1], 0) per bond
        st.vip[:, :, 0, 1] = ind0[:, :-1].T
        st.vip[:, :, 0, 2] = ind0[:, 1:].T

        # rank-1 fibers: for each core c vary mode c over its grid
        mode_pos = torch.arange(d, device=dev).repeat_interleave(N)
        mode_val = iN.repeat(d)
        col = torch.arange(d, device=dev)
        fib_ind = torch.where(col[None, None, :] == mode_pos[None, :, None],
                              torch.minimum(mode_val, n_t[mode_pos] - 1)[None, :, None],
                              ind0[:, None, :].long())              # (L, d*N, d)
        fvals = fun_l(fib_ind.to(torch.int32)).reshape(L, d, N)
        fvals = torch.where(iN[None, None, :] < n_t[None, :, None], fvals, 0.0)
        amax = torch.maximum(amax, fvals.abs().amax(dim=(1, 2)))

        delta = fvals[:, 0].gather(1, ind0[:, :1].long())[:, 0]     # = A(ind0), (L,)
        fv = fvals.transpose(0, 1)                                  # (d, L, N)
        st.cores[:, :, 0, :, 0] = fv
        st.lu_d[:, :, 0] = delta
        st.itt[:, :, 0, 0] = 1.0 / delta
        st.colf[:, :, 0, :, 0] = fv / delta[:, None]
        st.rowf[:, :, 0, :, 0] = fv
        neval = torch.full((L,), cfg.snum * nn + sum(n), dtype=torch.int64, device=dev)
        padded = torch.full((L,), cfg.snum * nn + d * N, dtype=torch.int64, device=dev)
        return st._replace(amax=amax, pivotmax_prev=amax, neval=neval, padded=padded)

    # ----------------------------------------------------------- bond visit
    # Every tensor below carries the lane axis first: bond p's slices of
    # the state (st.colf[p] (L, R, N, R), st.rk[p] (L,)), the pivot indices
    # (L,), the fibers (L, Rl, N) and (L, N, Rr).  Rl and Rr are the padded
    # ranks of the bond's left and right candidates: R, or on a capped sweep
    # the caps of the neighbouring bonds (the LU and factor machinery keeps
    # its full R; a capped fiber is zero-embedded before the accept).
    def _col_mask(st, p, Rl=R):
        return ((iR[None, :Rl, None] < st.rk[p][:, None, None])
                & (iN[None, None, :] < n[p]))                              # (L, Rl, N)

    def _row_mask(st, p, Rr=R):
        return ((iN[None, :, None] < n[p + 1])
                & (iR[None, None, :Rr] < st.rk[p + 2][:, None, None]))     # (L, N, Rr)

    def _rank_mask(st, p):
        return (iR[None, :] < st.rk[p + 1][:, None]).to(dtype)             # (L, R)

    def _rowf_r(st, p, Rr):
        """Bond p's row factor st.rowf[p+1] (L, R, N, Rr): its first Rr
        columns, copied contiguous when Rr < R."""
        return st.rowf[p + 1] if Rr == R else st.rowf[p + 1][..., :Rr].contiguous()

    def _col_fiber(st, p, ltab, rtab, kk, qq, Rl=R):
        """Raw column fibers (L, Rl, N) at fixed (kk, qq), masked to the
        active (rk[p], n_p) block, and their counts of active evaluations."""
        ci, cj = _col_grid(Rl)
        ind = assemble_indices(ltab, rtab, p, ci, cj, per_lane(kk, Rl * N),
                               per_lane(qq, Rl * N), d)
        vals = torch.where(_col_mask(st, p, Rl), fun_l(ind).reshape(L, Rl, N), 0.0)
        return vals, (st.rk[p] * n[p]).long()

    def _row_fiber(st, p, ltab, rtab, ii, jj, Rr=R):
        """Raw row fibers (L, N, Rr) at fixed (ii, jj), masked to
        (n_{p+1}, rk[p+2]), and their counts of active evaluations."""
        rk_, rq_ = _row_grid(Rr)
        ind = assemble_indices(ltab, rtab, p, per_lane(ii, N * Rr), per_lane(jj, N * Rr),
                               rk_, rq_, d)
        vals = torch.where(_row_mask(st, p, Rr), fun_l(ind).reshape(L, N, Rr), 0.0)
        return vals, (n[p + 1] * st.rk[p + 2]).long()

    def _argmax(vals, colf, rowf, mask):
        """Kernel A on each lane's fiber: (L,) flat index, score, residual.
        One run keeps the single-fiber launch; lanes take the launch
        batched over them (bit-equal to one single launch per lane)."""
        if L == 1:
            return tuple(x.view(1) for x in
                         score_residual_argmax(vals[0], colf[0], rowf[0], mask[0]))
        return score_residual_argmax_batched(vals, colf, rowf, mask)

    def _col_residual_argmax(st, p, acol, kk, qq, Rl=R):
        """argmax of |acol - colf[p] @ rowf[p+1][:, kk, qq]| over the
        active block (dmrgg.f90:537-539): kernel A at (Rl*N, 1)."""
        u = (st.rowf[p + 1].reshape(L, R, N * R).gather(
            2, (kk * R + qq).view(L, 1, 1).expand(L, R, 1))
            * _rank_mask(st, p)[:, :, None])                                # (L, R, 1)
        flat, _, resid = _argmax(acol.reshape(L, Rl * N, 1),
                                 st.colf[p][:, :Rl].reshape(L, Rl * N, R), u,
                                 _col_mask(st, p, Rl).reshape(L, Rl * N, 1))
        return flat // N, flat % N, resid

    def _row_residual_argmax(st, p, arow, ii, jj, Rr=R):
        """argmax of |arow - colf[p][ii, jj, :] @ rowf[p+1]| over the
        active block (dmrgg.f90:570-572): kernel A at (1, N*Rr)."""
        c = (st.colf[p].reshape(L, RN, R).gather(
            1, (ii * N + jj).view(L, 1, 1).expand(L, 1, R))
            * _rank_mask(st, p)[:, None, :])                                # (L, 1, R)
        flat, _, resid = _argmax(arow.reshape(L, 1, N * Rr), c,
                                 _rowf_r(st, p, Rr).reshape(L, R, N * Rr),
                                 _row_mask(st, p, Rr).reshape(L, 1, N * Rr))
        return flat // Rr, flat % Rr, resid

    def _hunt_lottery(st, p, ltab, rtab, u2, lw=None, Rl=R, Rr=R):
        """Lottery over the unused candidate columns (i, j) and rows (q, k)
        (lottery2, rnd.f90:105-144; dmrgg.f90:410-487), residual scoring,
        seed pivot.  u2 (L, 2, NLOT) f64 uniforms in [0, 1), of which a
        capped bond draws the first Rl + 2N + Rr.  lw (d, N): the
        per-mode lottery weights, each mode's scaled to a maximum of 1
        (cross(weighted_lottery=True)): column (i, j) then draws with
        probability ~ lw[p, j], row (q, k) with ~ lw[p+1, k], as the f64
        cumsum of the allowed weights taken to f32 (the JAX engine sums the
        unscaled |w| in f32, which underflows for small weights; the picks
        agree but at f32 ties of the CDF).

        The draw rounds exactly as the JAX engine's: the 0/1 CDF is an
        integer cumsum held in f32 (JAX's triangular-ones f32 matmul gives
        the same exact counts), the target is f32(u) * f32(total) clamped
        to total * f32(1 - 2^-20), and the pick is searchsorted(right)."""
        # layouts: columns (i, j) flattened i*N + j; rows (q, k) q*N + k
        nlp = Rl + N + N + Rr
        colmask = _col_mask(st, p, Rl).reshape(L, Rl * N)
        rowmask = ((iR[None, :Rr, None] < st.rk[p + 2][:, None, None])
                   & (iN[None, None, :] < n[p + 1])).reshape(L, Rr * N)
        # zero weight on already-used pivots (dmrgg.f90:432-439); padding
        # rows of vip repeat index 0, so the scatter takes the max; a capped
        # side clamps the chain index into its grid as the JAX engine does
        vb = st.vip[p].long()                                 # (L, R, 4)
        vi = vb[..., 0] if Rl == R else vb[..., 0].clamp(max=Rl - 1)
        vq = vb[..., 3] if Rr == R else vb[..., 3].clamp(max=Rr - 1)
        smask = (iR[None, :] < st.rk[p + 1][:, None]).to(torch.int32)
        used_col = torch.zeros((L, Rl * N), dtype=torch.int32, device=dev).scatter_reduce_(
            1, vi * N + vb[..., 1], smask, "amax")
        used_row = torch.zeros((L, Rr * N), dtype=torch.int32, device=dev).scatter_reduce_(
            1, vq * N + vb[..., 2], smask, "amax")
        if lw is None:
            cdf_c = torch.cumsum((colmask & (used_col == 0)).to(torch.int32), 1).to(torch.float32)
            cdf_r = torch.cumsum((rowmask & (used_row == 0)).to(torch.int32), 1).to(torch.float32)
        else:
            cdf_c = torch.cumsum((colmask & (used_col == 0)) * lw[p].repeat(Rl), 1).to(torch.float32)
            cdf_r = torch.cumsum((rowmask & (used_row == 0)) * lw[p + 1].repeat(Rr), 1).to(torch.float32)
        below = 1.0 - 2.0 ** -20          # exact in f32
        tot_c, tot_r = cdf_c[:, -1:], cdf_r[:, -1:]
        t_c = torch.minimum(u2[:, 0, :nlp].to(torch.float32) * torch.where(tot_c > 0, tot_c, 1.0),
                            tot_c * below)
        t_r = torch.minimum(u2[:, 1, :nlp].to(torch.float32) * torch.where(tot_r > 0, tot_r, 1.0),
                            tot_r * below)
        lin_c = torch.searchsorted(cdf_c, t_c.contiguous(), right=True).clamp(max=Rl * N - 1)
        lin_r = torch.searchsorted(cdf_r, t_r.contiguous(), right=True).clamp(max=Rr * N - 1)
        i_c, j_c = lin_c // N, lin_c % N
        q_c, k_c = lin_r // N, lin_r % N

        nlot_act = st.rk[p] + n[p] + n[p + 1] + st.rk[p + 2]              # (L,)
        candmask = lot[None, :nlp] < nlot_act[:, None]
        b = fun_l(assemble_indices(ltab, rtab, p, i_c, j_c, k_c, q_c, d))  # (L, nlp)
        amax = torch.maximum(st.amax, torch.where(candmask, b.abs(), 0.0).amax(dim=1))
        neval = st.neval + nlot_act.long()

        # residual b - colf[p][i,j,:] . rowf[p+1][:,k,q]  (dmrgg.f90:469-476)
        cf = batched_row_lookup(st.colf[p][:, :Rl].reshape(L, Rl * N, R), lin_c)  # (L, nlp, R)
        rf = batched_row_lookup(_rowf_r(st, p, Rr).reshape(L, R, N * Rr).mT, k_c * Rr + q_c)
        resid = b - (cf * rf * _rank_mask(st, p)[:, None, :]).sum(dim=2)
        best = torch.argmax(torch.where(candmask, resid.abs(), -1.0), dim=1)[:, None]
        seed = tuple(x.gather(1, best)[:, 0] for x in (i_c, j_c, k_c, q_c))
        st = st._replace(amax=amax, neval=neval, padded=st.padded + nlp)
        return st, seed, resid.gather(1, best)[:, 0]

    def _rook(st, p, ltab, rtab, seed, pivot0, fwd: bool, Rl=R, Rr=R):
        """Rook pivoting (dmrgg.f90:515-582): alternate column/row
        maximization until stationary or 2*piv passes, as exactly 2*piv
        masked passes ('>>' sweeps start with a column pass, '<<' with a
        row pass; skipcol, dmrgg.f90:517; a capped sweep always starts with
        a column pass, as the JAX engine's).  A pass after a lane's tensor
        flag `done` is set changes nothing of that lane; whether the budget
        ends a pass is known on the host (it depends only on the pass
        number)."""
        ii, jj, kk, qq = seed
        pivot = pivot0
        acol = torch.zeros((L, Rl, N), dtype=dtype, device=dev)
        arow = torch.zeros((L, N, Rr), dtype=dtype, device=dev)
        done = torch.zeros((L,), dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        amax, neval = st.amax, st.neval
        havecol = haverow = False
        for t in range(2 * cfg.piv):
            live = ~done
            if fwd == (t % 2 == 0):      # column pass
                new, dnev = _col_fiber(st, p, ltab, rtab, kk, qq, Rl)
                a2, b2, resid = _col_residual_argmax(st, p, new, kk, qq, Rl)
                budget = haverow and t + 1 >= 2 * cfg.piv
                stat = ((a2 == ii) & (b2 == jj)) if haverow else torch.zeros_like(done)
                havecol = True
                acol = torch.where(live[:, None, None], new, acol)
                if not budget:
                    ii = torch.where(live, a2, ii)
                    jj = torch.where(live, b2, jj)
            else:                        # row pass
                new, dnev = _row_fiber(st, p, ltab, rtab, ii, jj, Rr)
                a2, b2, resid = _row_residual_argmax(st, p, new, ii, jj, Rr)
                budget = havecol and t + 1 >= 2 * cfg.piv
                stat = ((a2 == kk) & (b2 == qq)) if havecol else torch.zeros_like(done)
                haverow = True
                arow = torch.where(live[:, None, None], new, arow)
                if not budget:
                    kk = torch.where(live, a2, kk)
                    qq = torch.where(live, b2, qq)
            if not budget:
                pivot = torch.where(live, resid, pivot)
            amax = torch.where(live, torch.maximum(amax, new.abs().amax(dim=(1, 2))), amax)
            neval = neval + torch.where(live, dnev, zero)
            done = done | budget | stat
        # padded work: every pass calls fun on a full (Rl, N) or (N, Rr) batch
        st = st._replace(amax=amax, neval=neval,
                         padded=st.padded + cfg.piv * (Rl + Rr) * N)
        return st, (ii, jj, kk, qq), pivot, acol, arow

    def _hunt_piv0(st, p, ltab, rtab, seed, pivot0, Rl=R, Rr=R):
        """piv = 0: evaluate the seed's full column and row once
        (dmrgg.f90:492-513)."""
        ii, jj, kk, qq = seed
        acol, dn_c = _col_fiber(st, p, ltab, rtab, kk, qq, Rl)
        arow, dn_r = _row_fiber(st, p, ltab, rtab, ii, jj, Rr)
        amax = torch.maximum(torch.maximum(st.amax, acol.abs().amax(dim=(1, 2))),
                             arow.abs().amax(dim=(1, 2)))
        st = st._replace(amax=amax, neval=st.neval + dn_c + dn_r,
                         padded=st.padded + (Rl + Rr) * N)
        return st, seed, pivot0, acol, arow

    def _hunt_full(st, p, ltab, rtab):
        """piv = -1: full superblock residual pivoting (dmrgg.f90:341-408),
        scored by kernel A's 2-D path at (R*N, N*R), one launch per lane."""
        gr = torch.arange(RN * N * R, device=dev)
        qg, kg = gr % R, (gr // R) % N
        jg, ig = (gr // (R * N)) % N, gr // (R * N * N)
        vals = fun_l(assemble_indices(ltab, rtab, p, *(x.expand(L, -1) for x in (ig, jg, kg, qg)), d))
        mask = (_col_mask(st, p).reshape(L, RN, 1)
                & _row_mask(st, p).reshape(L, 1, N * R))                   # (L, RN, NR)
        vals = torch.where(mask, vals.reshape(L, RN, N * R), 0.0)
        amax = torch.maximum(st.amax, vals.abs().amax(dim=(1, 2)))
        neval = st.neval + (st.rk[p] * n[p] * n[p + 1] * st.rk[p + 2]).long()
        st = st._replace(amax=amax, neval=neval, padded=st.padded + RN * N * R)

        colf_m = st.colf[p].reshape(L, RN, R) * _rank_mask(st, p)[:, None, :]
        rowf = st.rowf[p + 1].reshape(L, R, N * R)
        picks = [score_residual_argmax(vals[i], colf_m[i], rowf[i], mask[i]) for i in range(L)]
        flat, pivot = torch.stack([x[0] for x in picks]), torch.stack([x[2] for x in picks])
        row, colx = flat // (N * R), flat % (N * R)
        acol = vals.gather(2, colx.view(L, 1, 1).expand(L, RN, 1)).reshape(L, R, N)
        arow = vals.gather(1, row.view(L, 1, 1).expand(L, 1, N * R)).reshape(L, N, R)
        return st, (row // N, row % N, colx // R, colx % R), pivot, acol, arow

    def _accept(st, p, piv_idx, pivot, acol, arow, upd, own_lo=0, own_hi=d - 1):
        """Append the accepted pivots: extend vip / LU / cores / factors
        (dmrgg.f90:602-757), all IN PLACE at each lane's slot s = rk[p+1]
        and masked by the tensor flags upd, so a rejected pivot leaves its
        lane's state as it was (JAX: dynamic_update_slice of where(upd,
        new, old)).  own_lo / own_hi bound the bond slab a distributed rank
        owns (the whole train otherwise): the factor slices across the
        slab's edges are left to the distributed engine's boundary fixup,
        as the reference's `p > own(me)` / `p < own(me+1)-1` guards do
        (dmrgg.f90:715, 730).  Returns (st, c_new, u_new): the LU border
        row and column, masked to the active rank."""
        ii, jj, kk, qq = piv_idx
        s = st.rk[p + 1].long()
        slot = s.clamp(max=R - 1)   # a saturated bond never accepts
        rmask = (iR[None, :] < s[:, None]).to(dtype)                       # (L, R)
        colf = st.colf[p].reshape(L, RN, R)
        rowf = st.rowf[p + 1].reshape(L, R, N * R)
        c_new = colf.gather(1, (ii * N + jj).view(L, 1, 1).expand(L, 1, R))[:, 0] * rmask
        u_new = rowf.gather(2, (kk * R + qq).view(L, 1, 1).expand(L, R, 1))[:, :, 0] * rmask
        # maintained triangular inverses (bordered-inverse recurrences):
        # L_{s+1}^-1 = [[L^-1, 0], [-c L^-1, 1]],
        # T_{s+1}^-1 = [[T^-1, -T^-1 u / delta], [0, 1/delta]]
        at_slot = iR[None, :] == s[:, None]
        new_row = torch.where(at_slot, 1.0, -_mv(st.itl[p].mT, c_new))
        new_col = torch.where(at_slot, 1.0 / pivot[:, None], -_mv(st.itt[p], u_new) / pivot[:, None])
        # incremental factor updates (dmrgg.f90:687-713), from the factors
        # as they were before this accept: the new col-factor column
        # (acol - Cf @ u) / delta and row-factor row arow - c @ Rf
        new_colf = (acol - _mv(colf, u_new * rmask).reshape(L, R, N)) / pivot[:, None, None]
        new_rowf = arow - _mv(rowf.mT, c_new * rmask).reshape(L, N, R)

        masked_slot_write(st.vip[p], 1, slot, torch.stack([ii, jj, kk, qq], 1).to(torch.int32), upd)
        masked_slot_write(st.lu_c[p], 1, slot, c_new, upd)
        masked_slot_write(st.lu_u[p], 1, slot, u_new, upd)
        masked_slot_write(st.lu_d[p], 1, slot, pivot, upd)
        masked_slot_write(st.itl[p], 1, slot, new_row, upd)
        masked_slot_write(st.itt[p], 2, slot, new_col, upd)
        # raw fibers into cores (dmrgg.f90:662-685)
        masked_slot_write(st.cores[p], 3, slot, acol, upd)
        masked_slot_write(st.cores[p + 1], 1, slot, arow, upd)
        masked_slot_write(st.colf[p], 3, slot, new_colf, upd)
        masked_slot_write(st.rowf[p + 1], 1, slot, new_rowf, upd)
        if p > own_lo:
            # row factor of bond p-1 on core p gains the new column with the
            # bond p-1 L-solve applied (dmrgg.f90:715-728)
            masked_slot_write(st.rowf[p], 3, slot, matmul_by_sums(st.itl[p - 1], acol), upd)
        if p < own_hi - 1:
            # col factor of bond p+1 on core p+1 gains the new row with the
            # bond p+1 T-solve applied (dmrgg.f90:730-749)
            masked_slot_write(st.colf[p + 1], 1, slot, matmul_by_sums(arow, st.itt[p + 1]), upd)

        apiv = pivot.abs()
        pivotmax = torch.where(upd & (st.pivotmax < 0), apiv,
                               torch.where(upd, torch.maximum(st.pivotmax, apiv),
                                           st.pivotmax))
        pivotmin = torch.where(upd & (st.pivotmin < 0), apiv,
                               torch.where(upd, torch.minimum(st.pivotmin, apiv),
                                           st.pivotmin))
        st.rk[p + 1] += upd.to(torch.int32)     # in place
        return st._replace(pivotmax=pivotmax, pivotmin=pivotmin), c_new, u_new

    def _caps(p: int):
        """Bond p's padded candidate ranks (Rl, Rr) and its rank bound Rb:
        (R, R, R), or on a capped sweep min(R, cap) of the neighbouring
        bonds and of the bond itself (1 beyond the ends of the train)."""
        if cfg.caps is None:
            return R, R, R
        Rl = 1 if p == 0 else min(R, int(cfg.caps[p - 1]))
        Rr = 1 if p == d - 2 else min(R, int(cfg.caps[p + 1]))
        return Rl, Rr, min(R, int(cfg.caps[p]))

    def _visit(st: CrossState, p: int, fwd: bool, ltab, rtab, u2, lw=None,
               live=None, own_lo: int = 0, own_hi: int = d - 1):
        """Hunt + (maybe) accept at bond p in every lane; u2 (L, 2, NLOT)
        lottery uniforms, lw the lottery weights of a weighted draw, live
        (L,) the lanes that may accept (None: all), own_lo / own_hi the
        slab of a distributed rank (_accept).  Returns (st, upd, (ii, jj,
        kk, qq), pivot, c_new, u_new).

        Capped (cfg.caps, rank_caps; ttcross_tpu/cross/engine.py:835-1002):
        the lottery and the rook fibers are evaluated at (Rl, N) / (N, Rr),
        the rook passes run col, row, ... whatever the direction, and the
        bond accepts while its rank is below its cap.  Adaptive
        (cfg.adaptive, :748-771): the hunt's fibers count only where the
        lottery residual, amplified by cfg.adaptive, clears both accept
        thresholds at a bond below rank R; elsewhere the hunt's results are
        dropped by torch.where, as jax.vmap of lax.cond selects (its
        integrand calls still run: the saving is in counted evaluations,
        and no host sync decides the gate)."""
        Rl, Rr, Rb = _caps(p)
        if cfg.piv == -1:
            st, piv_idx, pivot, acol, arow = _hunt_full(st, p, ltab, rtab)
        else:
            st0, seed, pivot0 = _hunt_lottery(st, p, ltab, rtab, u2, lw, Rl, Rr)
            if cfg.piv == 0:
                st, piv_idx, pivot, acol, arow = _hunt_piv0(st0, p, ltab, rtab, seed, pivot0,
                                                            Rl, Rr)
            else:
                st, piv_idx, pivot, acol, arow = _rook(st0, p, ltab, rtab, seed, pivot0,
                                                       fwd or cfg.caps is not None, Rl, Rr)
            if cfg.adaptive > 0:
                probe = pivot0.abs() * cfg.adaptive
                gate = ((probe > cfg.small_element * st0.amax)
                        & (probe > cfg.small_pivot * st0.pivotmax_prev)
                        & (st0.rk[p + 1] < R))
                st = st._replace(**{f: torch.where(gate, getattr(st, f), getattr(st0, f))
                                    for f in ("amax", "neval", "padded")})
                piv_idx = tuple(torch.where(gate, a, s) for a, s in zip(piv_idx, seed))
                pivot = torch.where(gate, pivot, 0.0)
                acol = torch.where(gate[:, None, None], acol, 0.0)
                arow = torch.where(gate[:, None, None], arow, 0.0)
            if Rl < R:
                acol = F.pad(acol, (0, 0, 0, R - Rl))
            if Rr < R:
                arow = F.pad(arow, (0, R - Rr))
        upd = ((pivot.abs() > cfg.small_element * st.amax)
               & (pivot.abs() > cfg.small_pivot * st.pivotmax_prev)
               & (st.rk[p + 1] < Rb))
        if live is not None:
            upd = upd & live
        st, c_new, u_new = _accept(st, p, piv_idx, pivot, acol, arow, upd, own_lo, own_hi)
        return st, upd, piv_idx, pivot, c_new, u_new

    def sweep_lanes(st: CrossState, it: int, U, lw=None, live=None) -> CrossState:
        """One sequential sweep of every lane: '>>' on odd it, '<<' on even
        (dmrgg.f90:314-323).  U (L, d-1, 2, NLOT).  The chain tables of
        the direction swept away from are built once; those swept into
        advance per bond.  live (L,) bool: a lane that is not live keeps
        its state (JAX: vmap of the while loop selects a finished lane's
        old carry); None: every lane is live."""
        fwd = it % 2 == 1
        old = st
        neg = torch.full((L,), -1.0, dtype=dtype, device=dev)
        st = st._replace(pivotmax=neg, pivotmin=neg)
        AT = all_right_tables(st.vip, d) if fwd else all_left_tables(st.vip, d)
        tab = torch.zeros((L, R, d), dtype=st.vip.dtype, device=dev)
        for idx in range(d - 1):
            p = idx if fwd else d - 2 - idx
            ltab = tab if fwd else AT[p]
            rtab = AT[p] if fwd else tab
            st = _visit(st, p, fwd, ltab, rtab, U[:, p], lw, live)[0]
            tab = (advance_left(tab, st.vip[p], p) if fwd
                   else advance_right(tab, st.vip[p], p - 1))
        st = st._replace(pivotmax_prev=st.pivotmax)
        if live is None:
            return st
        return st._replace(**{f: torch.where(live, getattr(st, f), getattr(old, f))
                              for f in _SCALARS})

    chain_ev = None if chain is None else ChainEvaluator(chain, d, dtype)
    sweep_jac, jacobi_hunt, jacobi_apply = build_jacobi(
        cfg, fun_l if lanes else fun, d, N, R, NLOT, iR, iN, n_t, chain_ev=chain_ev,
        dtype=dtype, lanes=lanes)

    def mats_lanes(st: CrossState, w) -> torch.Tensor:
        """The LU-solved (R, R) contraction matrix of every core against
        the weights w (d, N) (the ttqq core + dtt_lua application,
        dmrgg.f90:986-992): (d, L, R, R).  Products summed as in
        matmul_by_sums, so a lane's matrices are its single run's."""
        mats = (st.cores * w[:, None, None, :, None]).sum(dim=3)    # (d, L, R, R)
        mats[1:] = matmul_by_sums(st.itl, mats[1:])
        mats[:-1] = matmul_by_sums(mats[:-1], st.itt)
        return mats

    def value_lanes(st: CrossState, w) -> torch.Tensor:
        """Quadrature value of each lane's current cross against per-mode
        weights w (d, N), with the growing-LU inverses applied (ttqq +
        dtt_lua + dtt_quad, dmrgg.f90:975-1006), as a norm-balanced
        product chain; (L,)."""
        P, ex = balanced_matmul_chain(mats_lanes(st, w))
        return scale_pow2(P[..., 0, 0], ex)

    def finalize_lanes(st: CrossState) -> torch.Tensor:
        """Apply the LU inverses to all raw cores (dtt_lua,
        dmrgg.f90:1169-1258): (d, L, R, N, R) solved cores."""
        g = st.cores.clone()
        g[1:] = torch.einsum("clab,clbnj->clanj", st.itl, st.cores[1:])
        g[:-1] = torch.einsum("clanb,clbj->clanj", g[:-1], st.itt)
        return g

    if lanes:
        def sweep_fn_lanes(st: CrossState, it: int, U, lw=None, live=None) -> CrossState:
            """One sweep of every live lane: sequential, or all-bonds batched
            (cfg.jacobi) with every (bond, lane) row in one batch."""
            if cfg.jacobi:
                return sweep_jac(st, it % 2 == 1, U, lw=lw, live=live)
            return sweep_lanes(st, it, U, lw, live)

        return EngineKit(cfg=cfg, init_fn=init_fn, sweep_fn=sweep_fn_lanes,
                         value_fn=value_lanes, finalize_fn=finalize_lanes,
                         jacobi_hunt=jacobi_hunt, jacobi_apply=jacobi_apply, chain_ev=chain_ev,
                         lanes=lanes)

    def visit_bond(st: CrossState, p: int, fwd: bool, own_lo: int, own_hi: int, ltab, rtab, u2):
        """Hunt + (maybe) accept at bond p of one run, the distributed
        engine's step (ttcross_tpu/cross/engine.py:713-783): ltab, rtab
        (R, d) the bond's chain tables, u2 (2, NLOT) its lottery uniforms,
        own_lo / own_hi the rank's bond slab.  Returns (st, tape_i (5,)
        int32 = (accepted, ii, jj, kk, qq), tape_f (2R+1,) = (c border, u
        border, pivot)), both zero where the pivot was rejected: the record
        a rank ships so that the others replay vip, rk and the LU."""
        stl, upd, (ii, jj, kk, qq), pivot, c_new, u_new = _visit(
            as_lanes(st), p, fwd, ltab[None], rtab[None], u2[None], None, None, own_lo, own_hi)
        tape_i = torch.where(upd[:, None], torch.stack(
            [torch.ones_like(ii), ii, jj, kk, qq], 1), 0).to(torch.int32)[0]
        tape_f = torch.where(upd[:, None], torch.cat([c_new, u_new, pivot[:, None]], 1), 0.0)[0]
        return lane(stl, 0), tape_i, tape_f

    def eval_col_fiber(st: CrossState, p: int, ltab, rtab, kk, qq):
        """The raw column fiber (R, N) of bond p of one run at (kk, qq),
        masked to the active block: (fiber, amax', neval', padded')."""
        stl = as_lanes(st)
        vals, cnt = _col_fiber(stl, p, ltab[None], rtab[None], kk.view(1), qq.view(1))
        return (vals[0], torch.maximum(st.amax, vals.abs().amax()), st.neval + cnt[0],
                st.padded + R * N)

    def eval_row_fiber(st: CrossState, p: int, ltab, rtab, ii, jj):
        """The raw row fiber (N, R) of bond p of one run at (ii, jj)."""
        stl = as_lanes(st)
        vals, cnt = _row_fiber(stl, p, ltab[None], rtab[None], ii.view(1), jj.view(1))
        return (vals[0], torch.maximum(st.amax, vals.abs().amax()), st.neval + cnt[0],
                st.padded + N * R)

    def sweep_fn(st: CrossState, it: int, U, cs=None, lw=None, live=None):
        """One sweep over all bonds of one run: '>>' on odd it, '<<' on
        even.  U (d-1, 2, NLOT).  All-bonds-batched (cfg.jacobi): cs, the
        carried packed interface states of the chain path, makes the
        return (st, cs').  lw (d, N): the scaled lottery weights of a
        weighted draw.  live is accepted for the run loop's sake: one run
        is live in every sweep it makes."""
        if cfg.jacobi:
            return sweep_jac(st, it % 2 == 1, U, cs, lw)
        return lane(sweep_lanes(as_lanes(st), it, U[None], lw), 0)

    return EngineKit(cfg=cfg, init_fn=lambda: lane(init_fn(), 0), sweep_fn=sweep_fn,
                     value_fn=lambda st, w: value_lanes(as_lanes(st), w)[0],
                     finalize_fn=lambda st: finalize_lanes(as_lanes(st))[:, 0],
                     jacobi_hunt=jacobi_hunt, jacobi_apply=jacobi_apply, chain_ev=chain_ev,
                     visit_bond=visit_bond, eval_col_fiber=eval_col_fiber,
                     eval_row_fiber=eval_row_fiber,
                     value_mats=lambda st, w: mats_lanes(as_lanes(st), w)[:, 0],
                     init_neval=cfg.snum * int(min(n)) + int(sum(n)))


def finalize(st: CrossState, kit: EngineKit) -> TT:
    """The solved cores trimmed to the active ranks, as a TT."""
    cfg = kit.cfg
    rk = st.rk.tolist()
    solved = kit.finalize_fn(st)
    return TT(tuple(solved[c, : rk[c], : cfg.n[c], : rk[c + 1]].clone()
                    for c in range(cfg.d)))


def _apply_refine(res: CrossResult, fun, n, refine_sweeps: int, quad, truth,
                  state: CrossState, device, refine_fn=None) -> CrossResult:
    """Maxvol pivot-replacement post-pass (cross(refine_sweeps=k)): seed
    the alternating-maxvol refinement (cross/maxvol.py, or refine_fn with
    its signature: the distributed one, parallel/maxvol.py) with the greedy
    pivot sets of `state` and swap in the refined interpolant.  One 'mv'
    history record per call; neval and padded_evals accumulate."""
    from .maxvol import maxvol_refine

    I, J = pivot_index_sets(state.vip, state.rk)
    mv = (refine_fn or maxvol_refine)(fun, n, init_sets=(I, J), sweeps=int(refine_sweeps),
                                      quad=quad, truth=truth, device=device,
                                      dtype=state.cores.dtype)
    res.tt = mv.tt
    res.ranks = mv.ranks
    res.neval += mv.neval
    res.padded_evals += mv.padded_evals
    if quad is not None and mv.values:
        res.values.append(mv.values[-1])
        if truth is not None:
            res.errors.append(mv.errors[-1])
        else:
            prev = res.values[-2]
            res.errors.append(abs(1.0 - mv.values[-1] / prev) if prev != 0 else float("nan"))
        if res.history is not None:
            res.history.append(SweepRecord(
                it=res.sweeps + 1, direction="mv", n_evals=res.neval,
                pivotmax=float(res.history[-1].pivotmax) if res.history else 0.0,
                value=mv.values[-1],
                err=res.errors[-1] if truth is not None else None,
                cnv=None if truth is not None else res.errors[-1]))
    return res


def _apply_host_reeval(res: CrossResult, fun_np, n, rmax, quad, truth) -> CrossResult:
    """Host re-evaluation post-pass (cross(host_reeval=fun_np)): rebuild
    the train from fun_np's data at the run's frozen pivot skeleton,
    TT-SVD-round it on the host to rmax when given, and value it on the host
    (ttcross_tpu/cross/engine.py:169-211).  neval and padded_evals grow by
    the skeleton's samples (real integrand calls); the value is appended
    with a direction-'hr' history record.  res.state must hold the pivots
    (return_pivots' shim or a CrossState)."""
    from ..tt.ortho import svd_round_host
    from .skeleton import extract_skeleton, reevaluate_host

    dev = res.tt.device
    skel = extract_skeleton(res, n, device=dev)
    cores = reevaluate_host(fun_np, skel)
    if rmax is not None:
        cores = svd_round_host(cores, tol=0.0, rmax=rmax)
    res.tt = TT(tuple(torch.from_numpy(c).to(dev) for c in cores))
    res.ranks = tuple(res.tt.r)
    res.neval += skel.n_samples
    if res.padded_evals is not None:
        res.padded_evals += skel.n_samples
    if quad is not None:
        v = np.ones((1, 1))
        for c, g in enumerate(cores):
            v = v @ np.einsum("inj,n->ij", g, np.asarray(quad[c], np.float64))
        val = float(v[0, 0])
        res.values.append(val)
        if truth is not None:
            res.errors.append(abs(1.0 - val / truth))
        else:
            prev = res.values[-2]
            res.errors.append(abs(1.0 - val / prev) if prev != 0 else float("nan"))
        if res.history is not None:
            res.history.append(SweepRecord(
                it=res.sweeps + 1, direction="hr", n_evals=res.neval,
                pivotmax=float(res.history[-1].pivotmax) if res.history else 0.0,
                value=val,
                err=res.errors[-1] if truth is not None else None,
                cnv=None if truth is not None else res.errors[-1]))
    return res


def _pivot_shim(st: CrossState) -> SimpleNamespace:
    """cross(return_pivots=True)'s light state: vip and rk as host numpy,
    what cross/skeleton.py::extract_skeleton reads."""
    return SimpleNamespace(vip=st.vip.cpu().numpy(), rk=st.rk.cpu().numpy())


def run_sweeps(kit: EngineKit, st: CrossState, uniforms, w=None, *, accuracy=None,
               max_sweeps: int, it0: int = 0, cs=None, lw=None, strike=None):
    """Sweeps it0+1 .. it0+max_sweeps of one run (kit.lanes = 0) or of
    every lane of a lane state, with the strike-based stop
    (dmrgg.f90:1010-1019) per run: after 3 quiet sweeps in a row a run
    stops; in a lane state it is frozen while the other lanes go on.
    uniforms[it - 1]: sweep it's lottery uniforms; w (d, N): the quadrature
    weights of the per-sweep values (None: no values); strike: one run's
    quiet sweeps counted before this call (a chunked run carries them from
    one chunk to the next; None: 0).  The one host sync per sweep is the stop.
    Returns (st, cs, sweeps made, values, pivotmax and n_evals per sweep,
    strike) as numpy, the first and the last with the state's lane shape,
    the others (max_sweeps + 1, ...)."""
    shape, dev = st.amax.shape, st.amax.device
    vals = torch.zeros((max_sweeps + 1,) + shape, dtype=st.amax.dtype, device=dev)
    pmax = torch.zeros_like(vals)
    nev = torch.zeros((max_sweeps + 1,) + shape, dtype=torch.int64, device=dev)
    if w is not None:
        vals[0] = kit.value_fn(st, w)
    strike = torch.full(shape, int(strike or 0), dtype=torch.int64, device=dev)
    live = strike < 3
    last = torch.zeros(shape, dtype=torch.int64, device=dev)
    for it in range(1, max_sweeps + 1):
        if cs is None:
            st = kit.sweep_fn(st, it0 + it, uniforms[it - 1], lw=lw,
                              live=live if kit.lanes else None)
        else:
            st, cs = kit.sweep_fn(st, it0 + it, uniforms[it - 1], cs, lw=lw)
        st = st._replace(sweeps=st.sweeps + live)
        if w is not None:
            vals[it] = kit.value_fn(st, w)
        pmax[it] = st.pivotmax
        nev[it] = st.neval
        last = torch.where(live, it, last)
        if accuracy is not None:
            strike = torch.where(live, torch.where(st.pivotmax <= accuracy * st.amax,
                                                   strike + 1, 0), strike)
            live = live & (strike < 3)
            if not bool(live.any()):
                break
    return (st, cs, last.cpu().numpy(), vals.cpu().numpy(), pmax.cpu().numpy(),
            nev.cpu().numpy(), strike.cpu().numpy())


def auto_chunks(max_rank: int, n_chunks: int = 4) -> list[int]:
    """The default rank-chunk schedule (cross(rank_chunks="auto")): evenly
    spaced padding levels ending at max_rank (ttcross_tpu/cross/engine.py:
    124-132).  With k chunks the padded fiber work is ~(k+1)/(2k) R^2
    against the exact ~R^2/2: 1.25x at k = 4."""
    if max_rank <= 6:
        return [max_rank]
    nch = n_chunks if max_rank >= 4 * n_chunks else 2
    ch = sorted({max(4, -(-max_rank * k // nch)) for k in range(1, nch + 1)})
    return [c for c in ch if c <= max_rank] if ch[-1] == max_rank else ch + [max_rank]


def chunk_plan(chunks, max_sweeps: int) -> list[tuple[int, int]]:
    """(padded rank, sweeps) per chunk of a chunked run
    (ttcross_tpu/cross/engine.py:1748-1763): a rank grows at most 1 per
    sweep, so chunk c covers the sweeps while the rank is <= chunks[c]; the
    schedule is cut to the sweep budget, and sweeps beyond it extend the
    last chunk."""
    lens = [chunks[0] - 1] + [b - a for a, b in zip(chunks[:-1], chunks[1:])]
    total = sum(lens)
    if max_sweeps < total:
        plan, used = [], 0
        for Rc, lc in zip(chunks, lens):
            lc = min(lc, max_sweeps - used)
            if lc <= 0:
                break
            plan.append((Rc, lc))
            used += lc
        return plan
    lens[-1] += max_sweeps - total
    return list(zip(chunks, lens))


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
    device: str | torch.device = "cuda",
) -> CrossResult:
    """Approximate the black-box tensor fun in TT format by DMRG-greedy
    cross interpolation; the signature of ttcross_tpu.cross.cross plus
    ``device``, which places the state (fun must accept int32 index
    tensors on that device): the card unless the caller asks for
    ``device="cpu"``.  Nothing probes for a GPU and nothing falls back:
    without one, the default raises at the first allocation.

    fun: batched integrand, ind (B, d) int32 -> (B,) values.
    n: per-mode sizes.  max_rank: padded/maximum TT rank.  accuracy: stop
    when max accepted pivot <= accuracy * amax for 3 consecutive sweeps.
    pivoting: -1 full / 0 lottery / k>=1 rook with up to 2k passes.
    quad: per-mode weight vectors -> per-sweep value and error.
    dtype: torch.float64 (the reference's double tier) or torch.float32
    (its real*4 tier: the state, the integrand's values and the kernels in
    f32, the thresholds of config.precision_thresholds(torch.float32));
    the integrand must return values of that dtype (the makers take
    ``dtype=``).
    oversample: cross at max_rank + oversample, then TT-SVD-round to
    max_rank.  key: seed of the CPU torch.Generator that draws the lottery
    uniforms, one block per sweep, so CPU and CUDA runs see the same draws.
    weighted_lottery: draw the lottery's candidates with probabilities
    proportional to |quad| per mode (needs quad) instead of uniformly; on
    the sequential sweep and on the all-bonds hunts.
    refine_sweeps: after the greedy cross, k alternating-maxvol sweeps
    (cross/maxvol.py) that replace the pivots at the same ranks; composes
    with oversample (cross at max_rank + oversample, refine there, round).
    init_state: resume from the state of an earlier run (return_state=True;
    tt/serialize.py saves and loads it).  The state counts its sweeps, so
    the resumed run goes on in the key's stream of uniforms and in the
    alternation of directions where the first one stopped: with the same
    key it repeats the uninterrupted run bit for bit.  The state is copied,
    not changed.
    return_pivots: res.state becomes a light shim of the pivots (vip and
    rk as host numpy), enough for cross/skeleton.py::extract_skeleton; the
    plain run only (ValueError with oversample, rank_chunks, refine_sweeps
    or init_state).
    host_reeval: re-evaluate the frozen pivot skeleton with a host
    integrand ``fun_np(ind (B, d) int numpy) -> (B,) f64 numpy`` (e.g.
    ``IsingProblem.fun_np``) and rebuild, round (to max_rank after an
    oversampled cross) and value the train on the host, as the JAX package
    does; n_evals counts the skeleton's samples.  True derives fun_np from
    fun (cross/skeleton.py::derive_host_fun): fun evaluated on the run's
    device, for the Ising problem on the card one fused-integrand launch.
    Plain or oversampled single-chunk runs only (ValueError with
    rank_chunks, refine_sweeps or init_state).
    rank_chunks: a rank-padding growth schedule (increasing, >= 2, ending
    at max_rank), or "auto" (auto_chunks): the first sweeps run at a
    small padded rank, so that the evaluated batches track the active
    ranks (~1.25x at 4 levels instead of ~R/rank); the state is re-embedded
    between chunks (cross/state.py::pad_state), the sweep counter and the
    quiet-sweep strike carry over, and each chunk draws its lottery at its
    own padded rank (the first 2(R_c + N) uniforms of each sweep's block).
    rank_caps: per-bond rank caps (d-1,), e.g. the rank profile of an
    earlier run: every bond's lottery and rook fibers are evaluated at the
    capped sizes (Rl, N) / (N, Rr), Rl / Rr = min(R, cap of the
    neighbouring bond), so a rank-heterogeneous train pays no padded work
    for one global rank; a capped sweep's rook passes run col, row, ...
    whatever the direction.  Sequential sweeps with pivoting >= 0 and no
    adaptive gating (ValueError otherwise).  With rank_chunks the C_6
    headline's padded ratio is ~1.15.
    adaptive: adaptive hunt gating (True = margin 4096, or a margin float):
    a bond's rook / piv0 fibers count only where `adaptive` times its
    lottery residual clears both accept thresholds at a bond below rank R;
    elsewhere the bond costs its lottery, in n_evals and padded_evals.  The
    hunt still runs and is dropped (no host sync decides it), so the saving
    is in counted evaluations, not in launches.  Sequential sweeps with
    pivoting >= 0 (ValueError otherwise).
    sweep_mode: 'sequential' (one bond after the other), or the
    all-bonds-batched sweeps for long chains (cross/engine_jacobi.py):
    'jacobi' (every bond hunts at once against the start-of-sweep factors)
    and 'jacobi-rb' (the even bonds hunt and accept, then the odd bonds);
    both need pivoting >= 0 (ValueError otherwise).
    chain: optional cross/chain_eval.py::ChainSpec of a chain-structured
    integrand (apps.ising: ``prob.chain``, kind C); the all-bonds sweeps
    then evaluate their hunt candidates in O(1) from carried interface
    states instead of O(d) integrand calls.  The sequential sweep ignores
    it.  With return_state the result carries them as ``chain_states``.
    use_pallas: accepted for API parity and changes nothing: on a CUDA
    state the hand-written kernels always run, on a CPU state their plain
    versions."""
    return _cross(fun, n, max_rank=max_rank, accuracy=accuracy,
                  pivoting=pivoting, quad=quad, truth=truth, key=key,
                  dtype=dtype, verbose=verbose, return_state=return_state,
                  max_sweeps=max_sweeps, small_element=small_element,
                  small_pivot=small_pivot, oversample=oversample,
                  sweep_mode=sweep_mode, device=device, chain=chain,
                  weighted_lottery=weighted_lottery, refine_sweeps=refine_sweeps,
                  init_state=init_state, return_pivots=return_pivots,
                  host_reeval=host_reeval, rank_chunks=rank_chunks,
                  rank_caps=rank_caps, adaptive=adaptive)


def _cross(fun, n, *, max_rank, accuracy, pivoting, quad, truth, key, dtype,
           verbose, return_state, max_sweeps, small_element, small_pivot,
           oversample, sweep_mode, device, chain=None, weighted_lottery=False,
           refine_sweeps=0, init_state=None, return_pivots=False, host_reeval=None,
           rank_chunks=None, rank_caps=None, adaptive=0.0, uniforms=None):
    """cross() with one more input: uniforms, (max_sweeps, d-1, 2, NLOT)
    lottery uniforms of the (possibly oversampled) run in place of the
    key's draws, and for a chunked run a sequence of one such block per
    chunk, (sweeps of the chunk, d-1, 2, 2(R_c + N)); the tests feed the
    JAX engine's draws through it.  The argument checks are the JAX
    package's (ttcross_tpu/cross/engine.py:1389-1550), in its order."""
    n = tuple(int(x) for x in n)
    d = len(n)
    if d < 2:
        raise ValueError("cross requires d >= 2")
    if max_rank < 2:
        raise ValueError("max_rank must be >= 2")
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"dtype must be torch.float64 or torch.float32, got {dtype}")
    if host_reeval is True:
        from .skeleton import derive_host_fun

        host_reeval = derive_host_fun(fun, device)
    elif host_reeval is False:
        host_reeval = None
    if host_reeval is not None and (rank_chunks is not None or refine_sweeps
                                    or init_state is not None):
        # the JAX package rebuilds from its fused path's packed pivots
        raise ValueError("host_reeval supports plain or oversampled single-chunk runs only")
    if return_pivots and (oversample or rank_chunks is not None
                          or refine_sweeps or init_state is not None):
        raise ValueError("return_pivots supports the plain single-chunk run only; "
                         "use return_state=True otherwise")
    if oversample:
        if return_state or init_state is not None:
            raise ValueError("oversample is incompatible with state passing")
        # refine_sweeps composes: cross at the inflated rank, replace the
        # pivots there, then round back to max_rank; host_reeval rebuilds
        # the inflated run's train on the host and rounds it there.  An
        # explicit chunk schedule is extended to the inflated rank, and the
        # caps get the same headroom
        r_over = max_rank + int(oversample)
        chunks_over = rank_chunks
        if rank_chunks is not None and rank_chunks != "auto":
            chunks_over = [int(x) for x in rank_chunks if int(x) < r_over] + [r_over]
        caps_over = None if rank_caps is None else [int(x) + int(oversample) for x in rank_caps]
        res = _cross(fun, n, max_rank=r_over,
                     accuracy=accuracy, pivoting=pivoting, quad=quad,
                     truth=truth, key=key, dtype=dtype, verbose=verbose,
                     return_state=False, max_sweeps=max_sweeps,
                     small_element=small_element, small_pivot=small_pivot,
                     oversample=0, sweep_mode=sweep_mode, device=device,
                     chain=chain, weighted_lottery=weighted_lottery,
                     refine_sweeps=refine_sweeps, uniforms=uniforms,
                     return_pivots=host_reeval is not None, rank_chunks=chunks_over,
                     rank_caps=caps_over, adaptive=adaptive)
        if host_reeval is None:
            return round_and_revalue(res, max_rank, quad, truth)
        res = _apply_host_reeval(res, host_reeval, n, max_rank, quad, truth)
        res.state = None
        return res
    se, sp = precision_thresholds(dtype)
    if small_element is not None:
        se = float(small_element)
    if small_pivot is not None:
        sp = float(small_pivot)
    if weighted_lottery and quad is None:
        raise ValueError("weighted_lottery requires quad weights")
    if sweep_mode not in ("sequential", "jacobi", "jacobi-rb"):
        raise ValueError(f"unknown sweep_mode {sweep_mode!r}")
    jacobi = sweep_mode != "sequential"
    if jacobi and int(pivoting) < 0:
        # the batched hunt has no full-pivoting branch
        raise ValueError("sweep_mode='jacobi' requires pivoting >= 0")
    adaptive = 4096.0 if adaptive is True else float(adaptive)
    if adaptive > 0:
        if int(pivoting) < 0:
            raise ValueError("adaptive gating requires pivoting >= 0 "
                             "(full pivoting has no lottery probe)")
        if jacobi:
            raise ValueError("adaptive gating applies to sequential sweeps")
    caps = None
    if rank_caps is not None:
        caps = tuple(int(x) for x in rank_caps)
        if len(caps) != d - 1 or min(caps) < 1:
            raise ValueError(f"rank_caps must be d-1 = {d - 1} positive "
                             f"per-bond caps; got {caps}")
        if jacobi:
            raise ValueError("rank_caps is not supported with jacobi sweeps")
        if int(pivoting) < 0:
            raise ValueError("rank_caps requires pivoting >= 0")
        if adaptive > 0:
            raise ValueError("adaptive gating is not supported with rank_caps (the capped "
                             "sweep shrinks batches statically instead)")
    cfg = CrossConfig(d=d, n=n, N=max(n), R=max_rank, piv=int(pivoting),
                      small_element=se, small_pivot=sp, wlot=bool(weighted_lottery),
                      jacobi=jacobi, rb=sweep_mode == "jacobi-rb", caps=caps,
                      adaptive=adaptive)
    if max_sweeps is None:
        max_sweeps = max_rank - 1
    chunks = None
    if rank_chunks is not None:
        chunks = auto_chunks(max_rank) if rank_chunks == "auto" else [int(x) for x in rank_chunks]
        if len(chunks) > 1 and max_sweeps >= 1:
            if init_state is not None:
                raise ValueError("rank_chunks cannot resume from init_state")
            if chunks != sorted(set(chunks)) or chunks[-1] != max_rank or chunks[0] < 2:
                raise ValueError(f"rank_chunks must be increasing, >= 2, ending at "
                                 f"max_rank={max_rank}; got {chunks}")
        else:
            chunks = None
    dev = torch.device(device)
    plan = chunk_plan(chunks, max_sweeps) if chunks else [(max_rank, max_sweeps)]
    it0 = 0
    if init_state is not None:
        if tuple(init_state.cores.shape) != (d, cfg.R, cfg.N, cfg.R):
            raise ValueError(f"init_state is padded as {tuple(init_state.cores.shape)}, this "
                             f"run as {(d, cfg.R, cfg.N, cfg.R)} (cross/state.py::pad_state "
                             "re-embeds a state at a larger rank)")
        it0 = int(init_state.sweeps)
    if uniforms is None:
        # one block per sweep at the largest padding; a chunk draws the
        # first 2(R_c + N) uniforms of each of its sweeps' blocks
        drawn = draw_uniforms(key, it0 + max_sweeps, d, 2 * (cfg.R + cfg.N))[it0:]
        uniforms, s0 = [], 0
        for Rc, len_c in plan:
            uniforms.append(drawn[s0:s0 + len_c, :, :, :2 * (Rc + cfg.N)])
            s0 += len_c
    elif chunks is None:
        uniforms = [uniforms]
    if len(uniforms) != len(plan):
        raise ValueError(f"uniforms must hold one block per chunk of {plan}")
    for i, (Rc, len_c) in enumerate(plan):
        U = torch.as_tensor(uniforms[i], dtype=torch.float64).to(dev)
        nlot = 2 * (Rc + cfg.N)
        if U.shape[0] < len_c or U.shape[1:] != (d - 1, 2, nlot):
            raise ValueError(f"uniforms must be ({len_c}, {d - 1}, 2, {nlot}), "
                             f"got {tuple(U.shape)}")
        uniforms[i] = U

    t0 = time.perf_counter()
    with_quad = quad is not None
    w = quad_matrix(quad, n, cfg.N, dev, dtype) if with_quad else None
    # weighted lottery: |w| per mode in f64, scaled to a maximum of 1 so
    # that the f32 CDF of small weights does not underflow
    lw = None
    if cfg.wlot:
        wa = quad_matrix(quad, n, cfg.N, dev, torch.float64).abs()
        lw = wa / wa.amax(dim=1, keepdim=True)

    st, cs, strike = None, None, 0
    vals_h, pmax_h, nev_h = [], [], []
    done = 0
    for i, (Rc, len_c) in enumerate(plan):
        kit = make_engine(fun, replace(cfg, R=Rc), dev, dtype, chain=chain)
        if i == 0:
            st = kit.init_fn() if init_state is None else CrossState(
                *(t.clone().to(dev) for t in init_state))
        else:
            st = pad_state(st, Rc)
        # chain + all-bonds sweeps: the packed interface states are built
        # once per chunk and carried through it, kept up to date after every
        # apply (vip is append-only, so existing rows never go stale)
        cs = kit.chain_ev.states_from_vip(st.vip) if jacobi and chain is not None else None
        st, cs, last, vals, pmax, nev, strike = run_sweeps(
            kit, st, uniforms[i], w, accuracy=accuracy, max_sweeps=len_c, it0=it0 + done,
            cs=cs, lw=lw, strike=strike)
        last = int(last)
        if i == 0:
            vals_h.append(vals[:1])
        vals_h.append(vals[1:last + 1])
        pmax_h.append(pmax[1:last + 1])
        nev_h.append(nev[1:last + 1])
        done += last
        if last < len_c or (accuracy is not None and int(strike) >= 3):
            break
    last_it = done
    vals_h = np.concatenate(vals_h)
    pmax_h = np.concatenate([[0.0]] + pmax_h)
    nev_h = np.concatenate([[0]] + nev_h)
    values, errors = _values_errors(vals_h, last_it, truth, with_quad)
    history = history_from_run(last_it, vals_h, pmax_h, nev_h, truth, with_quad, it0=it0)
    if verbose:
        _print_history(history)
    converged = accuracy is not None and (int(strike) >= 3 if chunks else last_it < max_sweeps)
    res = CrossResult(
        tt=finalize(st, kit), neval=int(st.neval), sweeps=last_it,
        ranks=tuple(st.rk.tolist()), values=values, errors=errors,
        time=time.perf_counter() - t0, converged=converged,
        history=history, padded_evals=int(st.padded))
    if refine_sweeps:
        res = _apply_refine(res, fun, n, refine_sweeps, quad, truth, st, dev)
        res.time = time.perf_counter() - t0
    if return_state:
        res.state, res.chain_states = st, cs
    elif return_pivots or host_reeval is not None:
        res.state = _pivot_shim(st)
    if host_reeval is not None:
        res = _apply_host_reeval(res, host_reeval, n, None, quad, truth)
        if not (return_state or return_pivots):
            res.state = None
    return res


def draw_uniforms(key: int, sweeps: int, d: int, nlot: int) -> torch.Tensor:
    """The lottery uniforms of a run with this key: one draw of (sweeps,
    d-1, 2, nlot) f64 on the CPU from torch.Generator().manual_seed(key),
    so that CPU and CUDA runs see the same stream and a run of s sweeps
    sees its first s blocks (a resumed run skips the blocks already used)."""
    gen = torch.Generator(device="cpu").manual_seed(int(key))
    return torch.rand((max(sweeps, 1), d - 1, 2, nlot), generator=gen, dtype=torch.float64)


def quad_matrix(quad, n, N: int, device, dtype) -> torch.Tensor:
    """Per-mode quadrature weights as one (d, N) tensor, zero-padded and
    filled on the host: one copy to the device, not d."""
    w = np.zeros((len(n), N))
    for c in range(len(n)):
        w[c, : n[c]] = np.asarray(quad[c])
    return torch.from_numpy(w).to(device, dtype)


def _print_history(history) -> None:
    for rec in history:
        line = (f"{rec.it:3d}{rec.direction} n_evals: {rec.n_evals:10d} "
                f"pivotmax {rec.pivotmax:9.3e}")
        if rec.err is not None:
            line += f" err {rec.err:9.3e} val {rec.value:.14e}"
        elif rec.cnv is not None:
            line += f" cnv {rec.cnv:9.3e} val {rec.value:.14e}"
        print(line)
