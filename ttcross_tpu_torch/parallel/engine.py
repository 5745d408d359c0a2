"""Distributed DMRG-greedy cross over the ranks of a torch.distributed group.

Counterpart of ttcross_tpu/parallel/engine.py, the reference's MPI
dimension-parallel runtime (dmrgg.f90:120-131, 763-958; SURVEY.md §2.5).
Every rank is a process that holds the whole padded state, owns a
contiguous bond slab (parallel/mesh.py::share, or the caller's mybonds)
and runs the single-run engine's bond visit (cross/engine.py::EngineKit)
over that slab; global consistency is restored once per sweep with
collectives:

  reference (MPI)                      JAX package (shard_map)     here (torch.distributed)
  4-int pivot tape, 1-hop sendrecv     psum of disjoint tape rows  all_reduce(SUM) of the rows,
    (multi-hop staleness)                carrying the LU border      ints riding as floats:
                                                                     every rank replays vip,
                                                                     rk, the LU and the
                                                                     maintained inverses
  boundary core-slice ship             each rank re-evaluates      the same, eagerly
    (+ corner eval, dmrgg.f90:872-958)   its two boundary fibers
  3-scalar MPI_ALLREDUCE(MAX)          one all_gather of 5 floats  all_gather of the 5
  binary-tree pairwise GEMM reduce     stride-doubling ppermute    batch_isend_irecv, the
    (dtt_quad, dmrgg.f90:1356-1405)                                  same stride doubling

Cores and factors are owner-authoritative, as in the reference; vip,
ranks and the LU are replicated exactly: a rank writes nonzero tape rows
only for the bonds it owns, so each row of the summed tape is one rank's
row plus zeros, exact in any order of summation, and every rank replays it
with the owner's own arithmetic (ops/dense.py::matmul_by_sums at a batch
of any size).  The all-bonds sweeps (sweep_mode "jacobi" / "jacobi-rb")
hunt each rank's slab in one window (cross/engine_jacobi.py::jacobi_hunt)
and merge the hunts with one all_reduce, after which every rank runs the
same deterministic apply: the whole state stays replicated.

The stop rule is the one host sync per sweep, and it reads only the folded
(replicated) amax and pivotmax, so every rank stops at the same sweep.
The JAX package runs the whole multi-sweep run as one device call; here a
sweep is a Python loop of kernels, the collectives in between.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..config import precision_thresholds
from ..cross.chains import (advance_left, advance_right, all_left_tables, all_right_tables,
                            left_table, right_table)
from ..cross.engine import (CrossConfig, CrossResult, EngineKit, _apply_refine, _print_history,
                            _values_errors, draw_uniforms, finalize, make_engine, quad_matrix,
                            round_and_revalue)
from ..cross.state import CrossState
from ..ops.dense import (balanced_matmul_chain, masked_slot_write, matmul_by_sums,
                         pow2_balance_mats, scale_pow2)
from ..utils.metrics import history_from_run
from .mesh import BondMesh, all_gather, bond_mesh, psum, share, shift

__all__ = ["ParallelKit", "cross_parallel", "get_parallel_engine", "make_parallel_engine",
           "rank_key", "slab_bounds"]


def rank_key(key: int, rank: int) -> int:
    """The lottery seed of rank `rank` in cross_parallel(key=key): the
    counterpart of the JAX package's jax.random.fold_in(key, rank), a fixed
    mix of (key, rank) of 63 bits of numpy's SeedSequence (tagged apart from
    cross_batch's lane_key)."""
    state = np.random.SeedSequence([int(key), int(rank), 0x626F6E64]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))


def rank_uniforms(key: int, rank: int, sweeps: int, rows: int, nlot: int) -> torch.Tensor:
    """Rank `rank`'s lottery uniforms of a run: (sweeps, rows, 2, nlot), the
    draws of cross(key=rank_key(key, rank)) for rows + 1 modes, one block
    per sweep (rows = d-1 for the sequential sweep, the window of max_cnt
    bonds for the all-bonds sweeps)."""
    return draw_uniforms(rank_key(key, rank), sweeps, rows + 1, nlot)


def slab_bounds(d: int, ndev: int, mybonds=None) -> np.ndarray:
    """The (ndev+1,) slab boundaries of every distributed engine:
    share(d-1, ndev), or the caller's mybonds after the JAX package's
    checks."""
    if mybonds is None:
        return share(d - 1, ndev)
    own = np.asarray(mybonds, dtype=np.int32)
    if (own.shape != (ndev + 1,) or own[0] != 0 or own[-1] != d - 1
            or np.any(np.diff(own) < 1)):
        raise ValueError(f"mybonds must be {ndev + 1} increasing slab boundaries "
                         f"from 0 to {d - 1} with at least one bond per device; "
                         f"got {own.tolist()}")
    return own


class ParallelKit(NamedTuple):
    """One rank's distributed engine: the single-run kit it builds on, its
    slab [own_lo, own_hi), the widest slab (max_cnt, the rows of an
    all-bonds sweep's uniforms), and the phases: sweep_fn(st, it, U, cs) ->
    (st, n_evals, padded evals of all ranks, cs), value_fn(st, w) -> the
    replicated quadrature value, gather_fn(st) -> the replicated final
    state (authoritative cores, counters summed)."""

    kit: EngineKit
    mesh: BondMesh
    own_lo: int
    own_hi: int
    max_cnt: int
    sweep_fn: Callable
    value_fn: Callable
    gather_fn: Callable


def get_parallel_engine(fun: Callable, cfg: CrossConfig, mesh: BondMesh, mybonds=None,
                        chain=None, dtype: torch.dtype = torch.float64) -> ParallelKit:
    """The distributed engine of (fun, cfg) on this rank of `mesh`.  The
    port's engines are eager: nothing is compiled, so nothing is cached as
    the JAX package caches its shard_map'd runner."""
    return make_parallel_engine(fun, cfg, mesh, mybonds, chain=chain, dtype=dtype)


def make_parallel_engine(fun: Callable, cfg: CrossConfig, mesh: BondMesh, mybonds=None,
                         chain=None, dtype: torch.dtype = torch.float64) -> ParallelKit:
    """Build this rank's distributed engine (ttcross_tpu/parallel/engine.py:
    84-527).  mybonds: optional slab boundaries (ndev+1,) in place of the
    block share distribution (the reference's mybonds argument,
    dmrgg.f90:22, 120-131)."""
    dev = mesh.device
    kit = make_engine(fun, cfg, dev, dtype, chain=chain)
    d, N, R = cfg.d, cfg.N, cfg.R
    nb = d - 1
    ndev, me = mesh.size, mesh.rank
    own = slab_bounds(d, ndev, mybonds)
    own_lo, own_hi = int(own[me]), int(own[me + 1])
    max_cnt = int(np.max(own[1:] - own[:-1]))
    init_neval = kit.init_neval
    init_padded = cfg.snum * int(min(cfg.n)) + d * N
    iR = torch.arange(R, device=dev)
    bonds = torch.arange(nb, device=dev)
    owned = (bonds >= own_lo) & (bonds < own_hi)

    # ---------------------------------------------------------- sequential
    def local_sweep(st: CrossState, fwd: bool, U):
        """The sequential hunt over the owned slab ('>>' or '<<'), recording
        the tape: U (d-1, 2, NLOT), bond p drawing U[p]."""
        neg = torch.full((), -1.0, dtype=dtype, device=dev)
        st = st._replace(pivotmax=neg, pivotmin=neg)
        tape_i = torch.zeros((nb, 5), dtype=torch.int32, device=dev)
        tape_f = torch.zeros((nb, 2 * R + 1), dtype=dtype, device=dev)
        AT = all_right_tables(st.vip, d) if fwd else all_left_tables(st.vip, d)
        # the table advanced INTO starts at the slab's edge
        tab = left_table(st.vip, own_lo, d) if fwd else right_table(st.vip, own_hi - 1, d)
        for idx in range(own_hi - own_lo):
            p = own_lo + idx if fwd else own_hi - 1 - idx
            ltab, rtab = (tab, AT[p]) if fwd else (AT[p], tab)
            st, tape_i[p], tape_f[p] = kit.visit_bond(st, p, fwd, own_lo, own_hi, ltab, rtab,
                                                      U[p])
            tab = advance_left(tab, st.vip[p], p) if fwd else advance_right(tab, st.vip[p], p - 1)
        return st, tape_i, tape_f

    def replay(st: CrossState, TI, TF) -> CrossState:
        """Apply the other ranks' accepted pivots to vip, rk, the LU and the
        maintained inverses, every bond at once (the tape replay of
        dmrgg.f90:822-850, extended to the LU so the growing LU is exactly
        replicated): the owner's _accept arithmetic, batched over bonds."""
        acc = (TI[:, 0] > 0) & ~owned
        s = st.rk[1:d].long()
        slot = s.clamp(max=R - 1)
        c_new, u_new, pivot = TF[:, :R], TF[:, R:2 * R], TF[:, 2 * R]
        at_slot = iR[None, :] == s[:, None]
        new_row = torch.where(at_slot, 1.0,
                              -matmul_by_sums(st.itl.mT, c_new[:, :, None])[:, :, 0])
        new_col = torch.where(at_slot, 1.0 / pivot[:, None],
                              -matmul_by_sums(st.itt, u_new[:, :, None])[:, :, 0]
                              / pivot[:, None])
        masked_slot_write(st.vip, 1, slot, TI[:, 1:5], acc)
        masked_slot_write(st.lu_c, 1, slot, c_new, acc)
        masked_slot_write(st.lu_u, 1, slot, u_new, acc)
        masked_slot_write(st.lu_d, 1, slot, pivot, acc)
        masked_slot_write(st.itl, 1, slot, new_row, acc)
        masked_slot_write(st.itt, 2, slot, new_col, acc)
        st.rk[1:d] += acc.to(torch.int32)
        apiv = pivot.abs()
        hi = torch.where(acc, apiv, -torch.inf).amax()
        lo = torch.where(acc, apiv, torch.inf).amin()
        any_acc = acc.any()
        pivotmax = torch.where(any_acc & (st.pivotmax < 0), hi,
                               torch.where(any_acc, torch.maximum(st.pivotmax, hi), st.pivotmax))
        pivotmin = torch.where(any_acc & (st.pivotmin < 0), lo,
                               torch.where(any_acc, torch.minimum(st.pivotmin, lo), st.pivotmin))
        return st._replace(pivotmax=pivotmax, pivotmin=pivotmin)

    def _counted(st, do, amax, neval, padded):
        """The fixup fiber's amax and counts where its bond accepted."""
        return st._replace(amax=torch.where(do, amax, st.amax),
                           neval=torch.where(do, neval, st.neval),
                           padded=torch.where(do, padded, st.padded))

    def fixup(st: CrossState, TI) -> CrossState:
        """Boundary repairs after the replay (the reference's block ship and
        corner evaluation, dmrgg.f90:872-958).  Right edge: the right
        neighbour's first bond own_hi accepted a column -> re-evaluate that
        fiber (it includes the corner row of this rank's last-bond accept)
        and extend this rank's row factor of bond own_hi-1 with its L-solve
        (dmrgg.f90:940-951).  Left edge: the left neighbour's last bond
        own_lo-1 accepted a row -> re-evaluate that fiber into the
        authoritative core own_lo and backfill the column factor of bond
        own_lo with its T-solve (the update the reference's double engine
        skips across ranks).  Each fiber is evaluated whatever its bond did
        and counted only where it accepted, so nothing waits for the
        device."""
        if own_hi <= d - 2:
            bR = own_hi
            do = (TI[bR, 0] > 0).view(1)
            fiber, *counts = kit.eval_col_fiber(st, bR, left_table(st.vip, bR, d),
                                                right_table(st.vip, bR, d), TI[bR, 3], TI[bR, 4])
            st = _counted(st, do[0], *counts)
            s = (st.rk[bR + 1].long() - 1).clamp(min=0).view(1)
            masked_slot_write(st.rowf[bR:bR + 1], 3, s,
                              matmul_by_sums(st.itl[bR - 1], fiber)[None], do)
        if own_lo >= 1:
            bL, c0 = own_lo - 1, own_lo
            do = (TI[bL, 0] > 0).view(1)
            fiber, *counts = kit.eval_row_fiber(st, bL, left_table(st.vip, bL, d),
                                                right_table(st.vip, bL, d), TI[bL, 1], TI[bL, 2])
            st = _counted(st, do[0], *counts)
            s = (st.rk[c0].long() - 1).clamp(min=0).view(1)
            masked_slot_write(st.cores[c0:c0 + 1], 1, s, fiber[None], do)
            masked_slot_write(st.colf[c0:c0 + 1], 1, s,
                              matmul_by_sums(fiber, st.itt[c0])[None], do)
        return st

    def scalar_fold(st: CrossState):
        """The per-sweep reductions in ONE all_gather: max amax, max
        pivotmax, min pivotmin, and the sums of the evaluation counters,
        whose int64 deltas ride as f64 (exact to 2^53, whatever the state's
        dtype).  Returns (st, n_evals, padded evals) of all ranks."""
        f64 = torch.float64
        sc = torch.stack([st.amax.to(f64), st.pivotmax.to(f64),
                          torch.where(st.pivotmin < 0, torch.inf, st.pivotmin.to(f64)),
                          (st.neval - init_neval).to(f64), (st.padded - init_padded).to(f64)])
        G = all_gather(mesh, sc)                                         # (ndev, 5)
        pmin = G[:, 2].amin()
        pmax = G[:, 1].amax().to(dtype)
        st = st._replace(amax=G[:, 0].amax().to(dtype), pivotmax=pmax,
                         pivotmin=torch.where(torch.isinf(pmin), -1.0, pmin).to(dtype),
                         pivotmax_prev=pmax)
        return (st, G[:, 3].sum().to(torch.int64) + init_neval,
                G[:, 4].sum().to(torch.int64) + init_padded)

    def psweep(st: CrossState, it: int, U, cs=None):
        """One distributed sequential sweep: the local slab sweep, ONE
        all_reduce of the packed tape (float rows, then the int rows as
        floats: disjoint per bond, exact), the replay, the boundary fixup,
        and the scalar fold."""
        st, tape_i, tape_f = local_sweep(st, it % 2 == 1, U)
        TP = psum(mesh, torch.cat([tape_f, tape_i.to(dtype)], dim=1))   # (d-1, 2R+6)
        TF, TI = TP[:, :2 * R + 1], TP[:, 2 * R + 1:].round().to(torch.int32)
        st = fixup(replay(st, TI, TF), TI)
        return (*scalar_fold(st), cs)

    # -------------------------------------------------------------- jacobi
    base = min(own_lo, nb - max_cnt)
    idxs = base + torch.arange(max_cnt, device=dev)
    live_w = (idxs >= own_lo) & (idxs < own_hi)

    def jac_phase(st: CrossState, fwd: bool, U, live, live_global, cs):
        """One hunt of this rank's window rows `live` + ONE all_reduce that
        merges every rank's rows (an extra row carries each rank's amax in
        its own column, so the sum doubles as a gather for the max) + the
        replicated apply (live_global: a red-black phase's parity)."""
        hunt, amax_l, neval_l, padded_l = kit.jacobi_hunt(st, U, fwd, base, max_cnt, live, cs=cs)
        RN = R * N
        block = torch.cat([torch.stack([hunt[k].to(dtype) for k in ("ii", "jj", "kk", "qq")], 1),
                           hunt["pivot"][:, None], hunt["acol"].reshape(max_cnt, RN),
                           hunt["arow"].reshape(max_cnt, RN)], dim=1)
        rows = torch.zeros((nb + 1, 5 + 2 * RN), dtype=dtype, device=dev)
        # dead window rows by SELECTION, not multiplication: a dead row's
        # hunt outputs are garbage (jacobi_hunt's contract) and can be NaN,
        # which times 0 would poison the owner's row in the sum
        rows[base:base + max_cnt] = torch.where(live[:, None], block, 0.0)
        rows[nb, me] = amax_l
        TP = psum(mesh, rows)
        hunt_full = dict(ii=TP[:nb, 0].round().long(), jj=TP[:nb, 1].round().long(),
                         kk=TP[:nb, 2].round().long(), qq=TP[:nb, 3].round().long(),
                         pivot=TP[:nb, 4], acol=TP[:nb, 5:5 + RN].reshape(nb, R, N),
                         arow=TP[:nb, 5 + RN:].reshape(nb, N, R))
        st = st._replace(amax=TP[nb, :ndev].amax(), neval=neval_l, padded=padded_l)
        st, upd, slots = kit.jacobi_apply(st, hunt_full, owned, live=live_global,
                                          skip_corners=live_global is not None, ret_accept=True)
        if cs is not None:
            cs = kit.chain_ev.update_states(cs[0], cs[1], hunt_full["ii"], hunt_full["jj"],
                                            hunt_full["kk"], hunt_full["qq"], upd, slots)
        return st, cs

    def psweep_jacobi(st: CrossState, it: int, U, cs=None):
        """One distributed all-bonds sweep: each rank hunts its slab's
        bonds batched (U (max_cnt, 2, NLOT), its window's uniforms), the
        hunts merge, and every rank runs the same batched acceptance: the
        whole state stays replicated, with no tape replay or fixup.  Red-
        black: each phase hunts its parity's rows, merges and applies, so
        phase 2 sees phase 1's factors as the one-run sweep does."""
        fwd = it % 2 == 1
        if not cfg.rb:
            st, cs = jac_phase(st, fwd, U, live_w, None, cs)
            return (*scalar_fold(st), cs)
        pm_prev = st.pivotmax_prev
        pms, pns = [], []
        for par in (0, 1):
            st = st._replace(pivotmax_prev=pm_prev)
            st, cs = jac_phase(st, fwd, U, live_w & ((idxs % 2) == par), (bonds % 2) == par, cs)
            pms.append(st.pivotmax)
            pns.append(st.pivotmin)
        pm = torch.maximum(pms[0], pms[1])
        pn = torch.where(pns[0] < 0, pns[1],
                         torch.where(pns[1] < 0, pns[0], torch.minimum(pns[0], pns[1])))
        st = st._replace(pivotmax=pm, pivotmin=pn, pivotmax_prev=pm)
        return (*scalar_fold(st), cs)

    # --------------------------------------------------------------- value
    cnt_cores = own_hi - own_lo + (1 if me == ndev - 1 else 0)

    def pvalue(st: CrossState, w) -> torch.Tensor:
        """The distributed quadrature value: the ordered product of this
        rank's authoritative cores' LU-solved matrices (a balanced pairwise
        tree), then a log2(ndev)-depth stride-doubling fold (the reference's
        binary-tree pairwise GEMM reduce, dmrgg.f90:1356-1405): at step k
        each rank multiplies its partial with the partial 2^k ranks to its
        right, with an exact power-of-2 rebalance, so rank 0 ends with the
        whole ordered product; its [0, 0] entry (the boundary ranks are 1)
        is summed to every rank."""
        mats = kit.value_mats(st, w)                                     # (d, R, R)
        part, ex = balanced_matmul_chain(mats[own_lo:own_lo + cnt_cores])
        stride = 1
        while stride < ndev:
            msg = shift(mesh, torch.cat([part.reshape(-1), ex.to(part.dtype).view(1)]), stride)
            if me + stride < ndev:   # partials from past the right edge are dropped
                part, e = pow2_balance_mats(matmul_by_sums(part, msg[:-1].view(R, R)))
                ex = ex + msg[-1].to(torch.int64) + e
            stride *= 2
        val = scale_pow2(part[0, 0], ex)
        return psum(mesh, val if me == 0 else torch.zeros_like(val))

    # -------------------------------------------------------------- gather
    c_idx = torch.arange(d, device=dev)
    authority = ((c_idx >= own_lo) & (c_idx < own_hi)) | ((c_idx == d - 1) & (me == ndev - 1))

    def gather_fn(st: CrossState) -> CrossState:
        """The replicated final state: the authoritative cores summed over
        the ranks (all-bonds sweeps keep them replicated), and the
        evaluation counters of all ranks."""
        cores = st.cores if cfg.jacobi else psum(
            mesh, torch.where(authority[:, None, None, None], st.cores, 0.0))
        counts = psum(mesh, torch.stack([st.neval - init_neval, st.padded - init_padded]))
        return st._replace(cores=cores, neval=counts[0] + init_neval,
                           padded=counts[1] + init_padded)

    return ParallelKit(kit=kit, mesh=mesh, own_lo=own_lo, own_hi=own_hi, max_cnt=max_cnt,
                       sweep_fn=psweep_jacobi if cfg.jacobi else psweep, value_fn=pvalue,
                       gather_fn=gather_fn)


def cross_parallel(
    fun: Callable,
    n: Sequence[int],
    max_rank: int = 20,
    accuracy: float | None = None,
    pivoting: int = 1,
    quad: Sequence | None = None,
    truth: float | None = None,
    key: int = 0,
    dtype: torch.dtype = torch.float64,
    mesh: BondMesh | None = None,
    verbose: bool = False,
    mybonds=None,
    oversample: int = 0,
    sweep_mode: str = "sequential",
    refine_sweeps: int = 0,
    adaptive: float | bool = 0.0,
    chain=None,
    device: str | torch.device = "cuda",
    uniforms=None,
) -> CrossResult:
    """Distributed TT-cross over the bond axis of a torch.distributed group
    (the `mpirun -np N` path of the reference, dmrgg.f90's dimension-
    parallel mode); the signature of ttcross_tpu.parallel.cross_parallel
    plus ``device`` and the test-only ``uniforms``.  Every rank of the
    group calls it with the same arguments and returns the same result.
    Same contract as cross(); needs ranks <= d-1.

    mesh: parallel/mesh.py::bond_mesh of this rank (None: bond_mesh(device=
    device), the default group, which must be initialized).  device: the
    card unless the caller asks for the CPU; a mesh carries its own.
    mybonds: optional slab boundaries (ndev+1,), as dtt_dmrgg's mybonds.
    oversample: cross at max_rank + oversample, then TT-SVD-round
    (replicated, after the distributed cross).  sweep_mode: "sequential"
    (each rank walks its slab bond by bond, tape replay + boundary fixup),
    "jacobi" or "jacobi-rb" (each rank hunts its slab's bonds batched, the
    acceptance runs replicated: the throughput mode for long chains; with
    chain= the hunts evaluate from carried interface states).
    refine_sweeps: k distributed maxvol sweeps after the greedy cross
    (parallel/maxvol.py, the same ranks), as cross(refine_sweeps=k).
    adaptive: residual-gated hunts as in cross(adaptive=...); sequential
    sweeps only.  key: rank r draws its lottery uniforms from
    rank_key(key, r) (the JAX package's fold_in(key, r)).  uniforms
    (test-only): this rank's draws in place of the key's, (sweeps, d-1, 2,
    NLOT), or (sweeps, max_cnt, 2, NLOT) for the all-bonds sweeps, whose
    row t is bond base + t of the rank's window."""
    n = tuple(int(x) for x in n)
    d = len(n)
    if d < 2:
        raise ValueError("cross_parallel requires d >= 2")
    if sweep_mode not in ("sequential", "jacobi", "jacobi-rb"):
        raise ValueError(f"unknown sweep_mode {sweep_mode!r}")
    jacobi = sweep_mode != "sequential"
    if jacobi and int(pivoting) < 0:
        raise ValueError("sweep_mode='jacobi' requires pivoting >= 0")
    adaptive = 4096.0 if adaptive is True else float(adaptive)
    if adaptive > 0:
        if int(pivoting) < 0:
            raise ValueError("adaptive gating requires pivoting >= 0")
        if jacobi:
            raise ValueError("adaptive gating applies to sequential sweeps")
    if mesh is None:
        mesh = bond_mesh(device=device)
    if oversample:
        res = cross_parallel(fun, n, max_rank=max_rank + int(oversample), accuracy=accuracy,
                             pivoting=pivoting, quad=quad, truth=truth, key=key, dtype=dtype,
                             mesh=mesh, verbose=verbose, mybonds=mybonds,
                             sweep_mode=sweep_mode, refine_sweeps=refine_sweeps,
                             adaptive=adaptive, chain=chain, uniforms=uniforms)
        return round_and_revalue(res, max_rank, quad, truth)
    dev = mesh.device
    se, sp = precision_thresholds(dtype)
    cfg = CrossConfig(d=d, n=n, N=max(n), R=max_rank, piv=int(pivoting), small_element=se,
                      small_pivot=sp, jacobi=jacobi, rb=sweep_mode == "jacobi-rb",
                      adaptive=adaptive)
    pk = get_parallel_engine(fun, cfg, mesh, mybonds, chain=chain, dtype=dtype)
    max_sweeps = max_rank - 1
    rows = pk.max_cnt if jacobi else d - 1
    nlot = 2 * (cfg.R + cfg.N)
    if uniforms is None:
        uniforms = rank_uniforms(key, mesh.rank, max_sweeps, rows, nlot)
    U = torch.as_tensor(uniforms, dtype=torch.float64).to(dev)
    if U.shape[0] < max_sweeps or tuple(U.shape[1:]) != (rows, 2, nlot):
        raise ValueError(f"uniforms must be ({max_sweeps}, {rows}, 2, {nlot}), "
                         f"got {tuple(U.shape)}")

    t0 = time.perf_counter()
    st = pk.kit.init_fn()     # deterministic: the same on every rank
    with_quad = quad is not None
    w = quad_matrix(quad, n, cfg.N, dev, dtype) if with_quad else None
    vals = torch.zeros((max_sweeps + 1,), dtype=dtype, device=dev)
    pmax = torch.zeros_like(vals)
    nev = torch.zeros((max_sweeps + 1,), dtype=torch.int64, device=dev)
    if with_quad:
        vals[0] = pk.value_fn(st, w)
    cs = pk.kit.chain_ev.states_from_vip(st.vip) if jacobi and chain is not None else None
    strike = torch.zeros((), dtype=torch.int64, device=dev)
    last_it = 0
    for it in range(1, max_sweeps + 1):
        st, nev[it], _, cs = pk.sweep_fn(st, it, U[it - 1], cs)
        st = st._replace(sweeps=st.sweeps + 1)
        if with_quad:
            vals[it] = pk.value_fn(st, w)
        pmax[it] = st.pivotmax
        last_it = it
        if accuracy is not None:
            # the one host sync per sweep, on replicated values only: every
            # rank stops at the same sweep
            strike = torch.where(st.pivotmax <= accuracy * st.amax, strike + 1, 0)
            if int(strike) >= 3:
                break
    st = pk.gather_fn(st)
    vals, pmax, nev = (t.cpu().numpy() for t in (vals, pmax, nev))
    values, errors = _values_errors(vals, last_it, truth, with_quad)
    history = history_from_run(last_it, vals, pmax, nev, truth, with_quad)
    if verbose:
        _print_history(history)
    res = CrossResult(
        tt=finalize(st, pk.kit), neval=int(st.neval), sweeps=last_it,
        ranks=tuple(st.rk.tolist()), values=values, errors=errors,
        time=time.perf_counter() - t0,
        converged=accuracy is not None and last_it < max_sweeps,
        history=history, padded_evals=int(st.padded))
    if refine_sweeps:
        from .maxvol import maxvol_refine_parallel

        res = _apply_refine(res, fun, n, refine_sweeps, quad, truth, st, dev,
                            refine_fn=functools.partial(maxvol_refine_parallel, mesh=mesh,
                                                        mybonds=mybonds))
        res.time = time.perf_counter() - t0
    return res
