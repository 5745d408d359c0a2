"""Distributed double-double cross over the bond axis.

Counterpart of ttcross_tpu/parallel/engine_dd.py: the dd analogue of
parallel/engine.py, covering the reference's MPI-parallel multiprecision
engine (mptt_dmrgg, dmrggmp.f90:11-704; its bond-slab distribution and
boundary shipping at dmrggmp.f90:518-629).  Each rank owns a contiguous
bond slab and runs the one-run dd bond visit (cross/engine_dd.py, through
the dd kernels D1, D2 and D4 on the card); per sweep:

  * one all_reduce of the disjoint per-bond int tapes (accepted, i, j, k,
    q) and one of the dd tapes (the LU borders and the pivot, hi and lo
    planes side by side), after which every rank replays vip, rk and the
    maintained dd inverses with the owner's own arithmetic;
  * the boundary fibers re-evaluated by the rank that needs them, instead
    of shipped;
  * max reductions of the log10 amax and pivotmax.

The stop rule reads the reduced (replicated) log10 magnitudes, once per
sweep.  The finalization and the dd quadrature run on the replicated
result.
"""

from __future__ import annotations

import math
from decimal import Decimal, localcontext
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..cross.chains import (advance_left, advance_right, all_left_tables, all_right_tables,
                            left_table, right_table)
from ..cross.engine_dd import (DDConfig, DDCrossResult, DDKit, DDState, _mm, _sel, _vm,
                               dd_quad_cores, get_dd_engine, key_draws)
from ..ops.dd import DD, dd_div, dd_neg
from ..ops.dense import masked_slot_write
from ..ops.kernels import dd_score_residual_argmax
from .engine import rank_key, slab_bounds
from .mesh import BondMesh, all_gather, bond_mesh, gmax, psum

__all__ = ["ParallelDDKit", "cross_dd_parallel", "get_parallel_dd_engine",
           "make_parallel_dd_engine"]


class ParallelDDKit(NamedTuple):
    """One rank's distributed dd engine: the one-run dd kit, the rank's
    slab, and sweep_fn(st, it, draw) -> st (draw(idx, count_c, count_r) the
    lottery integers of the rank's idx-th visit of the sweep),
    nevals_fn(st) -> the evaluations of all ranks, value_fn(st, wh, wl) ->
    the replicated dd value of the current cross, gather_fn(st) -> the
    replicated final state."""

    kit: DDKit
    mesh: BondMesh
    own_lo: int
    own_hi: int
    sweep_fn: Callable
    nevals_fn: Callable
    value_fn: Callable
    gather_fn: Callable


def get_parallel_dd_engine(fun_dd: Callable, cfg: DDConfig, mesh: BondMesh,
                           mybonds=None) -> ParallelDDKit:
    """This rank's distributed dd engine (eager: nothing is cached)."""
    return make_parallel_dd_engine(fun_dd, cfg, mesh, mybonds)


def make_parallel_dd_engine(fun_dd: Callable, cfg: DDConfig, mesh: BondMesh,
                            mybonds=None) -> ParallelDDKit:
    """Build this rank's distributed dd engine (ttcross_tpu/parallel/
    engine_dd.py:58-305)."""
    dev = mesh.device
    kit = get_dd_engine(fun_dd, cfg, dev)
    d, N, R = cfg.d, cfg.N, cfg.R
    nb = d - 1
    ndev, me = mesh.size, mesh.rank
    own = slab_bounds(d, ndev, mybonds)
    own_lo, own_hi = int(own[me]), int(own[me + 1])
    iR = torch.arange(R, device=dev)
    init_neval = cfg.snum * int(min(cfg.n)) + int(sum(cfg.n))

    def local_sweep(st: DDState, it: int, draw):
        fwd = it % 2 == 1
        st = st._replace(pivotmax=torch.full_like(st.pivotmax, -math.inf))
        tape_i = torch.zeros((nb, 5), dtype=torch.int32, device=dev)
        tape_f = torch.zeros((nb, 4 * R + 2), dtype=torch.float64, device=dev)
        LT = all_left_tables(st.vip, d)
        RT = all_right_tables(st.vip, d)
        tab = LT[own_lo] if fwd else RT[own_hi - 1]
        for idx in range(own_hi - own_lo):
            p = own_lo + idx if fwd else own_hi - 1 - idx
            ltab, rtab = (tab, RT[p]) if fwd else (LT[p], tab)
            st, tape_i[p], tape_f[p] = kit.visit_bond(
                st, p, fwd, ltab, rtab, lambda cc, cr, idx=idx: draw(idx, cc, cr), own_lo, own_hi)
            tab = advance_left(tab, st.vip[p], p) if fwd else advance_right(tab, st.vip[p], p - 1)
        return st, tape_i, tape_f

    def replay(st: DDState, TI, TF) -> DDState:
        """The other ranks' accepted pivots into vip, rk and the maintained
        dd inverses (the dd rendering of dmrgg.f90:822-850), bond by bond
        with the owner's arithmetic of cross/engine_dd.py::visit_bond, each
        write masked by the bond's accept flag: nothing waits for the
        device."""
        for b in range(nb):
            if own_lo <= b < own_hi:
                continue
            acc = (TI[b, 0] > 0).view(1)
            s = st.rk[b + 1].long()
            slot = s.clamp(max=R - 1).view(1)
            c_new = DD(TF[b, :R], TF[b, R:2 * R])
            u_new = DD(TF[b, 2 * R:3 * R], TF[b, 3 * R:4 * R])
            pivot = DD(TF[b, 4 * R], TF[b, 4 * R + 1])
            itl_b, itt_b = _sel(st.itl, b), _sel(st.itt, b)
            row_raw = dd_neg(dd_score_residual_argmax(
                None, DD(*(x.expand(R, R) for x in c_new)), DD(*(x.T for x in itl_b)))[0])
            one_hot = iR == s
            new_row = DD(torch.where(one_hot, 1.0, row_raw.hi),
                         torch.where(one_hot, 0.0, row_raw.lo))
            col_raw = dd_div(dd_neg(dd_score_residual_argmax(
                None, itt_b, DD(*(x.expand(R, R) for x in u_new)))[0]),
                DD(*(x.expand(R) for x in pivot)))
            inv_piv = dd_div(DD(torch.ones_like(pivot.hi), torch.zeros_like(pivot.hi)), pivot)
            new_col = DD(torch.where(one_hot, inv_piv.hi, col_raw.hi),
                         torch.where(one_hot, inv_piv.lo, col_raw.lo))
            masked_slot_write(st.vip[b:b + 1], 1, slot, TI[b, 1:5][None], acc)
            for part, val in zip(st.itl, new_row):
                masked_slot_write(part[b:b + 1], 1, slot, val[None], acc)
            for part, val in zip(st.itt, new_col):
                masked_slot_write(part[b:b + 1], 2, slot, val[None], acc)
            st.rk[b + 1:b + 2] += acc.to(torch.int32)
            # log10-domain pivot magnitude (dmrggmp.f90:50-53)
            st = st._replace(pivotmax=torch.where(
                acc[0], torch.maximum(st.pivotmax, torch.log10(pivot.hi.abs())), st.pivotmax))
        return st

    def fixup(st: DDState, TI) -> DDState:
        """Boundary fiber repairs (the mp engine's both-direction boundary
        shipping, dmrggmp.f90:518-629, rendered as local re-evaluation):
        each fiber evaluated whatever its bond did, written and counted
        where it accepted."""
        if own_hi <= d - 2:
            bR = own_hi
            do = (TI[bR, 0] > 0).view(1)
            fiber, amax, neval = kit.eval_col(st, bR, left_table(st.vip, bR, d),
                                              right_table(st.vip, bR, d), TI[bR, 3], TI[bR, 4])
            st = st._replace(amax=torch.where(do[0], amax, st.amax),
                             neval=torch.where(do[0], neval, st.neval))
            slc = _mm(_sel(st.itl, bR - 1), fiber)                       # (R, N)
            s = (st.rk[bR + 1].long() - 1).clamp(min=0).view(1)
            for part, val in zip(st.rowf, slc):
                masked_slot_write(part[bR:bR + 1], 3, s, val[None], do)
        if own_lo >= 1:
            bL, c0 = own_lo - 1, own_lo
            do = (TI[bL, 0] > 0).view(1)
            fiber, amax, neval = kit.eval_row(st, bL, left_table(st.vip, bL, d),
                                              right_table(st.vip, bL, d), TI[bL, 1], TI[bL, 2])
            st = st._replace(amax=torch.where(do[0], amax, st.amax),
                             neval=torch.where(do[0], neval, st.neval))
            s = (st.rk[c0].long() - 1).clamp(min=0).view(1)
            for part, val in zip(st.cores, fiber):
                masked_slot_write(part[c0:c0 + 1], 1, s, val[None], do)
            for part, val in zip(st.colf, _mm(fiber, _sel(st.itt, c0))):
                masked_slot_write(part[c0:c0 + 1], 1, s, val[None], do)
        return st

    def psweep(st: DDState, it: int, draw) -> DDState:
        st, tape_i, tape_f = local_sweep(st, it, draw)
        TI, TF = psum(mesh, tape_i), psum(mesh, tape_f)
        st = fixup(replay(st, TI, TF), TI)
        pm = gmax(mesh, torch.stack([st.amax, st.pivotmax]))
        return st._replace(amax=pm[0], pivotmax=pm[1], pivotmax_prev=pm[1])

    def nevals_fn(st: DDState) -> torch.Tensor:
        return psum(mesh, st.neval - init_neval) + init_neval

    c_idx = torch.arange(d, device=dev)
    authority = ((c_idx >= own_lo) & (c_idx < own_hi)) | ((c_idx == d - 1) & (me == ndev - 1))

    def dist_value(st: DDState, wh, wl) -> DD:
        """The per-sweep dd quadrature value of the current cross (the mp
        tier's in-loop value line, dmrggmp.f90:655-672, and the mptt_quad
        reduction, :778-888): each rank chains the LU-solved dd matrices
        of its authoritative cores, the partial products are gathered in
        rank order and folded on every rank."""
        eye = torch.eye(R, dtype=torch.float64, device=dev)
        acc = DD(eye, torch.zeros_like(eye))
        for c in range(d):
            if bool(authority[c]):
                acc = _mm(acc, kit.value_mat(st, wh, wl, c))
        parts = all_gather(mesh, torch.stack([acc.hi, acc.lo]))           # (ndev, 2, R, R)
        v = DD(torch.zeros(R, dtype=torch.float64, device=dev),
               torch.zeros(R, dtype=torch.float64, device=dev))
        v.hi[0] = 1.0
        for w in range(ndev):
            v = _vm(v, DD(parts[w, 0], parts[w, 1]))
        return _sel(v, 0)

    def gather_fn(st: DDState) -> DDState:
        am = authority[:, None, None, None]
        cores = DD(psum(mesh, torch.where(am, st.cores.hi, 0.0)),
                   psum(mesh, torch.where(am, st.cores.lo, 0.0)))
        return st._replace(cores=cores, neval=nevals_fn(st))

    return ParallelDDKit(kit=kit, mesh=mesh, own_lo=own_lo, own_hi=own_hi, sweep_fn=psweep,
                         nevals_fn=nevals_fn, value_fn=dist_value, gather_fn=gather_fn)


def cross_dd_parallel(
    fun_dd: Callable,
    n: Sequence[int],
    weights_hi, weights_lo,
    max_rank: int = 32,
    accuracy: float = 1e-28,
    pivoting: int = 1,
    key: int = 0,
    small_element: float = 1e-30,
    small_pivot: float = 1e-12,
    mesh: BondMesh | None = None,
    mybonds=None,
    verbose: bool = False,
    truth=None,
    device: str | torch.device = "cuda",
    draws: Callable | None = None,
) -> DDCrossResult:
    """Distributed dd cross over the bond axis (the `mpirun -np N` path of
    the reference's multiprecision engine, dmrggmp.f90); the signature of
    ttcross_tpu.parallel.cross_dd_parallel plus ``device`` (for the default
    mesh, bond_mesh(device=device): the card unless the caller asks for
    the CPU) and the test-only ``draws``.  Same contract as cross_dd; needs
    ranks <= d-1.  Every rank calls it with the same arguments and returns
    the same result.

    key: rank r draws its lottery integers from rank_key(key, r) as
    cross_dd draws from its key (key_draws).  draws (test-only): (visit,
    count_c, count_r) -> (u_c, u_r), this rank's visit-th bond visit of the
    run (its slab's visits of sweep 1, then sweep 2, ...).  With verbose,
    each sweep prints the distributed dd value of the current cross with
    err vs `truth` or cnv vs the previous sweep."""
    n = tuple(int(x) for x in n)
    d = len(n)
    if mesh is None:
        mesh = bond_mesh(device=device)
    dev = mesh.device
    cfg = DDConfig(d=d, n=n, N=max(n), R=max_rank, piv=int(pivoting),
                   small_element=small_element, small_pivot=small_pivot)
    pk = get_parallel_dd_engine(fun_dd, cfg, mesh, mybonds)
    cnt = pk.own_hi - pk.own_lo
    if draws is None:
        draw_of = key_draws(rank_key(key, mesh.rank), max(max_rank - 1, 1), cnt + 1,
                            2 * (cfg.R + cfg.N), dev)
    else:
        def draw_of(it):
            return lambda idx, cc, cr: draws((it - 1) * cnt + idx, cc, cr)

    wh_pad = wl_pad = None
    if verbose:
        wh_pad = torch.zeros((d, cfg.N), dtype=torch.float64)
        wl_pad = torch.zeros((d, cfg.N), dtype=torch.float64)
        for c in range(d):
            wh_pad[c, : n[c]] = torch.as_tensor(np.asarray(weights_hi[c]))
            wl_pad[c, : n[c]] = torch.as_tensor(np.asarray(weights_lo[c]))
        wh_pad, wl_pad = wh_pad.to(dev), wl_pad.to(dev)
    st = pk.kit.init_fn()
    lacc = float(np.log10(accuracy))
    val_prev = None
    strike = 0
    it = 0
    while it + 1 < max_rank:
        it += 1
        st = pk.sweep_fn(st, it, draw_of(it))
        pm, am = (float(x) for x in torch.stack([st.pivotmax, st.amax]).cpu())
        if verbose:
            nev = int(pk.nevals_fn(st))
            v = pk.value_fn(st, wh_pad, wl_pad)
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
                val_prev = val
            if mesh.rank == 0:
                print(f"{it:3d}{'>>' if it % 2 == 1 else '<<'} dd lg(pivotmax) {pm:8.2f} "
                      f"n_evals {nev} {tag} val {val:.32e}")
        # the quiet test in log10 (dmrggmp.f90:50-53), on reduced values
        strike = strike + 1 if pm <= lacc + am else 0
        if strike >= 3:
            break

    st = pk.gather_fn(st)
    solved = pk.kit.finalize_fn(st)
    rk = st.rk.cpu().numpy()
    cores = [DD(solved.hi[c][: rk[c], : n[c], : rk[c + 1]], solved.lo[c][: rk[c], : n[c],
                                                                        : rk[c + 1]])
             for c in range(d)]
    value = dd_quad_cores([g.hi for g in cores], [g.lo for g in cores], weights_hi, weights_lo)
    return DDCrossResult(cores_hi=[g.hi.cpu().numpy() for g in cores],
                         cores_lo=[g.lo.cpu().numpy() for g in cores], value=value,
                         neval=int(st.neval), sweeps=it, ranks=tuple(int(x) for x in rk),
                         vip=st.vip.cpu().numpy())
