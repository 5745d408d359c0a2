"""Defect-corrected high-precision cross integration.

Counterpart of ttcross_tpu/cross/defect.py (:33-112): instead of running the
whole greedy engine in double-double, exploit that pivot SELECTION only
needs the resolution of the current residual scale:

  1. cross the integrand A in the fast f64 engine         -> TT1 (err ~1e-14 |A|)
  2. cross the DEFECT g = A_dd - TT1, where A is evaluated in dd arithmetic
     and TT1 is chain-evaluated in dd (the dd gather, D3 on the card); g
     fits f64 with full precision because it is ~1e-14 |A| in magnitude
                                                          -> TT2 (err ~1e-14 |g|)
  3. total = quad(TT1) + quad(TT2), each train contracted against the dd
     quadrature weights in dd (ops/dd.py::dd_contract), summed in decimal.

Every cross runs in the port's f64 engine (cross/engine.py), on the card
unless the caller asks for the CPU; dd arithmetic appears only inside the
defect integrand and the final contractions.  The JAX package contracts
with __float128 on the host (its native.contract_q); dd_contract carries
the same ~32 digits.

cross_defect_corrected_qd (ttcross_tpu/cross/defect.py:115-247) is the
quad-double variant: the defect integrand is the qd integrand (Q1 on the
card for the Ising problem) minus each earlier train gathered in qd (Q3),
rounded to f64, and each train is contracted against qd weights in qd
(ops/qd.py::qd_contract, Q4), the totals summed in decimal at 75 digits.
The JAX package evaluates that integrand in numpy behind a host callback;
here it runs where the crosses run, the card by default.
"""

from __future__ import annotations

from decimal import Decimal, localcontext

import torch

from ..ops.dd import DD, dd_contract, dd_sub, dd_to_float
from ..ops.kernels import dd_gather_tt_fused, pack_tt, qd_gather_tt_fused
from ..ops.qd import qd_contract, qd_from_mp, qd_sub, qd_to_float, qd_to_mp
from .engine import _cross

__all__ = ["cross_defect_corrected", "cross_defect_corrected_qd"]


class _Defect:
    """Residual integrand g = A_dd - sum of previous trains, evaluated in dd
    and returned as f64: fun_dd(ind), then per train its dd gather (one
    launch of D3 on the card), then hi + lo."""

    def __init__(self, fun_dd, trains):
        self.fun_dd = fun_dd
        self.trains = tuple(pack_tt(t) for t in trains)

    def __call__(self, ind):
        acc = self.fun_dd(ind)
        for t in self.trains:
            acc = dd_sub(acc, DD(*dd_gather_tt_fused(t, ind)))
        return dd_to_float(acc)


def _level_crosses(fun, defect, n, max_rank, max_rank2, levels, accuracy, pivoting, key,
                   verbose, mesh, device, uniforms):
    """Every level's f64 cross (level 0 of `fun`, level l of defect(trains
    so far)), key + l each; returns (trains, nevals, ranks)."""
    n = [int(x) for x in n]
    max_rank2 = max_rank2 or max_rank
    if uniforms is not None and len(uniforms) != levels:
        raise ValueError(f"uniforms must hold one block per level ({levels})")
    trains = []
    nevals, ranks = [], []
    k = key
    for lvl in range(levels):
        f, r = (fun, max_rank) if lvl == 0 else (defect(trains), max_rank2)
        U = None if uniforms is None else uniforms[lvl]
        if mesh is not None:
            from ..parallel.engine import cross_parallel

            res = cross_parallel(f, n, max_rank=r, accuracy=accuracy, pivoting=pivoting,
                                 key=k, mesh=mesh, verbose=verbose, uniforms=U)
        else:
            res = _cross(f, n, max_rank=r, accuracy=accuracy, pivoting=pivoting, quad=None,
                         truth=None, key=k, dtype=torch.float64, verbose=verbose,
                         return_state=False, max_sweeps=None, small_element=None,
                         small_pivot=None, oversample=0, sweep_mode="sequential",
                         device=device, uniforms=U)
        trains.append(res.tt)
        nevals.append(res.neval)
        ranks.append(res.ranks)
        k = k + 1 if isinstance(k, int) else k
    return trains, nevals, ranks


def cross_defect_corrected(
    fun, fun_dd, n, weights_hi, weights_lo,
    max_rank: int = 24, max_rank2: int | None = None,
    levels: int = 2,
    accuracy: float = 1e-13, pivoting: int = 1, key: int = 0,
    verbose: bool = False, mesh=None,
    device: str | torch.device = "cuda",
    uniforms=None,
):
    """Multi-level defect-corrected cross quadrature; the signature of
    ttcross_tpu.cross.defect.cross_defect_corrected plus ``device`` (the
    card unless the caller asks for ``device="cpu"``; fun and fun_dd take
    int32 indices there) and the test-only ``uniforms``.

    fun: f64 batched integrand (first cross).  fun_dd: the same integrand
    in dd arithmetic (ind -> DD).  weights_*: per-mode dd quadrature
    weights.  levels: number of crosses (2 = classic defect correction; 3
    adds a second correction over A - TT1 - TT2, limited by the ~1e-31
    absolute noise of dd evaluation).  Level l runs cross() with key
    key + l.  mesh: a bond mesh (parallel/mesh.py::bond_mesh) whose every
    rank calls with the same arguments: every level's cross then runs on
    the distributed engine (parallel/engine.py::cross_parallel; the
    reference's mp tier is MPI-parallel, dmrggmp.f90:518-629, and this is
    its defect-corrected analogue) and every rank returns the same result.
    uniforms (test-only): [U_1, ..., U_L], each level's lottery uniforms
    in place of its key's (cross/engine.py::_cross; on a mesh, this rank's,
    cross_parallel's uniforms).  Returns (hi, lo, info)."""
    trains, nevals, ranks = _level_crosses(fun, lambda ts: _Defect(fun_dd, ts), n, max_rank,
                                           max_rank2, levels, accuracy, pivoting, key, verbose,
                                           mesh, device, uniforms)
    with localcontext() as ctx:
        ctx.prec = 50
        qs = []
        total = Decimal(0)
        for t in trains:
            q = dd_contract(t, weights_hi, weights_lo)
            h, lo = float(q.hi), float(q.lo)
            qs.append((h, lo))
            total += Decimal(h) + Decimal(lo)
        hi = float(total)
        lo = float(total - Decimal(hi))
    info = {
        "neval1": nevals[0], "neval2": sum(nevals[1:]),
        "nevals": nevals, "ranks": ranks,
        "ranks1": ranks[0], "ranks2": ranks[-1],
        "q1": qs[0], "q2": qs[-1], "qs": qs,
    }
    return hi, lo, info


class _DefectQD:
    """Residual integrand g = A_qd - sum of previous trains, evaluated in
    quad-double arithmetic (~62 digits) and returned as f64: fun_qd(ind),
    then per train its qd gather (one launch of Q3 on the card), then the
    limbs summed to f64 (ops/qd.py::qd_to_float)."""

    def __init__(self, fun_qd, trains):
        self.fun_qd = fun_qd
        self.trains = tuple(pack_tt(t) for t in trains)

    def __call__(self, ind):
        acc = self.fun_qd(ind)
        for t in self.trains:
            acc = qd_sub(acc, qd_gather_tt_fused(t, ind))
        return qd_to_float(acc)


def cross_defect_corrected_qd(
    fun, fun_qd, n, weights_qd,
    max_rank: int = 24, max_rank2: int | None = None,
    levels: int = 3,
    accuracy: float = 1e-13, pivoting: int = 1, key: int = 0,
    verbose: bool = False, mesh=None,
    device: str | torch.device = "cuda",
    uniforms=None,
):
    """Multi-level defect-corrected cross quadrature at the quad-double tier;
    the signature of ttcross_tpu.cross.defect.cross_defect_corrected_qd plus
    ``device`` (the card unless the caller asks for ``device="cpu"``) and
    the test-only ``uniforms`` (as cross_defect_corrected's).

    With the defect integrand evaluated in qd (~1e-62 relative noise) the
    rank of the correction levels is the limit: the defect of an f64 train
    is noise-like, so size max_rank2 at or near full rank when >= 30 digits
    are wanted (the JAX package measured 33.7 digits on C_4, n = 33,
    levels = 3 at max_rank2 = 33, 22.0 at 30, on the CPU).  fun: the f64
    integrand (first cross).  fun_qd: ind -> QD, the same integrand in qd.
    weights_qd: per-mode QD weight vectors (on the device the trains are
    contracted on).  Level l runs cross() with key key + l; mesh: every
    level on the distributed engine, as cross_defect_corrected's.  Returns
    (limbs (4,), info): the qd quadrature total as four floats."""
    trains, nevals, ranks = _level_crosses(fun, lambda ts: _DefectQD(fun_qd, ts), n, max_rank,
                                           max_rank2, levels, accuracy, pivoting, key, verbose,
                                           mesh, device, uniforms)
    with localcontext() as ctx:
        ctx.prec = 75
        qs = []
        total = Decimal(0)
        for t in trains:
            limbs = tuple(float(e) for e in qd_contract(t, weights_qd))
            qs.append(limbs)
            total += qd_to_mp(*limbs)
        out = qd_from_mp(total)
    info = {"nevals": nevals, "ranks": ranks, "qs": qs, "levels": levels}
    return out, info
