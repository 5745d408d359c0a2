"""Distributed arbitrary-precision cross over spawned worker processes.

Counterpart of ttcross_tpu/parallel/engine_mp.py (:35-163), the reference's
MPI-parallel multiprecision path (mptt_dmrgg, dmrggmp.f90:518-629): each
worker runs the mp engine (cross/engine_mp.py::MpEngine) over its own bond
slab and exchanges per-sweep tapes through the shared hub
(parallel/_hub.py); pickled mpf payloads stand in for the reference's
mpwds6-word MPI messages.  Host code, like the whole mp tier
(ttcross_tpu/ops/mp.py:1-17): no device.  The hub spawns its workers, so
fun_mp must pickle (apps/ising.py::IsingMP does), and each worker sets the
working precision itself (_MpAdapter.worker_ctx): a spawned process starts
at mpmath's default.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
from mpmath import mp, mpf

from ..cross.engine_mp import MpCrossResult, MpEngine, mp_tt_value
from ..cross.hostwalk import walk_index
from ..ops.mp import workdps
from ._hub import TierAdapter, run_hub

__all__ = ["cross_mp_parallel"]


class _MpAdapter(TierAdapter):
    """Object-mpf ndarray operations for the hub protocol.  mpf values and
    object arrays of them pickle, so they cross the pipes as they are."""

    tag = ""

    def __init__(self, dps, small_element_log10, small_pivot_log10):
        self.dps = dps
        self.se = small_element_log10
        self.sp = small_pivot_log10

    def worker_ctx(self):
        return workdps(self.dps)

    def parent_ctx(self):
        return workdps(self.dps)

    def make_engine(self, fun, n, max_rank, pivoting, snum, seed):
        return MpEngine(fun, n, max_rank, pivoting, self.dps, self.se, self.sp, snum, seed)

    def prep_quad(self, quad, n):
        return [np.array([mpf(v) for v in np.asarray(quad[c], dtype=object)], dtype=object)
                for c in range(len(n))]

    def prep_truth(self, truth):
        return mpf(truth) if not isinstance(truth, mpf) else truth

    def to_host(self, obj):
        return obj

    def from_host(self, obj):
        return obj

    def fixup_row(self, eng, rec):
        """Pad a remote acol with the missing rows when bond b-1 accepted
        this sweep after the owner evaluated it (corner fiber,
        dmrgg.f90:928-932)."""
        b = rec["b"]
        acol = rec["acol"]
        _, _, kk, qq = rec["ijkq"]
        r_cur = eng.r[b]                  # post-replay rank of bond b-1
        if acol.shape[0] == r_cur:
            return acol
        rows = []
        for i in range(acol.shape[0], r_cur):
            idx = np.array([walk_index(eng.vip, b, eng.d, i, j, kk, qq) for j in range(eng.n[b])],
                           dtype=np.int64)
            v = eng.fun_mp(idx)
            eng.neval += len(idx)
            rows.append(v.reshape(1, eng.n[b]))
        return np.concatenate([acol] + rows, axis=0)

    def fixup_col(self, eng, rec):
        """Pad a remote arow with the missing columns when bond b+1 accepted
        this sweep (the other boundary direction; the reference's mp engine
        ships both, dmrggmp.f90:518-629)."""
        b = rec["b"]
        arow = rec["arow"]
        ii, jj, _, _ = rec["ijkq"]
        r_cur = eng.r[b + 2]
        if arow.shape[1] == r_cur:
            return arow
        cols = []
        for q in range(arow.shape[1], r_cur):
            idx = np.array([walk_index(eng.vip, b, eng.d, ii, jj, k, q)
                            for k in range(eng.n[b + 1])], dtype=np.int64)
            v = eng.fun_mp(idx)
            eng.neval += len(idx)
            cols.append(v.reshape(eng.n[b + 1], 1))
        return np.concatenate([arow] + cols, axis=1)

    def append_core_right(self, eng, b, arow):
        eng.G[b + 1] = np.concatenate([eng.G[b + 1], arow[None, :, :]], axis=0)

    def value_partial(self, eng, w, own_cores):
        v = None
        for c in sorted(own_cores):
            M = np.tensordot(eng.G[c], w[c][: eng.G[c].shape[1]], axes=[[1], [0]])
            if c > 0:
                M = eng.itl[c - 1] @ M
            if c < eng.d - 1:
                M = M @ eng.itt[c]
            v = M if v is None else v @ M
        return v

    def combine_parts(self, v, part):
        return part if v is None else v @ part

    def value_scalar(self, v):
        return v[0, 0]

    def err(self, value, truth):
        return abs(1 - value / truth)

    def fmt_err_val(self, rec):
        return (f" err {mp.nstr(rec['err'], 5)} "
                f"val {mp.nstr(rec['value'], min(self.dps, 40))}")

    def tt_value(self, cores, w):
        return mp_tt_value(cores, w)

    def make_result(self, cores, value, neval, sweeps, ranks, history):
        return MpCrossResult(cores=cores, value=value, neval=neval, sweeps=sweeps, ranks=ranks,
                             history=history)


def cross_mp_parallel(
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
    n_workers: int = 2,
    mybonds=None,
    timeout: float = 600.0,
) -> MpCrossResult:
    """Bond-slab-distributed arbitrary-precision TT-cross: the mp tier's
    `mpirun -np N` path (mptt_dmrgg's MPI mode, dmrggmp.f90:11-704).  The
    contract of cross_mp plus n_workers / mybonds (n_workers <= d - 1,
    dmrgg.f90:114-117) and ``timeout`` (seconds any worker may take for one
    step).  Host code: no device.  The workers are spawned, so fun_mp must
    pickle (a module-level callable such as make_ising_mp's IsingMP)."""
    lacc = accuracy_log10 if accuracy_log10 is not None else -dps + 4
    ad = _MpAdapter(dps, small_element_log10, small_pivot_log10)
    return run_hub(ad, fun_mp, n, max_rank, pivoting, quad, truth, lacc, snum, seed, verbose,
                   n_workers, mybonds, name="cross_mp_parallel", timeout=timeout)
