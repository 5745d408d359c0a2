"""Distributed quad-double cross over spawned worker processes.

Counterpart of ttcross_tpu/parallel/engine_qd.py (:35-161), the qd sibling
of the reference's MPI-parallel multiprecision path (dmrggmp.f90:518-629):
cross_qd's engine (cross/engine_qd.py) keeps its pivot bookkeeping on the
host, so the distribution unit is a process, a pool of workers each
running QdEngine over its own bond slab and exchanging per-sweep tapes
through the shared hub (parallel/_hub.py).  The qd values of each worker
live on its device (the card by default; workers share one card when there
is one).  Tape payloads are QDs, sent over the pipes as host copies of the
four limbs, the limb-array analogue of the reference's mpwds6-word MPI
messages.  Protocol, consistency model and process management live in
_hub.py; this module supplies the qd arithmetic via a TierAdapter.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..cross.engine_qd import (QD_DPS, QdCrossResult, QdEngine, _expand, _sweep_line, as_qd,
                               qd_err)
from ..cross.hostwalk import walk_index
from ..ops.qd import QD, qd_concat, qd_get, qd_matmul, qd_tt_value, qd_vdot_axis
from ._hub import TierAdapter, run_hub

__all__ = ["cross_qd_parallel"]


class HostQD(NamedTuple):
    """A QD's four limbs as numpy arrays: what crosses a pipe."""
    e0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    e3: np.ndarray


class _QdAdapter(TierAdapter):
    """QD limb struct-of-arrays operations for the hub protocol, on
    `device` in every process."""

    tag = "qd"

    def __init__(self, small_element_log10, small_pivot_log10, device):
        self.se = small_element_log10
        self.sp = small_pivot_log10
        self.device = str(torch.device(device))

    def prepare_parent(self):
        if torch.device(self.device).type == "cuda":
            from ..ops import kernels

            kernels._lib()        # build (or find) and load the library once, here

    def make_engine(self, fun, n, max_rank, pivoting, snum, seed):
        return QdEngine(fun, n, max_rank, pivoting, self.se, self.sp, snum, seed, self.device)

    def prep_quad(self, quad, n):
        return [as_qd(quad[c], self.device) for c in range(len(n))]

    def to_host(self, obj):
        if isinstance(obj, QD):
            return HostQD(*(e.detach().cpu().numpy() for e in obj))
        if isinstance(obj, dict):
            return {k: self.to_host(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [self.to_host(v) for v in obj]
        return obj

    def from_host(self, obj):
        if isinstance(obj, HostQD):
            return QD(*(torch.from_numpy(np.ascontiguousarray(e)).to(self.device) for e in obj))
        if isinstance(obj, dict):
            return {k: self.from_host(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [self.from_host(v) for v in obj]
        return obj

    def fixup_row(self, eng, rec):
        """Pad a remote acol with the missing rows when bond b-1 accepted
        this sweep after the owner evaluated it (corner fiber,
        dmrgg.f90:928-932)."""
        b = rec["b"]
        acol = rec["acol"]
        _, _, kk, qq = rec["ijkq"]
        r_cur = eng.r[b]                  # post-replay rank of bond b-1
        if acol.e0.shape[0] == r_cur:
            return acol
        rows = []
        for i in range(acol.e0.shape[0], r_cur):
            v = eng._eval([walk_index(eng.vip, b, eng.d, i, j, kk, qq) for j in range(eng.n[b])])
            rows.append(QD(*(e.reshape(1, eng.n[b]) for e in v)))
        return qd_concat([acol] + rows, axis=0)

    def fixup_col(self, eng, rec):
        """Pad a remote arow with the missing columns when bond b+1 accepted
        this sweep (the other boundary direction)."""
        b = rec["b"]
        arow = rec["arow"]
        ii, jj, _, _ = rec["ijkq"]
        r_cur = eng.r[b + 2]
        if arow.e0.shape[1] == r_cur:
            return arow
        cols = []
        for q in range(arow.e0.shape[1], r_cur):
            v = eng._eval([walk_index(eng.vip, b, eng.d, ii, jj, k, q)
                           for k in range(eng.n[b + 1])])
            cols.append(QD(*(e.reshape(eng.n[b + 1], 1) for e in v)))
        return qd_concat([arow] + cols, axis=1)

    def append_core_right(self, eng, b, arow):
        eng.G[b + 1] = qd_concat([eng.G[b + 1], _expand(arow, 0)], axis=0)

    def value_partial(self, eng, w, own_cores):
        v = None
        for c in sorted(own_cores):
            M = qd_vdot_axis(eng.G[c], qd_get(w[c], slice(0, eng.G[c].e0.shape[1])), 1)
            if c > 0:
                M = qd_matmul(eng.itl[c - 1], M)
            if c < eng.d - 1:
                M = qd_matmul(M, eng.itt[c])
            v = M if v is None else qd_matmul(v, M)
        return v

    def combine_parts(self, v, part):
        return part if v is None else qd_matmul(v, part)

    def value_scalar(self, v):
        return qd_get(v, (0, 0))

    def err(self, value, truth):
        return qd_err(value, truth)

    def fmt_err_val(self, rec):
        line = _sweep_line(rec, rec["n_evals"], rec["pivotmax_log10"], self.tag)
        return line[line.index(" err "):]

    def tt_value(self, cores, w):
        return qd_tt_value(cores, w)

    def make_result(self, cores, value, neval, sweeps, ranks, history):
        return QdCrossResult(cores=cores, value=value, neval=neval, sweeps=sweeps, ranks=ranks,
                             history=history)

    def worker_report(self, eng):
        """The worker's pivot chains, its kernel launches by shape and its
        host reads."""
        from ..ops.kernels import launch_shapes

        return {"vip": [list(b) for b in eng.vip], "shapes": launch_shapes(),
                "host_reads": eng.host_reads}


def cross_qd_parallel(
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
    n_workers: int = 2,
    mybonds=None,
    device: str | torch.device = "cuda",
    timeout: float = 600.0,
) -> QdCrossResult:
    """Bond-slab-distributed quad-double TT-cross: the ~62-digit tier's
    `mpirun -np N` path (mptt_dmrgg's MPI mode, dmrggmp.f90:518-629).  The
    contract of cross_qd plus n_workers / mybonds (as the JAX package's;
    n_workers <= d - 1, dmrgg.f90:114-117), ``device`` (every worker's and
    the parent's: the card unless the caller asks for ``device="cpu"``)
    and ``timeout`` (seconds any worker may take for one step).  The
    workers are spawned: fun_qd must pickle (a module-level callable such
    as apps.ising.make_ising_qd's).  The result's cores and value lie on
    `device` in the calling process."""
    lacc = accuracy_log10 if accuracy_log10 is not None else -QD_DPS + 4
    ad = _QdAdapter(small_element_log10, small_pivot_log10, device)
    return run_hub(ad, fun_qd, n, max_rank, pivoting, quad, truth, lacc, snum, seed, verbose,
                   n_workers, mybonds, name="cross_qd_parallel", timeout=timeout)
