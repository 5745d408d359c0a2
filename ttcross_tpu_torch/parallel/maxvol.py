"""Distributed alternating-maxvol refinement over the bond axis.

Counterpart of ttcross_tpu/parallel/maxvol.py: the pivot-replacement
engine (cross/maxvol.py) on the dimension-parallel model of the greedy
distributed cross (parallel/engine.py; the reference's mpirun path,
dmrgg.f90:120-131).  Each rank owns a contiguous slab of bonds and runs
the sequential maxvol bond visits over it; after each half-sweep the
per-bond index tables are merged with ONE all_reduce of the owner-masked
rows (the tables are int32, their rows disjoint: the sum is exact).

Within a slab the iteration is Gauss-Seidel (each visit sees the row set
the previous bond just selected, as the one-device sweep does); across
slab edges it is block-Jacobi: the first bond of a slab reads the
neighbouring slab's table of the previous merge.  Each exchange still
grows its own bond's cross volume, so the stationary points are the same
(1+tol)-dominant crosses; slab staleness changes only the path.

The cores come from a last pass over the frozen merged tables (emit_core:
the CUR-chain identity is exact for any frozen sets), each rank emitting
its own bonds' cores, merged once with an owner-masked all_reduce.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from ..cross.maxvol import _prepare_refine_sets, _refine_engine
from .engine import slab_bounds
from .mesh import bond_mesh, psum

__all__ = ["maxvol_refine_parallel"]


def maxvol_refine_parallel(fun, n: Sequence[int], ranks=None, init_sets=None, sweeps: int = 2,
                           quad=None, truth=None, key=0, n_exchange: int = 8, tol: float = 1.01,
                           max_rank: int | None = None, mesh=None, mybonds=None,
                           device: str | torch.device = "cuda",
                           dtype: torch.dtype = torch.float64):
    """Distributed maxvol_refine: the contract of cross.maxvol.maxvol_refine
    over the ranks of `mesh` (None: bond_mesh(device=device)), with
    optional slab boundaries mybonds (ndev+1,), the reference's mybonds
    argument.  Every rank calls it with the same arguments and returns the
    same result.  On one rank it walks the sequential iteration (the same
    index tables; its cores are the frozen-table emit pass's, equal to the
    sequential sweep's to solve rounding, at one more half-sweep of
    evaluations); on N ranks a half-sweep costs ceil((d-1)/N) bond visits
    of wall time."""
    from ..cross.engine import CrossResult
    from ..tt.ops import contract
    from ..tt.types import TT

    n = tuple(int(x) for x in n)
    d = len(n)
    if d < 2:
        raise ValueError("maxvol_refine_parallel requires d >= 2")
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    if mesh is None:
        mesh = bond_mesh(device=device)
    dev, me, ndev = mesh.device, mesh.rank, mesh.size
    nb, N = d - 1, max(n)
    own = slab_bounds(d, ndev, mybonds)
    own_lo, own_hi = int(own[me]), int(own[me + 1])
    t0 = time.perf_counter()

    LI, RJ, rr, R = _prepare_refine_sets(init_sets, ranks, n, d, max_rank, key)
    kit = _refine_engine(fun, n, R, n_exchange, tol, dev, dtype)
    LI, RJ = torch.from_numpy(LI).to(dev), torch.from_numpy(RJ).to(dev)
    rr_t = torch.from_numpy(rr).to(dev)
    ownm = ((torch.arange(nb, device=dev) >= own_lo)
            & (torch.arange(nb, device=dev) < own_hi))[:, None, None]
    neval = torch.zeros((), dtype=torch.int64, device=dev)
    padded = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(int(sweeps)):
        for b in range(own_lo, own_hi):
            LI, _, neval, padded = kit.visit_lr(b, LI, RJ, rr_t, neval, padded)
        LI = psum(mesh, torch.where(ownm, LI, 0))
        for b in range(own_hi - 1, own_lo - 1, -1):
            RJ, _, neval, padded = kit.visit_rl(b, LI, RJ, rr_t, neval, padded)
        RJ = psum(mesh, torch.where(ownm, RJ, 0))

    # the cores of this rank's bonds from the frozen merged tables; core 0
    # (A(grid_0, J_0), J_0 replicated) from the owner of bond 0
    cores = torch.zeros((d, R, N, R), dtype=dtype, device=dev)
    for b in range(own_lo, own_hi):
        cores[b + 1], neval, padded = kit.emit_core(b, LI, RJ, rr_t, neval, padded)
    if me == 0:
        cores[0, 0], neval, padded = kit.first_core(RJ, rr_t, neval, padded)
    c_idx = torch.arange(d, device=dev)
    auth = ((c_idx - 1 >= own_lo) & (c_idx - 1 < own_hi)) | ((c_idx == 0) & (me == 0))
    cores = psum(mesh, torch.where(auth[:, None, None, None], cores, 0.0))
    counts = psum(mesh, torch.stack([neval, padded])).tolist()
    rk = [1, *rr.tolist(), 1]
    tt = TT(tuple(cores[c, : rk[c], : n[c], : rk[c + 1]].clone() for c in range(d)))

    values, errors = [], []
    if quad is not None:
        val = float(contract(tt, list(quad)))
        values.append(val)
        if truth is not None:
            errors.append(abs(1.0 - val / truth))
    return CrossResult(
        tt=tt, neval=int(counts[0]), sweeps=int(sweeps), ranks=tuple(rk), values=values,
        errors=errors, time=time.perf_counter() - t0, converged=True, history=None,
        padded_evals=int(counts[1]))
