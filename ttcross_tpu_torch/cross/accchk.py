"""Randomized statistical accuracy verification of a cross result.

Counterpart of ttcross_tpu/cross/accchk.py (dtt_accchk, dmrgg.f90:1081-1166):
sample nlot random multi-indices, compare the black-box fun against the TT
interpolant, and report inf / Frobenius error norms plus the worst index.
One batched gather on the train's device; the norms come to the host once,
at the end.  On a bond mesh the samples are sharded over the ranks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..tt.ops import gather
from ..tt.types import TT

__all__ = ["accchk"]


def accchk(tt: TT, fun, nlot: int = 2**16, key: int = 0, mesh=None, ind=None,
           device: str | torch.device = "cuda"):
    """Returns dict(einf, efro, ainf, afro, worst_index).

    The samples are drawn by a CPU torch.Generator seeded with key (the
    card and the CPU check the same indices), or given as ind (nlot, d).
    The train must lie on ``device`` (the card unless the caller asks for
    ``device="cpu"``; a mesh's device when a mesh is given), and fun must
    take int32 index tensors there.  mesh: a bond mesh
    (parallel/mesh.py::bond_mesh) whose every rank calls with the same
    arguments: the samples, padded up to a multiple of the ranks, are split
    into one contiguous shard per rank (the reference divides nlot over its
    MPI ranks, dmrgg.f90:1092-1096); the squared sums are summed over the
    ranks, the maxima maxed, and the worst sample found by an all_gather of
    each rank's worst, so every rank returns the single-device result (the
    sums to rounding)."""
    dev = torch.device(device) if mesh is None else mesh.device
    if tt.device.type != dev.type:
        raise ValueError(f"the train lies on {tt.device}, not on {dev}")
    if ind is None:
        if mesh is not None:
            nlot = -(-nlot // mesh.size) * mesh.size
        gen = torch.Generator(device="cpu").manual_seed(int(key))
        ind = torch.stack([torch.randint(0, tt.n[c], (nlot,), generator=gen)
                           for c in range(tt.d)], dim=1)
    elif not torch.is_tensor(ind):
        ind = torch.from_numpy(np.asarray(ind))
    if mesh is not None:
        shard = -(-ind.shape[0] // mesh.size)
        ind = ind[mesh.rank * shard:(mesh.rank + 1) * shard]
    ind = ind.to(dev, torch.int32)
    aval = fun(ind)
    err = (aval - gather(tt, ind)).abs()
    worst = torch.argmax(err).view(1)
    stats = torch.stack([err.max(), (err**2).sum(), aval.abs().max(), (aval**2).sum()])
    worst_row = ind.index_select(0, worst)[0]
    if mesh is not None:
        from ..parallel.mesh import all_gather, gmax, psum

        stats = torch.stack([gmax(mesh, stats[0]), psum(mesh, stats[1]), gmax(mesh, stats[2]),
                             psum(mesh, stats[3])])
        # each rank's worst error and its index: the first maximum over the
        # ranks in order is the single-device argmax
        cand = all_gather(mesh, torch.cat([err.index_select(0, worst),
                                           worst_row.to(err.dtype)]))
        worst_row = cand[torch.argmax(cand[:, 0]), 1:].round().to(torch.int64)
    stats = stats.tolist()
    return {"einf": stats[0], "efro": math.sqrt(stats[1]), "ainf": stats[2],
            "afro": math.sqrt(stats[3]), "worst_index": tuple(worst_row.tolist())}
