"""Randomized statistical accuracy verification of a cross result.

Counterpart of ttcross_tpu/cross/accchk.py (dtt_accchk, dmrgg.f90:1081-1166):
sample nlot random multi-indices, compare the black-box fun against the TT
interpolant, and report inf / Frobenius error norms plus the worst index.
One batched gather on the train's device; the norms come to the host once,
at the end.
"""

from __future__ import annotations

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
    ``device="cpu"``), and fun must take int32 index tensors there.
    mesh: sharding the samples over devices is not ported."""
    if mesh is not None:
        raise NotImplementedError("accchk(mesh=...) is not ported to ttcross_tpu_torch yet "
                                  "(ROADMAP queue 1 item 9)")
    dev = torch.device(device)
    if tt.device.type != dev.type:
        raise ValueError(f"the train lies on {tt.device}, not on {dev}")
    if ind is None:
        gen = torch.Generator(device="cpu").manual_seed(int(key))
        ind = torch.stack([torch.randint(0, tt.n[c], (nlot,), generator=gen)
                           for c in range(tt.d)], dim=1)
    elif not torch.is_tensor(ind):
        ind = torch.from_numpy(np.asarray(ind))
    ind = ind.to(dev, torch.int32)
    aval = fun(ind)
    err = (aval - gather(tt, ind)).abs()
    worst = torch.argmax(err).view(1)
    stats = torch.stack([err.max(), (err**2).sum().sqrt(), aval.abs().max(),
                         (aval**2).sum().sqrt()]).tolist()
    return {"einf": stats[0], "efro": stats[1], "ainf": stats[2], "afro": stats[3],
            "worst_index": tuple(ind.index_select(0, worst)[0].tolist())}
