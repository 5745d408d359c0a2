"""Host-side pivot-chain index walk of the host-indexed tiers.

A copy of ttcross_tpu/cross/hostwalk.py (:16-34): ``walk_index``
reconstructs the full d-dimensional multi-index of a candidate entry
``(i, j, k, q)`` at bond ``b`` by walking the vip pivot chains left and
right (the reference's ``dmrgg_fun`` / ``mp_dmrgg_fun``, dmrgg.f90:1053-1078
and dmrggmp.f90:706-718).  Pure Python, for the mp engine and the
distributed adapters' fiber fix-ups.  ``walk_indices`` walks whole arrays
of candidates at once, one gather per bond, for the qd engine
(cross/engine_qd.py): row t of its result is ``walk_index`` of entry t.
"""

from __future__ import annotations

import numpy as np

__all__ = ["walk_index", "walk_indices"]


def walk_index(vip, b, d, i, j, k, q):
    """Full multi-index for candidate (i, j, k, q) at bond b by walking the
    pivot chains (dmrgg_fun / mp_dmrgg_fun, dmrggmp.f90:706-718)."""
    ind = [0] * d
    t = i
    for s in range(b - 1, -1, -1):
        ind[s] = vip[s][t][1]
        t = vip[s][t][0]
    ind[b] = j
    ind[b + 1] = k
    t = q
    for s in range(b + 1, d - 1):
        ind[s + 1] = vip[s][t][2]
        t = vip[s][t][3]
    return ind


def walk_indices(vip, b, d, i, j, k, q) -> np.ndarray:
    """walk_index over arrays of candidates: i, j, k, q broadcast to one
    shape, and the (B, d) int64 multi-indices come back in its row-major
    order.  vip[s] is bond s's (r_s, 4) integer pivot array (only bonds
    other than b are read).  Each bond costs one gather over the chain
    positions it is walked from, so a fiber's fixed side is walked once."""
    i, j, k, q = (np.asarray(x, np.int64) for x in (i, j, k, q))
    out = np.empty(np.broadcast_shapes(i.shape, j.shape, k.shape, q.shape) + (d,), np.int64)
    t = i
    for s in range(b - 1, -1, -1):
        out[..., s] = vip[s][t, 1]
        t = vip[s][t, 0]
    out[..., b] = j
    out[..., b + 1] = k
    t = q
    for s in range(b + 1, d - 1):
        out[..., s + 1] = vip[s][t, 2]
        t = vip[s][t, 3]
    return out.reshape(-1, d)
