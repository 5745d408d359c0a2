"""Host-side pivot-chain index walk of the host-indexed tiers.

A copy of ttcross_tpu/cross/hostwalk.py (:16-34): ``walk_index``
reconstructs the full d-dimensional multi-index of a candidate entry
``(i, j, k, q)`` at bond ``b`` by walking the vip pivot chains left and
right (the reference's ``dmrgg_fun`` / ``mp_dmrgg_fun``, dmrgg.f90:1053-1078
and dmrggmp.f90:706-718).  Pure Python, for the qd engine
(cross/engine_qd.py) and its distributed adapter.
"""

from __future__ import annotations

__all__ = ["walk_index"]


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
