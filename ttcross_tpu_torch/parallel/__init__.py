"""The distributed engines of the port: one process per rank of a
torch.distributed group (NCCL between cards, gloo between CPU processes),
each rank owning a slab of the train's bonds, as the reference's MPI ranks
do (dmrgg.f90:120-131).  cross_parallel (parallel/engine.py),
cross_dd_parallel (engine_dd.py), maxvol_refine_parallel (maxvol.py) and
pcontract (quad.py) over parallel/mesh.py's bond axis; spawn_ranks
(launch.py) starts a local group from Python.  cross_qd_parallel
(engine_qd.py) distributes the qd tier over spawned worker processes
through the bond-slab hub (_hub.py); the mp tier's (cross_mp_parallel) is a
later slice of the port."""

from .engine import cross_parallel, get_parallel_engine, make_parallel_engine, rank_key
from .engine_dd import cross_dd_parallel, get_parallel_dd_engine, make_parallel_dd_engine
from .engine_qd import cross_qd_parallel
from .launch import spawn_ranks
from .maxvol import maxvol_refine_parallel
from .mesh import BOND_AXIS, BondMesh, bond_mesh, share
from .quad import pcontract

__all__ = ["BOND_AXIS", "BondMesh", "bond_mesh", "cross_dd_parallel", "cross_mp_parallel",
           "cross_parallel", "cross_qd_parallel", "get_parallel_dd_engine",
           "get_parallel_engine", "make_parallel_dd_engine", "make_parallel_engine",
           "maxvol_refine_parallel", "pcontract", "rank_key", "share", "spawn_ranks"]


def cross_mp_parallel(*args, **kwargs):
    """The distributed multiprecision tier: not ported yet."""
    raise NotImplementedError("cross_mp_parallel belongs to the mp tier, the mp part of ROADMAP "
                              "queue 1 item 8, which is not ported to ttcross_tpu_torch yet")
