"""The distributed engines of the port: one process per rank of a
torch.distributed group (NCCL between cards, gloo between CPU processes),
each rank owning a slab of the train's bonds, as the reference's MPI ranks
do (dmrgg.f90:120-131).  cross_parallel (parallel/engine.py),
cross_dd_parallel (engine_dd.py), maxvol_refine_parallel (maxvol.py) and
pcontract (quad.py) over parallel/mesh.py's bond axis; spawn_ranks
(launch.py) starts a local group from Python.  cross_qd_parallel
(engine_qd.py) distributes the qd tier over spawned worker processes
through the bond-slab hub (_hub.py), and cross_mp_parallel (engine_mp.py)
the mp tier, host code, over the same hub."""

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



def __getattr__(name):
    # the mp tier imports mpmath at module scope: exported on first access,
    # so that importing this package does not need mpmath
    if name == "cross_mp_parallel":
        from .engine_mp import cross_mp_parallel

        globals()[name] = cross_mp_parallel
        return cross_mp_parallel
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
