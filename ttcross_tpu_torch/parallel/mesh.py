"""Bond-slab distribution over the ranks of a torch.distributed group.

Counterpart of ttcross_tpu/parallel/mesh.py.  It maps the reference's MPI
work decomposition: `share(first, last, own)` (default.f90:80-97)
block-distributes the TT bonds over ranks with the constraint nproc < d
(dmrgg.f90:114-117).  The JAX package runs its ranks as the devices of a
one-axis 'bond' mesh inside one shard_map'd call; here a rank is a process,
as the reference's MPI rank is, and the exchanges are torch.distributed
collectives: NCCL between cards, gloo between CPU processes.

The collectives the distributed engines share live here, each the
counterpart of one jax.lax collective: psum (all_reduce SUM), all_gather,
gmax (all_reduce MAX) and shift, the stride-doubling exchange of ppermute
(batch_isend_irecv).  Nothing in them reads a value on the host.  The
backend is the group's: gloo carries all_reduce on CUDA tensors but not
all_gather nor point-to-point sends, so for gloo with a card (two ranks on
one card, where NCCL refuses) those two copy their payload to the host and
back, explicitly; their payloads are a few KB per sweep.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["BOND_AXIS", "BondMesh", "all_gather", "bond_mesh", "gmax", "psum", "share", "shift"]

BOND_AXIS = "bond"

# torch renamed all_gather_into_tensor to all_gather_single (the old name warns)
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def share(nbonds: int, ndev: int) -> np.ndarray:
    """own[k]..own[k+1]-1 = bonds of rank k; block distribution with the
    remainder spread over the first ranks (share, default.f90:80-97)."""
    if ndev > nbonds:
        raise ValueError(f"more devices ({ndev}) than bonds ({nbonds}); "
                         "the dimension-parallel engine needs ndev <= d-1")
    base, rem = divmod(nbonds, ndev)
    counts = np.full(ndev, base, dtype=np.int32)
    counts[:rem] += 1
    own = np.zeros(ndev + 1, dtype=np.int32)
    own[1:] = np.cumsum(counts)
    return own


@dataclass(frozen=True)
class BondMesh:
    """One rank's view of the 'bond' axis: the process group (None: the
    default one), this rank's index in it, the group's size, the device
    that holds this rank's state, and the group's backend."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def host_staged(self) -> bool:
        """gloo with CUDA tensors: all_gather and shift go through the host."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def peer(self, r: int) -> int:
        """The global rank of group rank r (for point-to-point sends)."""
        return r if self.group is None else dist.get_global_rank(self.group, r)


def bond_mesh(group=None, device=None) -> BondMesh:
    """The bond axis over the ranks of `group` (None: the default group),
    which must be initialized (torch.distributed.init_process_group): no
    one-rank world is made up.  device: this rank's state's device; the
    default, like a bare "cuda", is the card cuda:{LOCAL_RANK % cards}
    (LOCAL_RANK as torchrun sets it, else the rank), so the CPU must be
    asked for."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("bond_mesh needs an initialized torch.distributed process group "
                           "(torch.distributed.init_process_group, or torchrun)")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if device is None or str(device) == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local % cards) if cards else torch.device("cuda")
    return BondMesh(group=group, rank=rank, size=size, device=torch.device(device),
                    backend=str(dist.get_backend(group)))


def psum(mesh: BondMesh, x: torch.Tensor) -> torch.Tensor:
    """Sum of x over the ranks (lax.psum), as a new tensor.  Rows that one
    rank owns and the others leave zero sum exactly, in any order."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def gmax(mesh: BondMesh, x: torch.Tensor) -> torch.Tensor:
    """Elementwise maximum of x over the ranks, as a new tensor."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group)
    return out


def all_gather(mesh: BondMesh, x: torch.Tensor) -> torch.Tensor:
    """(size, *x.shape): every rank's x in rank order (lax.all_gather)."""
    src = x.reshape(-1).cpu() if mesh.host_staged else x.reshape(-1)
    out = src.new_empty((mesh.size * src.numel(),))    # the concatenated form: gloo's
    _all_gather_single(out, src, group=mesh.group)
    out = out.view((mesh.size,) + tuple(x.shape))
    return out.to(x.device) if mesh.host_staged else out


def shift(mesh: BondMesh, x: torch.Tensor, stride: int) -> torch.Tensor:
    """The x of rank (me + stride) mod size, this rank's x going to rank
    (me - stride) mod size (lax.ppermute with perm src -> src - stride: the
    stride-doubling fold's step)."""
    me, size = mesh.rank, mesh.size
    if size == 1 or stride % size == 0:
        return x.clone()
    src = x.contiguous().cpu() if mesh.host_staged else x.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, mesh.peer((me - stride) % size), group=mesh.group),
           dist.P2POp(dist.irecv, out, mesh.peer((me + stride) % size), group=mesh.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(x.device) if mesh.host_staged else out
