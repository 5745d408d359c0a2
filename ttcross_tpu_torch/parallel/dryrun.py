"""Multi-rank dry run of every distributed mode on tiny shapes.

The counterpart of __graft_entry__.py:31 dryrun_multichip, whose record is
MULTICHIP_r05.json (8 devices, every mode OK).  The JAX function runs its
modes on an n-device mesh inside one process; here a mesh rank is a
process (parallel/mesh.py), so the dry run spawns n_ranks ranks of one
torch.distributed group (parallel/launch.py::spawn_ranks) and each runs,
on d = n_ranks + 1 modes (one bond per rank) of size 5 with uniform
weights:

  * cross_parallel of a random rank-2 train (default_rng(0)) sequential,
    with sweep_mode="jacobi" and with refine_sweeps=1, each held to the
    dense train (tt.full) at err < 1e-8;
  * sweep_mode="jacobi-rb" with a product ChainSpec (the interface-state
    hunt) on the product of node values, held to its dense tensor;
  * the lane-sharded cross_batch(mesh=): n_ranks lanes of perturbed
    copies of the train, one lane block per rank, worst err < 1e-8.

It prints the JAX function's three lines, with ranks, errors and neval.
The ranks join over gloo by default, so several share one card (NCCL
refuses two ranks on one GPU); backend="nccl" puts rank r on card r.  The
CUDA kernels are built before the ranks are spawned, so the ranks only
load them.  Kernel A scores every rook pass (batched on the all-bonds
sweeps and over the lanes); the chain's lift and the product integrand's
node lookup are kernel B.
"""

from __future__ import annotations

__all__ = ["dryrun_multichip"]

N_MODE = 5
ERR_MAX = 1e-8


def _rank_dryrun(n_ranks: int, device: str) -> dict:
    """One rank's work: every mode's error, ranks and evaluations, and this
    rank's kernel launches by shape (ops/kernels.py::launch_shapes)."""
    import functools

    import numpy as np
    import torch

    from ..cross import cross_batch
    from ..cross.chain_eval import ChainSpec
    from ..ops import kernels as K
    from ..ops.dense import table_lookup
    from ..tt.ops import full, gather
    from ..tt.types import TT
    from .engine import cross_parallel
    from .mesh import bond_mesh

    mesh = bond_mesh(device=None if device == "cuda" else device)
    dev = mesh.device
    K.reset_launch_counts()
    d, n = n_ranks + 1, N_MODE
    rng = np.random.default_rng(0)
    ranks = (1,) + (2,) * (d - 1) + (1,)
    cores = [rng.standard_normal((ranks[i], n, ranks[i + 1])) for i in range(d)]
    T = TT(tuple(torch.from_numpy(c).to(dev) for c in cores))
    dense = full(T)
    w = [np.full(n, 1.0 / n) for _ in range(d)]
    kw = dict(max_rank=3, pivoting=1, quad=w, mesh=mesh, device=dev)

    def err_of(t, want):
        return float((full(t) - want).abs().max())

    out = {}
    for mode, extra in (("sequential", {}), ("jacobi", dict(sweep_mode="jacobi")),
                        ("maxvol-refine", dict(refine_sweeps=1))):
        res = cross_parallel(lambda ind: gather(T, ind), [n] * d, accuracy=1e-10, **kw, **extra)
        out[mode] = dict(err=err_of(res.tt, dense), ranks=tuple(res.ranks), neval=res.neval)

    # red-black all-bonds sweeps with a chain-structured integrand: the
    # product of node values, whose monoid state is the running product
    nodes = np.exp(rng.standard_normal(n) * 0.1)
    table = torch.from_numpy(nodes).to(dev)

    def lift(dims, idx):
        del dims
        ind = idx.to(torch.int32).contiguous()
        ind = ind.reshape(1, -1) if ind.dim() < 2 else ind.reshape(-1, ind.shape[-1])
        return dict(P=table_lookup(table, ind).reshape(idx.shape))

    spec = ChainSpec(lambda: dict(P=1.0), lift, lambda a, b: dict(P=a["P"] * b["P"]),
                     lambda s: s["P"])

    def fun_prod(ind):
        return table_lookup(table, ind).prod(dim=1)

    res = cross_parallel(fun_prod, [n] * d, accuracy=1e-12, sweep_mode="jacobi-rb", chain=spec,
                         **kw)
    dense_prod = functools.reduce(np.multiply.outer, [nodes] * d)     # on the host: no launch
    out["rb-chain"] = dict(err=err_of(res.tt, torch.from_numpy(dense_prod).to(dev)),
                           ranks=tuple(res.ranks), neval=res.neval)

    # the lane-sharded family: one block of lanes per rank, no collective
    # but the gather of the results
    lane_cores = [np.stack([c + 0.01 * k for k in range(n_ranks)]) for c in cores]
    resb = cross_batch(lambda ind, par: gather(TT(tuple(par)), ind), [n] * d, lane_cores,
                       max_rank=3, pivoting=1, accuracy=1e-10, quad=w, mesh=mesh, device=dev)
    errs = [err_of(resb[lane].tt, full(TT(tuple(torch.from_numpy(c[lane]).to(dev)
                                                 for c in lane_cores))))
            for lane in range(n_ranks)]
    out["lanes"] = dict(errs=errs, neval=resb.neval)
    out["launch_shapes"] = K.launch_shapes()
    out["device"] = str(dev)
    return out


def dryrun_multichip(n_ranks: int, backend: str = "gloo", device: str = "cuda",
                     timeout: float = 600.0) -> list:
    """Every distributed mode on n_ranks spawned ranks (see the module's
    docstring); prints the three lines of __graft_entry__.dryrun_multichip
    and raises AssertionError if any mode's error reaches 1e-8.  device:
    "cuda" (the default: each rank's card, bond_mesh's default) or "cpu".
    Returns every rank's result: per mode its error, ranks and evaluations,
    and the rank's kernel launches by shape."""
    from .launch import spawn_ranks

    if device != "cpu":
        from ..ops import _build

        _build.build()      # the ranks load the library, none builds it
    outs = spawn_ranks(_rank_dryrun, n_ranks, args=(n_ranks, device), backend=backend,
                       timeout=timeout)
    r0 = outs[0]
    seq = r0["sequential"]
    for mode in ("sequential", "jacobi", "maxvol-refine", "rb-chain"):
        for r, o in enumerate(outs):
            if not o[mode]["err"] < ERR_MAX:
                raise AssertionError(f"{mode} dry run inaccurate on rank {r}: {o[mode]}")
    print(f"dryrun_multichip({n_ranks}): OK  ranks={seq['ranks']} err={seq['err']:.2e} "
          f"neval={seq['neval']}")
    print(f"dryrun_multichip({n_ranks}): jacobi err={r0['jacobi']['err']:.2e}, "
          f"maxvol-refine err={r0['maxvol-refine']['err']:.2e}, "
          f"rb-chain err={r0['rb-chain']['err']:.2e} — all distributed modes OK")
    worst = max(max(o["lanes"]["errs"]) for o in outs)
    if not worst < ERR_MAX:
        raise AssertionError(f"lane-mesh batch dry run inaccurate: {worst}")
    print(f"dryrun_multichip({n_ranks}): lane-sharded cross_batch ({n_ranks} lanes) "
          f"worst err={worst:.2e} — OK")
    return outs
