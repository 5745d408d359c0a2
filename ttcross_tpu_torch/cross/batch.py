"""Batched parameterized cross: a family of TT-cross runs, one per
parameter lane, through the sequential engine at once.

Counterpart of ttcross_tpu/cross/batch.py.  The reference threads an
opaque parameter block ``par`` into every integrand call (``fun(m, ind, n,
par)``, dmrgg.f90:18); a family of integrals (MVN masses across
correlations, option prices across strikes) is then one run per value.
The JAX package vmaps its whole fused engine over a lane axis of the
parameters.  Eager PyTorch has no such transform of an engine that writes
its state in place and launches hand kernels through ctypes, so here the
engine itself carries the lane axis (cross/engine.py::make_engine with
lanes = L): every hunt, accept and value is one batched op over the lanes,
kernel A scores every lane's fiber in one launch
(score_residual_argmax_batched), and the integrand evaluates every lane in
one call.

Semantics, as the JAX package's: every lane is the single cross() run with
that lane's parameters and its own lottery stream; a lane that meets its
strike-3 stop is frozen (vmap of lax.while_loop selects a finished lane's
old carry) while the others sweep on, and the run ends when every lane is
done or at max_sweeps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..config import precision_thresholds
from ..ops.dense import as_tensor
from ..ops.kernels import lane_seeds, lane_uniforms, lane_uniforms_plain
from ..tt.types import TT
from ..utils.metrics import history_from_run, span
from .engine import (CrossConfig, CrossResult, _values_errors, make_engine, quad_matrix,
                     run_sweeps)

__all__ = ["BatchCrossResult", "cross_batch", "lane_batched", "lane_key"]


@dataclass
class BatchCrossResult:
    """One CrossResult per parameter lane; neval and time are the
    family's totals (the lanes share every call, so each lane's
    CrossResult carries the family's wall time).  A lane's ``state`` is
    the pivot shim of cross(return_pivots=True), vip and rk as host numpy:
    cross/skeleton.py::extract_skeleton takes a lane."""

    lanes: list[CrossResult]
    neval: int            # integrand evaluations of the whole family
    time: float           # wall time of the one batched run
    sweeps: int           # the most sweeps any lane made

    def __len__(self):
        return len(self.lanes)

    def __getitem__(self, i):
        return self.lanes[i]

    def __iter__(self):
        return iter(self.lanes)


def lane_batched(fun: Callable) -> Callable:
    """Mark ``fun(ind, par)`` as lane-batched: called with ind (L, B, d) and
    the whole params (every leaf with its lane axis) it returns (L, B), all
    lanes in one call (apps/mvn.py::MvnFamily.fun: one mvn_pdf_fused launch
    for every lane).  cross_batch calls a marked integrand once per
    integrand step and vmaps an unmarked one."""
    fun.lane_batched = True
    return fun


def lane_key(key: int, lane: int) -> int:
    """The lottery seed of lane ``lane`` in cross_batch(key=key): the lane
    draws the uniforms that cross(key=lane_key(key, lane)) draws.  The JAX
    package splits its PRNG key (jax.random.split(key, L)[lane]); the
    port's streams are torch.Generator seeds, so a lane's seed is this
    fixed mix of (key, lane), 63 bits of numpy's SeedSequence."""
    state = np.random.SeedSequence([int(key), int(lane)]).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def _lane_fun(fun: Callable, params) -> Callable:
    """ind (L, B, d) -> (L, B): fun once for all lanes if it is
    lane-batched, else torch.func.vmap of fun over the lanes of ind and
    params.  A hand kernel under vmap raises a TypeError that asks for a
    lane-batched integrand (ops/kernels.py); nothing loops over lanes."""
    if getattr(fun, "lane_batched", False):
        return lambda ind: fun(ind, params)
    vfun = torch.func.vmap(fun, in_dims=(0, 0))
    return lambda ind: vfun(ind, params)


def cross_batch(
    fun: Callable,
    n: Sequence[int],
    params,
    max_rank: int = 20,
    accuracy: float | None = None,
    pivoting: int = 1,
    quad: Sequence | None = None,
    truth=None,
    key: int = 0,
    dtype: torch.dtype = torch.float64,
    verbose: bool = False,
    max_sweeps: int | None = None,
    small_element: float | None = None,
    small_pivot: float | None = None,
    sweep_mode: str = "sequential",
    use_pallas: bool = False,
    mesh=None,
    device: str | torch.device = "cuda",
) -> BatchCrossResult:
    """Cross-interpolate a family of black-box tensors at once, one lane
    per parameter value; the signature of ttcross_tpu.cross.cross_batch
    plus ``device`` (the card unless the caller asks for ``device="cpu"``).

    fun: ``fun(ind (B, d) int32, par) -> (B,)`` with ``par`` one lane's
    slice of params, torch.func.vmap-able over both; or a lane_batched
    integrand, which takes ind (L, B, d) and the whole params and returns
    (L, B).  params: a pytree of tensors or arrays, every leaf with a
    leading lane axis of size L (arrays go to ``device``).  key: lane l
    draws the lottery uniforms of cross(key=lane_key(key, l)), bit for bit
    (on a CUDA device every lane's in one kernel, ops/kernels.py::
    lane_uniforms).  truth: a
    scalar or one value per lane.  Other arguments as cross(), shared by
    the lanes.  The post-passes of single runs (oversample, refine_sweeps,
    state passing) are per-lane concepts: run cross() on a lane for them.
    use_pallas is accepted for API parity.  sweep_mode: "sequential", or
    "jacobi", every (bond, lane) pair hunting at once in one batch
    (cross/engine_jacobi.py); a lane is its single cross(sweep_mode=
    "jacobi") run either way.  mesh: a bond mesh (parallel/mesh.py::
    bond_mesh) whose every rank calls with the same arguments: the lanes
    are sharded over the ranks (L divisible by their number), each rank
    runs its block of lanes with no collective, and the results are
    gathered, so every rank returns all L lanes; the mesh's device is the
    run's."""
    return _cross_batch(fun, n, params, max_rank=max_rank, accuracy=accuracy,
                        pivoting=pivoting, quad=quad, truth=truth, key=key, dtype=dtype,
                        verbose=verbose, max_sweeps=max_sweeps, small_element=small_element,
                        small_pivot=small_pivot, sweep_mode=sweep_mode, mesh=mesh,
                        device=device)


def _cross_batch(fun, n, params, *, sweep_mode, **kw):
    """_run_cross_batch() as one `cross_batch` span, which it gives its lane count."""
    with span("cross_batch", d=len(n), sweep_mode=sweep_mode) as root:
        return _run_cross_batch(root, fun, n, params, sweep_mode=sweep_mode, **kw)


def _run_cross_batch(root, fun, n, params, *, max_rank, accuracy, pivoting, quad, truth, key,
                     dtype, verbose, max_sweeps, small_element, small_pivot, sweep_mode, mesh,
                     device, uniforms=None):
    """cross_batch() with one more input: uniforms, (max_sweeps, L, d-1, 2,
    NLOT) lottery uniforms of every lane in place of the lane keys' draws;
    the tests feed the JAX lanes' draws through it."""
    n = tuple(int(x) for x in n)
    d = len(n)
    if d < 2:
        raise ValueError("cross_batch requires d >= 2")
    if max_rank < 2:
        raise ValueError("max_rank must be >= 2")
    if sweep_mode not in ("sequential", "jacobi"):
        raise ValueError(f"unknown sweep_mode {sweep_mode!r}")
    if sweep_mode == "jacobi" and int(pivoting) < 0:
        raise ValueError("sweep_mode='jacobi' requires pivoting >= 0")
    leaves = pytree.tree_leaves(params)
    if not leaves:
        raise ValueError("params must contain at least one array leaf")
    if any(np.ndim(leaf) == 0 for leaf in leaves):
        raise ValueError("every params leaf needs a leading lane axis; got a 0-d leaf "
                         "(broadcast shared values to (L, ...) or close over them in fun)")
    L = int(np.shape(leaves[0])[0])
    root.set(lanes=L)
    for leaf in leaves:
        if int(np.shape(leaf)[0]) != L:
            raise ValueError("every params leaf needs the same leading lane-axis size; "
                             f"got {np.shape(leaf)[0]} vs {L}")
    if mesh is not None and L % mesh.size:
        raise ValueError(f"lane count {L} must be divisible by the mesh's {mesh.size} devices")
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"dtype must be torch.float64 or torch.float32, got {dtype}")
    if truth is None:
        truths = [None] * L
    elif np.ndim(truth) == 0:
        truths = [float(truth)] * L
    else:
        truths = [float(x) for x in truth]
        if len(truths) != L:
            raise ValueError(f"truth must be scalar or length {L}")

    dev = torch.device(device) if mesh is None else mesh.device
    L_all, lane0 = L, 0
    if mesh is not None:
        # this rank's block of lanes
        L = L_all // mesh.size
        lane0 = mesh.rank * L
        params = pytree.tree_map(lambda a: a[lane0:lane0 + L], params)
    params = pytree.tree_map(lambda a: as_tensor(a, dev), params)
    se, sp = precision_thresholds(dtype)
    if small_element is not None:
        se = float(small_element)
    if small_pivot is not None:
        sp = float(small_pivot)
    cfg = CrossConfig(d=d, n=n, N=max(n), R=max_rank, piv=int(pivoting),
                      small_element=se, small_pivot=sp, jacobi=sweep_mode == "jacobi")
    kit = make_engine(_lane_fun(fun, params), cfg, dev, dtype, lanes=L)
    if max_sweeps is None:
        max_sweeps = max_rank - 1
    NLOT = 2 * (cfg.R + cfg.N)
    lanes = range(lane0, lane0 + L)
    with span("entry.uniforms") as drawing:
        if uniforms is None and dev.type == "cuda":
            # every lane's stream in one kernel
            drawing.set(drawn="card")
            seeds = lane_seeds([lane_key(key, i) for i in lanes])
            with span("entry.upload", bytes=seeds.nbytes):
                seeds = seeds.to(dev)
            uniforms = lane_uniforms(seeds, max_sweeps, d, NLOT, dev)
        else:
            drawing.set(drawn="host")
            if uniforms is None:
                uniforms = lane_uniforms_plain([lane_key(key, i) for i in lanes], max_sweeps, d,
                                               NLOT)
            elif mesh is not None:
                uniforms = uniforms[:, lane0:lane0 + L]
            uniforms = torch.as_tensor(uniforms, dtype=torch.float64)
            with span("entry.upload", bytes=uniforms.nbytes):
                uniforms = uniforms.to(dev)
    if uniforms.shape[0] < max_sweeps or uniforms.shape[1:] != (L, d - 1, 2, NLOT):
        raise ValueError(f"uniforms must be ({max_sweeps}, {L}, {d - 1}, 2, {NLOT}), "
                         f"got {tuple(uniforms.shape)}")

    t0 = time.perf_counter()
    with_quad = quad is not None
    w = quad_matrix(quad, n, cfg.N, dev, dtype) if with_quad else None
    with span("engine.init"):
        st = kit.init_fn()
    st, _, last, vals, pmax, nev, _ = run_sweeps(kit, st, uniforms, w, accuracy=accuracy,
                                                 max_sweeps=max_sweeps)
    with span("entry.results", lanes=L_all):
        solved = kit.finalize_fn(st)
        if mesh is not None:
            # every rank's lanes, in lane order, to every rank
            solved, st = _gather_lanes(mesh, solved, 1), st._replace(
                **{f: _gather_lanes(mesh, getattr(st, f), 1) for f in ("rk", "vip")},
                **{f: _gather_lanes(mesh, getattr(st, f), 0) for f in ("neval", "padded")})
            last, vals, pmax, nev = (_gather_lanes(mesh, torch.from_numpy(a).to(dev), a.ndim - 1)
                                     .cpu().numpy() for a in (last, vals, pmax, nev))
        rk, vip, neval, padded = (t.cpu().numpy() for t in (st.rk, st.vip, st.neval, st.padded))
        wall = time.perf_counter() - t0

        lanes = []
        for i in range(L_all):
            last_it = int(last[i])
            values, errors = _values_errors(vals[:, i], last_it, truths[i], with_quad)
            r = rk[:, i]
            lanes.append(CrossResult(
                tt=TT(tuple(solved[c, i, : r[c], : n[c], : r[c + 1]].clone() for c in range(d))),
                neval=int(neval[i]), sweeps=last_it, ranks=tuple(int(x) for x in r),
                values=values, errors=errors, time=wall,
                converged=accuracy is not None and last_it < max_sweeps,
                history=history_from_run(last_it, vals[:, i], pmax[:, i], nev[:, i], truths[i],
                                         with_quad),
                state=SimpleNamespace(vip=vip[:, i], rk=r), padded_evals=int(padded[i])))
            if verbose:
                tail = f" err {errors[-1]:9.3e}" if errors else ""
                tail += f" val {values[-1]:.14e}" if values else ""
                print(f"lane {i:3d}: sweeps {last_it:3d} ranks {lanes[-1].ranks} "
                      f"n_evals {lanes[-1].neval:9d}{tail}")
    return BatchCrossResult(lanes=lanes, neval=sum(r.neval for r in lanes), time=wall,
                            sweeps=max(r.sweeps for r in lanes))


def _gather_lanes(mesh, x: torch.Tensor, axis: int) -> torch.Tensor:
    """Every rank's block of lanes of x (its lane axis `axis`) joined in
    rank order: the all_gather of the sharded family's results."""
    from ..parallel.mesh import all_gather

    g = all_gather(mesh, x.contiguous())                  # (ranks, ...)
    return torch.cat(g.unbind(0), dim=axis)
