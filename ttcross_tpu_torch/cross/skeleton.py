"""Frozen-skeleton re-evaluation: parameter sensitivities (Greeks) of a
cross integral with torch.autograd / torch.func, and the host rebuild of
cross(host_reeval=...).

Counterpart of ttcross_tpu/cross/skeleton.py.  A finished cross is frozen
into its skeleton: the per-bond pivot index sets I_b, J_b decoded from the
vip chains (cross/chains.py::pivot_index_sets).  At any parameter value
theta the interpolant's data are one batched integrand call on the
skeleton's indices, the raw fibers G_c(theta) = A_theta(I_{c-1}, i_c, J_c)
and the pivot submatrices Ahat_b(theta) = A_theta(I_b, J_b), and

    val(theta) = prod_c [ G_c(theta) . w_c ] Ahat_c(theta)^{-1}

with differentiable solves.  torch.func.grad of val is the exact derivative
of the interpolant, and torch.func.vmap sweeps a parameter family at the
fixed skeleton.

What differs from the JAX module, on purpose:
* the right solve m @ Ahat^{-1} is torch.linalg.solve on the transposed
  system; its autograd rule is the solve rule that the JAX module writes
  out by hand as a custom JVP (its QR-based solve exists because f64
  jnp.linalg.solve does not lower on the TPU);
* derive_host_fun evaluates the integrand where its tensors live, not on
  a CPU backend: the JAX module re-runs its traced integrand there because
  the TPU's f64 multiply is emulated (~7e-15 relative error per value),
  while the H100's f64 is IEEE.

Integrand protocol (as cross_batch's): ``fun(ind (B, d) int32, params) ->
(B,)`` with params any pytree of tensors.  The integrand's hand kernels run
under torch.func.grad and under torch.func.vmap over params as long as
their own inputs do not depend on params (the skeleton's indices and the
node tables never do); a kernel launch on a batched tensor raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops.dense import as_tensor
from ..tt.types import TT
from .chains import pivot_index_sets

__all__ = ["Skeleton", "extract_skeleton", "skeleton_value_fn", "skeleton_tt_fn",
           "reevaluate_host", "derive_host_fun"]


def derive_host_fun(fun: Callable, device: str | torch.device = "cuda") -> Callable:
    """The ``fun_np`` protocol of reevaluate_host for an integrand on tensors:
    ``fun_np(ind (B, d) int numpy) -> (B,) f64 numpy``, evaluating ``fun``
    on int32 indices placed on ``device`` (the card unless the caller asks
    for the CPU).

    The JAX package re-runs the traced integrand on its CPU x64 backend,
    because the TPU's emulated f64 multiply is not correctly rounded.  The
    H100's f64 is IEEE, so the integrand runs where its tensors live, as it
    is: for the Ising problem on the card that is one launch of the fused
    integrand at the skeleton's batch, not a host copy of it."""

    def fun_np(ind):
        t = as_tensor(np.asarray(ind, np.int32), device)
        return fun(t).to(torch.float64).cpu().numpy()

    return fun_np


@dataclass(frozen=True)
class Skeleton:
    """Frozen cross skeleton: every multi-index the interpolant samples.

    ind_all stacks the d core-fiber blocks, then the d-1 pivot-submatrix
    blocks; core_shapes and ahat_shapes record how to split and reshape
    the one batched integrand result.  ``ind`` is ind_all as an int32
    tensor on ``device``, made at its first use."""

    ind_all: np.ndarray                              # (B_total, d) int32
    core_shapes: tuple[tuple[int, int, int], ...]    # (r_l, n_c, r_r) per core
    ahat_shapes: tuple[int, ...]                     # r per bond
    n: tuple[int, ...]
    ranks: tuple[int, ...]                           # bond ranks, length d+1
    device: str | torch.device = "cuda"

    @property
    def d(self) -> int:
        return len(self.n)

    @property
    def n_samples(self) -> int:
        return int(self.ind_all.shape[0])

    @functools.cached_property
    def ind(self) -> torch.Tensor:
        return torch.from_numpy(self.ind_all).to(self.device)


def extract_skeleton(state_or_result, n: Sequence[int],
                     device: str | torch.device = "cuda") -> Skeleton:
    """Decode a finished cross into a Skeleton.

    state_or_result: a CrossResult of ``cross(..., return_state=True)`` or
    ``return_pivots=True`` (its ``.state`` is used), a CrossState, or the
    light vip / rk shim.  n: per-mode sizes.  device: where the skeleton's
    index tensor goes (the card unless the caller asks for the CPU)."""
    state = getattr(state_or_result, "state", None) or state_or_result
    if getattr(state, "vip", None) is None:
        raise ValueError("extract_skeleton needs the engine state: run "
                         "cross(..., return_state=True) or pass a CrossState")
    n = tuple(int(x) for x in n)
    d = len(n)
    rk = state.rk.cpu().numpy() if torch.is_tensor(state.rk) else np.asarray(state.rk)
    I, J = pivot_index_sets(state.vip, rk)

    blocks, core_shapes = [], []
    for c in range(d):
        rl, rr = int(rk[c]), int(rk[c + 1])
        pre = np.asarray(I[c - 1] if c > 0 else [()], np.int32).reshape(rl, c)
        suf = np.asarray(J[c] if c < d - 1 else [()], np.int32).reshape(rr, d - c - 1)
        ind = np.empty((rl, n[c], rr, d), np.int32)
        ind[..., :c] = pre[:, None, None, :]
        ind[..., c] = np.arange(n[c], dtype=np.int32)[None, :, None]
        ind[..., c + 1:] = suf[None, None, :, :]
        blocks.append(ind.reshape(-1, d))
        core_shapes.append((rl, n[c], rr))
    ahat_shapes = []
    for b in range(d - 1):
        r = int(rk[b + 1])
        pre = np.asarray(I[b], np.int32).reshape(r, b + 1)
        suf = np.asarray(J[b], np.int32).reshape(r, d - b - 1)
        ind = np.empty((r, r, d), np.int32)
        ind[..., :b + 1] = pre[:, None, :]
        ind[..., b + 1:] = suf[None, :, :]
        blocks.append(ind.reshape(-1, d))
        ahat_shapes.append(r)
    return Skeleton(ind_all=np.concatenate(blocks, axis=0), core_shapes=tuple(core_shapes),
                    ahat_shapes=tuple(ahat_shapes), n=n, ranks=tuple(int(x) for x in rk),
                    device=device)


def _solve_right(ahat, m):
    """m @ ahat^{-1}, as a solve of the transposed system; autograd
    differentiates it by the solve rule dy = (dm - y dA) A^{-1}."""
    return torch.linalg.solve(ahat.mT, m.mT).mT


def _split_samples(skel: Skeleton, vals):
    """Split the one batched integrand result back into the cores G_c and
    the pivot submatrices Ahat_b (numpy or tensors)."""
    cores, ahats, off = [], [], 0
    for (rl, nc, rr) in skel.core_shapes:
        cores.append(vals[off:off + rl * nc * rr].reshape(rl, nc, rr))
        off += rl * nc * rr
    for r in skel.ahat_shapes:
        ahats.append(vals[off:off + r * r].reshape(r, r))
        off += r * r
    return cores, ahats


def skeleton_value_fn(fun: Callable, skel: Skeleton,
                      weights: Sequence | None = None) -> Callable:
    """``vfn(params) -> 0-d tensor``: the quadrature value of the
    frozen-skeleton interpolant at parameter value ``params``.

    fun: ``fun(ind (B, d) int32, params) -> (B,)`` on the skeleton's
    device.  weights: per-mode quadrature weight vectors (None sums every
    entry, dtt_quad's no-quad semantics).  vfn is differentiable in params
    (torch.autograd, torch.func.grad) and vmaps over a leading axis of
    params (torch.func.vmap).  A plain f64 chain product."""
    dev = skel.ind.device
    if weights is None:
        w_list = [torch.ones((nc,), dtype=torch.float64, device=dev) for nc in skel.n]
    else:
        w_list = [as_tensor(w, dev) for w in weights]

    def vfn(params):
        cores, ahats = _split_samples(skel, fun(skel.ind, params))
        row = None
        for c in range(skel.d):
            gw = torch.einsum("anb,n->ab", cores[c], w_list[c].to(cores[c].dtype))
            row = gw if row is None else row @ gw
            if c < skel.d - 1:
                row = _solve_right(ahats[c], row)
        return row[0, 0]

    return vfn


def reevaluate_host(fun_np: Callable, skel: Skeleton) -> list:
    """Host rebuild of the CUR interpolant at a frozen skeleton: numpy
    cores (r_l, n_c, r_r) with the pivot-submatrix inverses folded in on
    the right.  fun_np: ``fun_np(ind (B, d) int numpy) -> (B,) f64
    numpy``, e.g. ``IsingProblem.fun_np`` or derive_host_fun(prob.fun)."""
    vals = np.asarray(fun_np(skel.ind_all.astype(np.int64)), np.float64)
    cores, ahats = _split_samples(skel, vals)
    out = []
    for c, g in enumerate(cores):
        if c < len(ahats):
            rl, nc, rr = g.shape
            g = np.linalg.solve(ahats[c].T, g.reshape(-1, rr).T).T.reshape(rl, nc, rr)
        out.append(g)
    return out


def skeleton_tt_fn(fun: Callable, skel: Skeleton) -> Callable:
    """``tfn(params) -> TT``: the frozen-skeleton CUR interpolant as a
    train at parameter value ``params``, the pivot-submatrix inverses
    folded into the cores on the right (the dtt_lua convention,
    dmrgg.f90:1169-1258).  Differentiable in params, so Greeks of derived
    quantities (tt.contract, apps.chf's pair forms) flow through."""

    def tfn(params):
        cores, ahats = _split_samples(skel, fun(skel.ind, params))
        out = []
        for c, g in enumerate(cores):
            if c < skel.d - 1:
                rl, nc, rr = g.shape
                g = _solve_right(ahats[c], g.reshape(-1, rr)).reshape(rl, nc, rr)
            out.append(g)
        return TT(tuple(out))

    return tfn
