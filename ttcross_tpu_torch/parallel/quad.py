"""Distributed TT contraction over the bond axis: dtt_quad / ztt_quad
(dmrgg.f90:1261-1523).

Counterpart of ttcross_tpu/parallel/quad.py.  The reference contracts each
rank's owned cores against the weights and folds the (r, r) partials with a
binary-tree pairwise GEMM reduce over MPI (stride-doubling sendrecv,
dmrgg.f90:1356-1405); ztt_quad is its complex mirror, run once per weight
tensor (test_crs_chf.f90 performs 32 contractions).  Here:

  * every core is contracted into a weight matrix M_c on the rank's device
    and zero-padded to a uniform (Rm, Rm) block: zero padding is exact for
    a product whose boundary ranks are 1 (the top-left block of the padded
    product is the unpadded product), and the slabs are padded with
    identity blocks to ceil(d / ranks) each;
  * each rank folds its slab in order and joins the others by the same
    log2-depth stride-doubling exchange as the engine's value
    (parallel/engine.py::pvalue), with an exact power-of-2 balance per
    step, so long chains cannot overflow;
  * complex weights contract in complex128 on the device, as
    tt/ops.py::contract does (the JAX package's (re, im) pair arithmetic
    is a TPU workaround, not ported), and a family of K weight sets (the
    chf driver's 32 Fourier tensors) contracts in one pass with a leading K
    axis.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops.dense import as_tensor, scale_pow2
from ..tt.types import TT
from .mesh import BondMesh, psum, shift

__all__ = ["pcontract"]


def _balance(part, ex):
    """part (K, Rm, Rm) scaled by one exact power of two per K lane, so its
    largest real or imaginary entry is in [1, 2); ex (K,) int64 the
    exponents taken out (a zero or non-finite part keeps its scale)."""
    re = torch.view_as_real(part) if part.is_complex() else part[..., None]
    m = re.abs().amax(dim=(-3, -2, -1))
    ok = (m > 0) & (m < float("inf"))
    e = torch.where(ok, torch.frexp(m).exponent.long() - 1, 0)
    if part.is_complex():
        out = torch.view_as_complex(scale_pow2(re, -e[:, None, None, None]).contiguous())
    else:
        out = scale_pow2(part, -e[:, None, None])
    return out, ex + e


def pcontract(t: TT, weights: Sequence, mesh: BondMesh):
    """Contract a real TT against per-mode weight vectors over the ranks of
    `mesh`, every rank holding the whole train and calling with the same
    arguments (the same result on every rank).

    weights: d vectors, each (n_c,) or (K, n_c), real or complex (a (K, n)
    weight matrix contracts K tensors at once; mixed shapes broadcast to
    the common K).  Returns a numpy scalar or (K,) array, complex when any
    weight is complex.  The train is moved to the mesh's device."""
    if t.dtype.is_complex:
        raise ValueError("pcontract shards REAL trains; complex-cored "
                         "trains contract on one device (tt.ops.contract)")
    d, dev = t.d, mesh.device
    ndev, me = mesh.size, mesh.rank
    ws = [as_tensor(w, dev) for w in weights]
    is_complex = any(w.is_complex() for w in ws)
    dt = torch.complex128 if is_complex else torch.float64
    K = max((w.shape[0] for w in ws if w.dim() == 2), default=1)
    Rm = max(max(t.r), 1)

    # every core's weight matrices (K, Rm, Rm), zero-padded; the slabs
    # padded with identity blocks (an empty slab is the identity)
    S = -(-d // ndev)
    eye = torch.eye(Rm, dtype=dt, device=dev).expand(K, Rm, Rm)
    mats = []
    for c in range(S * ndev):
        if c < d:
            g = t.cores[c].to(dev, dt)
            m = torch.einsum("inj,kn->kij", g, ws[c].to(dt).reshape(-1, t.n[c]).expand(K, -1))
            mats.append(torch.nn.functional.pad(m, (0, Rm - g.shape[2], 0, Rm - g.shape[0])))
        else:
            mats.append(eye)

    # this rank's slab, in order, then the stride-doubling fold
    part, ex = eye.clone(), torch.zeros((K,), dtype=torch.int64, device=dev)
    for m in mats[me * S:(me + 1) * S]:
        part, ex = _balance(part @ m, ex)
    stride = 1
    while stride < ndev:
        flat = torch.view_as_real(part) if is_complex else part
        msg = shift(mesh, torch.cat([flat.reshape(K, -1), ex.to(torch.float64)[:, None]], 1),
                    stride)
        if me + stride < ndev:
            right = msg[:, :-1].reshape(flat.shape)
            right = torch.view_as_complex(right.contiguous()) if is_complex else right
            part, ex = _balance(part @ right, ex + msg[:, -1].to(torch.int64))
        stride *= 2

    # the ordered product lives on rank 0: its [0, 0] entries to every rank
    val = part[:, 0, 0]
    val = (torch.view_as_complex(scale_pow2(torch.view_as_real(val), ex[:, None]).contiguous())
           if is_complex else scale_pow2(val, ex))
    flat = torch.view_as_real(val) if is_complex else val
    flat = psum(mesh, flat if me == 0 else torch.zeros_like(flat))
    out = (torch.view_as_complex(flat.contiguous()) if is_complex else flat).cpu().numpy()
    squeeze = all(w.dim() == 1 for w in ws)
    return out[0] if squeeze and K == 1 else out
