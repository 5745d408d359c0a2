"""TT orthogonalization and TT-SVD rounding.

Counterpart of ttcross_tpu/tt/ortho.py (:24-154): dtt_ort (tt.f90:130-198),
dtt_svd (tt.f90:307-368) and the rank-chopping rule chop (mat.f90:433-458).
The QR and SVD factorizations run with torch.linalg on the train's device
(cuSOLVER in f64 on CUDA); only the singular values and norms come to the
host, for the rank choice and the scalar norm bookkeeping.  svd_round_host
is the same truncation in numpy on the host, for cores rebuilt there
(cross/skeleton.py::reevaluate_host), and from_dense the TT-SVD of a dense
tensor (dtt_svd0, tt.f90:434-479), in numpy on the host as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..ops.dense import as_tensor
from .types import TT

__all__ = ["chop_rank", "orthogonalize", "svd_round", "svd_round_host", "from_dense"]


def chop_rank(s, tol: float | None = None, rmax: int | None = None) -> int:
    """Truncation rank: largest r with tail energy below (tol*|s|)^2,
    capped at rmax (chop, mat.f90:433-458)."""
    s = np.asarray(s)
    r = s.size
    er2 = 0.0
    if rmax is not None and rmax < r:
        er2 = float(np.dot(s[rmax:], s[rmax:]))
        r = rmax
    if tol is not None and r > 1:
        bound = tol * tol * float(np.dot(s, s))
        er = er2 + float(s[r - 1]) ** 2
        while er < bound and r > 1:
            er2 = er
            r -= 1
            er += float(s[r - 1]) ** 2
    return max(r, 1)


def orthogonalize(t: TT) -> TT:
    """Left-to-right QR sweep with geometric norm balancing across cores
    (dtt_ort, tt.f90:130-198): every core but the last is left-orthogonal
    and all cores share one scale factor."""
    d = t.d
    cores = list(t.cores)
    lognrm = 0.0
    for k in range(d - 1):
        rc, nc, rn = cores[k].shape
        q, rr = torch.linalg.qr(cores[k].reshape(rc * nc, rn), mode="reduced")
        nrm = float(torch.linalg.norm(rr))
        if nrm != 0.0:
            rr = rr / nrm
            lognrm += math.log(nrm)
        cores[k] = q.reshape(rc, nc, q.shape[1])
        cores[k + 1] = torch.tensordot(rr, cores[k + 1], dims=([1], [0]))
    nrm = float(torch.linalg.norm(cores[d - 1]))
    if nrm != 0.0:
        cores[d - 1] = cores[d - 1] / nrm
        lognrm += math.log(nrm)
    common = math.exp(lognrm / d)
    return TT(tuple(c * common for c in cores))


def _svd(m):
    """Thin SVD.  On CUDA this asks cuSOLVER for gesvd (QR iteration, as
    LAPACK): torch's default there, the Jacobi gesvdj, leaves the rounded
    C_6 train's quadrature value ~2.6e-14 (median) off the LAPACK
    rounding of the same train, which costs the headline ~0.3 digits;
    gesvd stays within ~1e-15 (PERF.md)."""
    if m.device.type == "cuda":
        return torch.linalg.svd(m, full_matrices=False, driver="gesvd")
    return torch.linalg.svd(m, full_matrices=False)


def svd_round(t: TT, tol: float = 1e-14, rmax: int | None = None) -> TT:
    """TT-SVD truncation: orthogonalize, then a right-to-left SVD chop
    (dtt_svd, tt.f90:307-368)."""
    t = orthogonalize(t)
    d = t.d
    cores = list(t.cores)
    lognrm = 0.0
    for k in range(d - 1, 0, -1):
        rc, nc, rn = cores[k].shape
        u, s, vh = _svd(cores[k].reshape(rc, nc * rn))
        rr = chop_rank(s.cpu().numpy(), tol=tol, rmax=rmax)
        u, s, vh = u[:, :rr], s[:rr], vh[:rr]
        nrm = float(torch.linalg.norm(s))
        if nrm != 0.0:
            s = s / nrm
            lognrm += math.log(nrm)
        cores[k] = vh.reshape(rr, nc, rn)
        cores[k - 1] = torch.tensordot(cores[k - 1], u * s, dims=([2], [0]))
    nrm = float(torch.linalg.norm(cores[0]))
    if nrm != 0.0:
        cores[0] = cores[0] / nrm
        lognrm += math.log(nrm)
    common = math.exp(lognrm / d)
    return TT(tuple(c * common for c in cores))


def svd_round_host(cores: list, tol: float = 0.0, rmax: int | None = None) -> list:
    """TT-SVD truncation of plain numpy cores in numpy on the host, with
    the chop rule of svd_round: a left-to-right QR sweep, then a
    right-to-left SVD chop.  Returns numpy cores.  cross(host_reeval=...)
    rounds the train it rebuilt on the host with it, as the JAX package
    does."""
    cs = [np.asarray(c, np.float64) for c in cores]
    d = len(cs)
    for k in range(d - 1):
        rl, nc, rr = cs[k].shape
        q, r = np.linalg.qr(cs[k].reshape(rl * nc, rr))
        cs[k] = q.reshape(rl, nc, q.shape[1])
        cs[k + 1] = np.einsum("ij,jnk->ink", r, cs[k + 1])
    for k in range(d - 1, 0, -1):
        rc, nc, rn = cs[k].shape
        u, s, vh = np.linalg.svd(cs[k].reshape(rc, nc * rn), full_matrices=False)
        rr = chop_rank(s, tol=tol, rmax=rmax)
        cs[k] = vh[:rr].reshape(rr, nc, rn)
        cs[k - 1] = np.einsum("inj,jk->ink", cs[k - 1], u[:, :rr] * s[:rr])
    return cs


def from_dense(a, n: Sequence[int] | None = None, tol: float = 1e-14,
               rmax: int | None = None, device=None) -> TT:
    """Compress a dense tensor into TT form by successive SVDs from the
    right (dtt_svd0, tt.f90:434-479), in numpy on the host with the chop
    rule of svd_round.  a: a numpy array or a tensor, reshaped to n (its
    own shape by default).  The cores go where ops/dense.py::as_tensor
    sends a caller's array: a tensor's device, numpy to the card, unless
    ``device`` says otherwise."""
    if torch.is_tensor(a):
        device = a.device if device is None else device
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    n = tuple(int(x) for x in (a.shape if n is None else n))
    d = len(n)
    cores: list = [None] * d
    r_right = 1
    # unfold progressively: B_k has shape (n_0 ... n_{k-1}, n_k r_right)
    mat = a.reshape(n).reshape(int(np.prod(n[:-1])), n[-1])
    for k in range(d - 1, 0, -1):
        mat = mat.reshape(int(np.prod(n[:k])), n[k] * r_right)
        u, s, vh = np.linalg.svd(mat, full_matrices=False)
        rr = chop_rank(s, tol=tol, rmax=rmax)
        cores[k] = vh[:rr].reshape(rr, n[k], r_right)
        mat = u[:, :rr] * s[:rr]
        r_right = rr
    cores[0] = mat.reshape(1, n[0], r_right)
    return TT(tuple(as_tensor(c, device) for c in cores))
