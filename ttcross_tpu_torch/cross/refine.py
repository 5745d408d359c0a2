"""Extended-precision refinement of a completed cross.

Counterpart of ttcross_tpu/cross/refine.py (:31-83), the role of the
reference's multiprecision tier (mptt_dmrgg + mptt_quad, dmrggmp.f90):
pivot selection stays in the f64 engine (selection needs resolution, not
precision); the crossed tensor is re-evaluated at the selected pivot chains
by an extended-precision integrand, and the interpolant's quadrature

  val = e0  prod_c [ G_c(w) Ahat_c^{-1} ]

(G_c the raw fibers at the chains contracted with the weights, Ahat_c the
pivot submatrices) is evaluated beyond f64.  The JAX package evaluates it
in __float128 on the host (its native.cross_value_dd); the port in
quad-double on the integrand's device: the G_c(w) products through Q4
(ops/qd.py::qd_vdot_axis, qd_matmul) and each (r, r) solve by qd Gaussian
elimination with partial pivoting (the pivot rows read on the host).

fun_dd protocol: the port's dd integrands' (apps.make_ising_dd's and
apps.make_stdnorm_dd's fun_dd): fun_dd(ind (B, d) int32 tensor) -> DD (B,)
or any (hi, lo) pair of (B,) arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.qd import (QD, qd, qd_div, qd_get, qd_matmul, qd_mul, qd_sub, qd_to_dd,
                      qd_vdot_axis)
from .chains import pivot_index_sets
from .state import CrossState

__all__ = ["refine_dd"]


def _qd_solve(A: QD, b: QD) -> QD:
    """x with A x = b in qd, A (r, r), b (r,): row-pivoted Gaussian
    elimination (the pivot: the largest |e0| of the column, first on ties),
    then back substitution."""
    A = QD(*(e.clone() for e in A))
    b = QD(*(e.clone() for e in b))
    r = A.e0.shape[0]
    for k in range(r):
        p = k + int(torch.argmax(A.e0[k:, k].abs()))
        if p != k:
            perm = torch.arange(r, device=A.e0.device)
            perm[k], perm[p] = p, k
            A = QD(*(e[perm] for e in A))
            b = QD(*(e[perm] for e in b))
        piv = qd_get(A, (k, k))
        if float(piv.e0) == 0.0:
            raise ZeroDivisionError(f"singular pivot submatrix at column {k}")
        if k + 1 < r:
            m = qd_div(qd_get(A, (slice(k + 1, None), k)),
                       QD(*(e.expand(r - k - 1) for e in piv)))
            rowk = qd_get(A, (k, slice(k + 1, None)))
            upd = qd_sub(qd_get(A, (slice(k + 1, None), slice(k + 1, None))),
                         qd_mul(QD(*(e[:, None] for e in m)), QD(*(e[None, :] for e in rowk))))
            bk = QD(*(e[k].expand(r - k - 1) for e in b))
            bupd = qd_sub(qd_get(b, slice(k + 1, None)), qd_mul(m, bk))
            for e, u in zip(A, upd):
                e[k + 1:, k + 1:] = u
            for e, u in zip(b, bupd):
                e[k + 1:] = u
    x = QD(*(torch.zeros_like(e) for e in b))
    for k in range(r - 1, -1, -1):
        s = qd_get(b, k)
        if k + 1 < r:
            s = qd_sub(s, qd_vdot_axis(qd_get(A, (k, slice(k + 1, None))),
                                       qd_get(x, slice(k + 1, None)), 0))
        xk = qd_div(s, qd_get(A, (k, k)))
        for e, v in zip(x, xk):
            e[k] = v
    return x


def _qd_of(v, device) -> QD:
    hi, lo = v
    hi = torch.as_tensor(np.asarray(hi) if not torch.is_tensor(hi) else hi,
                         dtype=torch.float64).to(device)
    lo = torch.as_tensor(np.asarray(lo) if not torch.is_tensor(lo) else lo,
                         dtype=torch.float64).to(device)
    return qd(hi, lo)


def refine_dd(state: CrossState, n, fun_dd, weights_hi, weights_lo=None,
              device: str | torch.device = "cuda"):
    """Re-evaluate the crossed tensor at its pivot chains in extended
    precision and return the quadrature value as a double-double
    (hi, lo, neval); the signature of ttcross_tpu.cross.refine.refine_dd
    plus ``device``, where the integrand is called and the qd work runs:
    the card unless the caller asks for ``device="cpu"``.

    state: the final engine state (cross(..., return_state=True)).  n:
    per-mode sizes.  fun_dd: the dd integrand (module doc), taking int32
    indices on `device`.  weights_*: per-mode quadrature weight vectors as
    dd pairs (weights_lo None: zero)."""
    n = [int(x) for x in n]
    d = len(n)
    dev = torch.device(device)
    rk = state.rk.cpu().numpy().reshape(-1)
    if weights_lo is None:
        weights_lo = [np.zeros(ni) for ni in n]
    I, J = pivot_index_sets(state.vip, state.rk)

    def evaluate(ind):
        return _qd_of(fun_dd(torch.from_numpy(ind.astype(np.int32)).to(dev)), dev)

    neval = 0
    v = None
    for c in range(d):
        # the raw core G_c = A(I_{c-1}, j, J_c) at the pivot chains
        rl, rr = int(rk[c]), int(rk[c + 1])
        pre = I[c - 1] if c > 0 else [()]
        suf = J[c] if c < d - 1 else [()]
        ind = np.array([pre[a] + (j,) + suf[b] for a in range(rl) for j in range(n[c])
                        for b in range(rr)], dtype=np.int64).reshape(-1, d)
        g = QD(*(e.reshape(rl, n[c], rr) for e in evaluate(ind)))
        neval += len(ind)
        w = _qd_of((weights_hi[c], weights_lo[c]), dev)
        m = qd_vdot_axis(g, QD(*(e[: n[c]] for e in w)), 1)           # (rl, rr)
        v = m if v is None else qd_matmul(v, m)                        # (1, rr)
        if c < d - 1:
            # v <- v Ahat_c^{-1}: Ahat_c^T y = v^T, Ahat_c = A(I_c, J_c)
            ind = np.array([I[c][a] + J[c][b] for a in range(rr) for b in range(rr)],
                           dtype=np.int64).reshape(-1, d)
            ahat = QD(*(e.reshape(rr, rr) for e in evaluate(ind)))
            neval += len(ind)
            y = _qd_solve(QD(*(e.T for e in ahat)), QD(*(e[0] for e in v)))
            v = QD(*(e[None] for e in y))
    val = qd_to_dd(qd_get(v, (0, 0)))
    return float(val.hi), float(val.lo), neval
