"""Growing bordered-LU representation of the cross pivot-submatrix inverse.

Counterpart of ttcross_tpu/ops/lu.py (d2_lug/d2_lual/d2_luar, lr.f90:98-154;
incremental append in dmrgg.f90:649-660).  Per bond, statically padded to
rank R:

  c[s, :s] = col-factor row at pivot s      (c_s = Cf[i_s j_s, :s])
  u[s, :s] = row-factor column at pivot s   (u_s = Rf[:s, k_s q_s])
  d[s]     = residual pivot value           (delta_s)

so that C_raw = Cf @ T and R_raw = L @ Rf with T upper triangular
(T[t, s] = u_s[t], T[s, s] = delta_s) and L unit lower triangular
(L[s, t] = c_s[t]).  The active rank r may be a Python int or a 0-d tensor;
rows and columns at or beyond it act as the identity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["GrowingLU", "lu_empty", "lu_append", "make_T", "make_L",
           "solve_cols", "solve_rows", "apply_new_col", "apply_new_row"]


class GrowingLU(NamedTuple):
    c: torch.Tensor  # (R, R) lower borders
    u: torch.Tensor  # (R, R) upper borders
    d: torch.Tensor  # (R,)   residual pivot values


def _active(R: int, r, device) -> torch.Tensor:
    return torch.arange(R, device=device) < r


def lu_empty(R: int, dtype: torch.dtype, device) -> GrowingLU:
    return GrowingLU(c=torch.zeros((R, R), dtype=dtype, device=device),
                     u=torch.zeros((R, R), dtype=dtype, device=device),
                     d=torch.ones((R,), dtype=dtype, device=device))


def lu_append(lu: GrowingLU, r, c_new, u_new, delta) -> GrowingLU:
    """Append pivot r (0-based) with borders of length r (entries >= r are
    ignored).  Returns a new GrowingLU; lu is left as it was."""
    R = lu.d.shape[0]
    mask = _active(R, r, lu.d.device)
    idx = torch.as_tensor(r, device=lu.d.device).long().view(1)
    zero = torch.zeros((), dtype=lu.c.dtype, device=lu.c.device)
    return GrowingLU(
        c=lu.c.index_copy(0, idx, torch.where(mask, c_new, zero)[None]),
        u=lu.u.index_copy(0, idx, torch.where(mask, u_new, zero)[None]),
        d=lu.d.index_copy(0, idx, torch.as_tensor(delta, dtype=lu.d.dtype,
                                                  device=lu.d.device).view(1)),
    )


def make_T(lu: GrowingLU, r) -> torch.Tensor:
    """Upper-triangular T (R, R): T[t, s] = u_s[t] for t < s < r,
    diag = delta_s for s < r, identity beyond the active rank."""
    R = lu.d.shape[0]
    s_idx = torch.arange(R, device=lu.d.device)
    active = s_idx < r
    T = torch.where((s_idx[:, None] < s_idx[None, :]) & active[None, :], lu.u.T, 0.0)
    diag = torch.where(active, lu.d, 1.0)
    return T + torch.diag(diag)


def make_L(lu: GrowingLU, r) -> torch.Tensor:
    """Unit-lower-triangular L (R, R): L[s, t] = c_s[t] for t < s < r."""
    R = lu.d.shape[0]
    s_idx = torch.arange(R, device=lu.d.device)
    active = s_idx < r
    L = torch.where((s_idx[:, None] > s_idx[None, :]) & active[:, None], lu.c, 0.0)
    return L + torch.eye(R, dtype=lu.c.dtype, device=lu.c.device)


def solve_cols(lu: GrowingLU, r, C) -> torch.Tensor:
    """Cf = C @ T^-1 (d2_lual from=1, lr.f90:124-139); C (..., R)."""
    T = make_T(lu, r)
    shape = C.shape
    Cf = torch.linalg.solve_triangular(T, C.reshape(-1, shape[-1]), upper=True,
                                       left=False)
    return Cf.reshape(shape)


def solve_rows(lu: GrowingLU, r, Rm) -> torch.Tensor:
    """Rf = L^-1 @ Rm (d2_luar from=1, lr.f90:140-154); Rm (R, ...)."""
    L = make_L(lu, r)
    shape = Rm.shape
    Rf = torch.linalg.solve_triangular(L, Rm.reshape(shape[0], -1), upper=False,
                                       unitriangular=True)
    return Rf.reshape(shape)


def apply_new_col(prev_Cf, u_new, delta, acol, r) -> torch.Tensor:
    """Incremental column update (dmrgg.f90:701): the new col-factor column
    (acol - Cf[..., :r] @ u_new) / delta; prev_Cf (..., R), acol (...)."""
    R = prev_Cf.shape[-1]
    mask = _active(R, r, prev_Cf.device).to(prev_Cf.dtype)
    return (acol - prev_Cf @ (u_new * mask)) / delta


def apply_new_row(prev_Rf, c_new, arow, r) -> torch.Tensor:
    """Incremental row update (dmrgg.f90:702): arow - c_new @ Rf[:r];
    prev_Rf (R, ...), arow (...)."""
    R = prev_Rf.shape[0]
    mask = _active(R, r, prev_Rf.device).to(prev_Rf.dtype)
    return arow - torch.tensordot(c_new * mask, prev_Rf, dims=([0], [0]))
