"""Cross-engine state, statically padded to rank R.

Counterpart of ttcross_tpu/cross/state.py.  The arrays keep the JAX
package's padded layout so that a state converts between the two packages
field by field (interop.state_from_numpy).  The engine updates the large
arrays IN PLACE (where JAX used .at[].set / dynamic_update_slice) and
replaces the 0-d scalars with new tensors.  There is no PRNG key: the
sweep's uniforms come from outside (cross/engine.py), drawn from the run's
key one block per sweep; ``sweeps`` counts the sweeps made, so that a
resumed run (cross(init_state=...)) goes on in that stream where the first
run stopped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["CrossState", "empty_state", "pad_state"]


class CrossState(NamedTuple):
    """Bond b (0..d-2) sits between cores b and b+1; rk[b+1] is its active
    rank (rk[0] = rk[d] = 1)."""

    cores: torch.Tensor   # (d, R, N, R) raw sampled fibers
    colf: torch.Tensor    # (d, R, N, R) col factors; slot c = bond c
    rowf: torch.Tensor    # (d, R, N, R) row factors; slot c = bond c-1
    rk: torch.Tensor      # (d+1,) int32 active bond ranks
    vip: torch.Tensor     # (d-1, R, 4) int32 pivot chains (i, j, k, q)
    lu_c: torch.Tensor    # (d-1, R, R) growing-LU col borders
    lu_u: torch.Tensor    # (d-1, R, R) growing-LU row borders
    lu_d: torch.Tensor    # (d-1, R)    growing-LU pivots
    itl: torch.Tensor     # (d-1, R, R) maintained L^-1
    itt: torch.Tensor     # (d-1, R, R) maintained T^-1
    amax: torch.Tensor    # () max |sample| seen
    pivotmax: torch.Tensor       # () max accepted |pivot| this sweep (-1 = none)
    pivotmin: torch.Tensor       # () min accepted |pivot| this sweep (-1 = none)
    pivotmax_prev: torch.Tensor  # () previous sweep's pivotmax
    neval: torch.Tensor   # () int64 active integrand evaluations
    padded: torch.Tensor  # () int64 integrand calls incl. masked padding
    sweeps: torch.Tensor  # () int64 sweeps made so far (0 for a state from the JAX package)


def pad_state(st: CrossState, R_new: int) -> CrossState:
    """Embed a CrossState padded at rank R into padding R_new > R.

    Zero-padding everywhere except: lu_d pads with ones, and the maintained
    triangular inverses pad block-diagonally with the identity ([[M, 0],
    [0, I]] keeps L^-1 / T^-1 exact for the enlarged unit-triangular
    factors)."""
    R = st.vip.shape[1]
    if R_new == R:
        return st
    if R_new < R:
        raise ValueError(f"cannot shrink padding {R} -> {R_new}")
    dR = R_new - R

    def pad4(a):  # (d, R, N, R) -> (d, R_new, N, R_new)
        return F.pad(a, (0, dR, 0, 0, 0, dR))

    def pad_sq(a):  # (d-1, R, R) -> (d-1, R_new, R_new)
        return F.pad(a, (0, dR, 0, dR))

    tail = (torch.arange(R_new, device=st.itl.device) >= R).to(st.itl.dtype)
    eye_tail = torch.diag(tail)
    return st._replace(
        cores=pad4(st.cores), colf=pad4(st.colf), rowf=pad4(st.rowf),
        vip=F.pad(st.vip, (0, 0, 0, dR)),
        lu_c=pad_sq(st.lu_c), lu_u=pad_sq(st.lu_u),
        lu_d=F.pad(st.lu_d, (0, dR), value=1.0),
        itl=pad_sq(st.itl) + eye_tail, itt=pad_sq(st.itt) + eye_tail)


def empty_state(d: int, N: int, R: int, dtype: torch.dtype, device) -> CrossState:
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    eye = torch.eye(R, dtype=dtype, device=device).expand(d - 1, R, R)
    return CrossState(
        cores=z(d, R, N, R), colf=z(d, R, N, R), rowf=z(d, R, N, R),
        rk=torch.ones(d + 1, dtype=torch.int32, device=device),
        vip=torch.zeros((d - 1, R, 4), dtype=torch.int32, device=device),
        lu_c=z(d - 1, R, R), lu_u=z(d - 1, R, R),
        lu_d=torch.ones((d - 1, R), dtype=dtype, device=device),
        itl=eye.clone(), itt=eye.clone(),
        amax=z(), pivotmax=torch.full((), -1.0, dtype=dtype, device=device),
        pivotmin=torch.full((), -1.0, dtype=dtype, device=device),
        pivotmax_prev=z(),
        neval=torch.zeros((), dtype=torch.int64, device=device),
        padded=torch.zeros((), dtype=torch.int64, device=device),
        sweeps=torch.zeros((), dtype=torch.int64, device=device),
    )
