"""Cross-engine state, statically padded to rank R.

Counterpart of ttcross_tpu/cross/state.py.  The arrays keep the JAX
package's padded layout so that a state converts between the two packages
field by field (interop.state_from_numpy).  The engine updates the large
arrays IN PLACE (where JAX used .at[].set / dynamic_update_slice) and
replaces the 0-d scalars with new tensors.  There is no PRNG key: the
sweep's uniforms come from outside (cross/engine.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CrossState", "empty_state"]


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
    )
