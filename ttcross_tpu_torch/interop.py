"""Carry the JAX package's arrays, taken as numpy, into the port.

The port imports nothing of the JAX package; a caller that has both turns
the JAX objects into numpy first, e.g.
``state_from_numpy({k: np.asarray(v) for k, v in jax_state._asdict().items()}, device)``.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .apps.ising import IsingProblem, _tables
from .cross.state import CrossState
from .tt.types import TT

__all__ = ["state_from_numpy", "chain_states_from_numpy", "tt_from_numpy",
           "ising_from_numpy"]

_INT_FIELDS = {"rk": torch.int32, "vip": torch.int32,
               "neval": torch.int64, "padded": torch.int64}


def state_from_numpy(arrays: Mapping[str, np.ndarray], device,
                     dtype: torch.dtype = torch.float64) -> CrossState:
    """A port CrossState from the JAX CrossState's fields as numpy arrays.
    Fields the port does not have (the JAX PRNG key) are dropped."""
    fields = {}
    for name in CrossState._fields:
        t = torch.from_numpy(np.array(arrays[name], order="C")).to(_INT_FIELDS.get(name, dtype))
        fields[name] = t.to(device)
    return CrossState(**fields)


def chain_states_from_numpy(Ls: np.ndarray, Rs: np.ndarray, device,
                            dtype: torch.dtype = torch.float64):
    """The carried packed interface states (Ls, Rs), each (d-1, R, K), of
    the JAX ChainEvaluator as the port's: the leaves lie in the same order
    (the sorted keys of the state dict) on the trailing axis."""
    return tuple(torch.from_numpy(np.array(a, order="C")).to(dtype).to(device)
                 for a in (Ls, Rs))


def tt_from_numpy(cores: Sequence[np.ndarray], device,
                  dtype: torch.dtype = torch.float64) -> TT:
    """A port TT from numpy cores (r[c], n[c], r[c+1])."""
    return TT(tuple(torch.from_numpy(np.array(c, dtype=np.float64)).to(dtype).to(device)
                    for c in cores))


def ising_from_numpy(nodes, weights, quad_weights, kind: str, m: int,
                     truth: float | None, device) -> IsingProblem:
    """A port IsingProblem with the given host tables (e.g. the JAX
    problem's), its device tables placed on `device`."""
    nodes = np.asarray(nodes, np.float64)
    weights = np.asarray(weights, np.float64)
    return IsingProblem(kind=kind.upper(), m=int(m), d=int(m) - 1,
                        n=int(nodes.shape[0]), nodes=nodes, weights=weights,
                        quad_weights=np.asarray(quad_weights, np.float64),
                        tables=_tables(nodes, weights, device), truth=truth)
