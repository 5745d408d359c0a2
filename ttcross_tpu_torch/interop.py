"""Carry the JAX package's arrays, taken as numpy, into the port.

The port imports nothing of the JAX package; a caller that has both turns
the JAX objects into numpy first, e.g.
``state_from_numpy({k: np.asarray(v) for k, v in jax_state._asdict().items()}, device)``.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .apps.cos import CosCoefficients, make_cos_coefficients
from .apps.ising import IsingProblem, _tables
from .apps.mvn import MvnProblem, density_from_numpy
from .apps.stdnorm import StdnormProblem
from .cross.state import CrossState
from .tt.types import TT

__all__ = ["state_from_numpy", "chain_states_from_numpy", "tt_from_numpy",
           "ising_from_numpy", "mvn_from_numpy", "stdnorm_from_numpy",
           "cos_from_numpy", "sets_from_numpy"]

_INT_FIELDS = {"rk": torch.int32, "vip": torch.int32,
               "neval": torch.int64, "padded": torch.int64, "sweeps": torch.int64}


def state_from_numpy(arrays: Mapping[str, np.ndarray], device,
                     dtype: torch.dtype = torch.float64) -> CrossState:
    """A port CrossState from the JAX CrossState's fields as numpy arrays.
    Fields the port does not have (the JAX PRNG key) are dropped; the count
    of sweeps made, which the JAX state does not have, starts at 0."""
    fields = {}
    for name in CrossState._fields:
        arr = arrays[name] if name != "sweeps" else arrays.get("sweeps", 0)
        t = torch.from_numpy(np.array(arr, order="C")).to(_INT_FIELDS.get(name, dtype))
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


def mvn_from_numpy(nodes, quad_weights, mu, cov, inv_cov, det_cov: float, device,
                   truth: float = 1.0) -> MvnProblem:
    """A port MvnProblem with the given host arrays (e.g. the JAX problem's
    nodes, weights and density), its tables placed on `device`."""
    nodes = np.asarray(nodes, np.float64)
    dens = density_from_numpy(mu, cov, inv_cov, det_cov, device)
    return MvnProblem(d=dens.d, n=int(nodes.shape[0]), nodes=nodes,
                      quad_weights=np.asarray(quad_weights, np.float64), density=dens,
                      truth=float(truth), table=torch.from_numpy(nodes).to(device))


def stdnorm_from_numpy(nodes, quad_weights, d: int, truth: float, device) -> StdnormProblem:
    """A port StdnormProblem with the given host rule."""
    nodes = np.asarray(nodes, np.float64)
    return StdnormProblem(d=int(d), n=int(nodes.shape[0]), nodes=nodes,
                          quad_weights=np.asarray(quad_weights, np.float64),
                          truth=float(truth), table=torch.from_numpy(nodes).to(device))


def cos_from_numpy(mu, sigma, lower: float, upper: float, device) -> CosCoefficients:
    """A port CosCoefficients from the JAX bundle's mean and covariance."""
    return make_cos_coefficients(int(np.asarray(mu).shape[0]), mu, sigma, lower, upper,
                                 device=device)


def sets_from_numpy(LI: np.ndarray, RJ: np.ndarray, rr: np.ndarray, device):
    """Maxvol's padded index tables LI, RJ (d-1, R, d) and per-bond ranks rr
    (d-1,) as int32 tensors on `device` (cross/maxvol.py's run takes them)."""
    return tuple(torch.from_numpy(np.array(a, dtype=np.int32, order="C")).to(device)
                 for a in (LI, RJ, rr))
