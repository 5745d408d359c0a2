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
from .cross.engine_dd import DDState
from .cross.state import CrossState
from .ops.dd import DD
from .ops.qd import QD
from .tt.types import TT

__all__ = ["state_from_numpy", "chain_states_from_numpy", "tt_from_numpy",
           "ising_from_numpy", "mvn_from_numpy", "stdnorm_from_numpy",
           "cos_from_numpy", "sets_from_numpy", "dd_pair_from_numpy", "dd_state_from_numpy",
           "qd_from_numpy", "qd_state_from_numpy"]

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


def dd_pair_from_numpy(hi, lo, device) -> DD:
    """A port DD of float64 tensors on `device` from a (hi, lo) pair of
    numpy arrays (e.g. the JAX makers' node and weight tables Xn, Wn)."""
    return DD(*(torch.from_numpy(np.array(a, dtype=np.float64, order="C")).to(device)
                for a in (hi, lo)))


_DD_INT_FIELDS = {"rk": torch.int32, "vip": torch.int32, "neval": torch.int64}


def dd_state_from_numpy(arrays: Mapping, device) -> DDState:
    """A port DDState from the JAX DDState's fields as numpy: each dd field
    (cores, colf, rowf, itl, itt) a (hi, lo) pair, the others arrays.  The
    JAX PRNG key is dropped: the port's draws come from cross_dd's
    generator or its ``draws`` hook."""
    fields = {}
    for name in DDState._fields:
        arr = arrays[name]
        if name in ("cores", "colf", "rowf", "itl", "itt"):
            fields[name] = dd_pair_from_numpy(arr[0], arr[1], device)
        else:
            t = torch.from_numpy(np.array(arr, order="C"))
            fields[name] = t.to(_DD_INT_FIELDS.get(name, torch.float64)).to(device)
    return DDState(**fields)


def qd_from_numpy(x, device) -> QD:
    """A port QD of float64 tensors on `device` from a numpy-backed QD (the
    JAX package's ops/qd.py QD, or any four limb arrays)."""
    return QD(*(torch.from_numpy(np.array(e, dtype=np.float64, order="C")).to(device) for e in x))


_QD_LIST_FIELDS = ("G", "Cf", "Rf", "itl", "itt")


def qd_state_from_numpy(engine, state: Mapping, device=None):
    """Carry a JAX QdEngine's state into a port QdEngine (cross/engine_qd.py)
    built with the same integrand and settings: ``state`` maps vip, r, G,
    Cf, Rf, itl, itt and log_amax (and, when present, log_pivotmax_prev,
    neval and rng, the numpy Generator's bit_generator.state) to the JAX
    engine's values, the qd fields as lists of numpy-backed QDs.  Returns
    the engine, its qd state on `device` (the engine's by default)."""
    dev = engine.device if device is None else torch.device(device)
    engine.vip = [[tuple(int(v) for v in pv) for pv in bond] for bond in state["vip"]]
    engine.r = [int(v) for v in state["r"]]
    for name in _QD_LIST_FIELDS:
        setattr(engine, name, [qd_from_numpy(x, dev) for x in state[name]])
    engine.log_amax = float(state["log_amax"])
    engine.log_pivotmax_prev = float(state.get("log_pivotmax_prev", engine.log_amax))
    if "neval" in state:
        engine.neval = int(state["neval"])
    if "rng" in state:
        engine.rng.bit_generator.state = state["rng"]
    return engine
