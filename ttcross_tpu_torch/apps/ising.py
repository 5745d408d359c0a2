"""Ising susceptibility integrands C_m / D_m / E_m.

Counterpart of ttcross_tpu/apps/ising.py (:50-90, :395-466), itself the
batched form of dfunc_ising_discr (test_crs_ising.f90:176-218).  With node
values x_1..x_d and prefix products P_0..P_d (P_0 = 1), the a-term
prod_{i<j} ((P_j - P_i)/(P_j + P_i))^2 is a masked pairwise reduction and
the b-term 1/(v w) uses sums of prefix and suffix products.  The integrand
multiplies the per-dimension quadrature weights itself; the rank-1 quad
tensor carries the rescaling factor 1/val (test_crs_ising.f90:134-144).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.kernels import ISING_KINDS, ising_integrand_fused
from ..ops.quadrature import lgwt

__all__ = ["IsingProblem", "make_ising", "ising_integrand"]


def ising_integrand(ind, tables, kind: str):
    """Batched Ising integrand: ind (B, d) int32 -> (B,) values.

    tables (2, n): the nodes and the rescaled weights.  kind 'C' -> 2b,
    'D' -> 2ab, 'E' -> 2a, each times the product of weights.  On CUDA one
    fused kernel does the lookup and the whole chain (ops/kernels.py::
    ising_integrand_fused); on the CPU its plain version runs."""
    return ising_integrand_fused(tables, ind, kind)


@dataclass(frozen=True)
class IsingProblem:
    """Problem bundle: batched integrand, rank-1 quad weights, truth.

    nodes/weights/quad_weights stay host numpy (they are the problem's
    definition); ``tables`` is the (2, n) float64 tensor of nodes and
    weights on the problem's device, which the integrand reads."""

    kind: str
    m: int                    # integral index (C_m / D_m / E_m)
    d: int                    # TT dimension = m - 1
    n: int                    # quadrature size (odd)
    nodes: np.ndarray         # (n,) Gauss-Legendre nodes mapped to [0, 1]
    weights: np.ndarray       # (n,) rescaled weights applied by the integrand
    quad_weights: np.ndarray  # (n,) per-mode entries of the rank-1 quad tensor
    tables: torch.Tensor      # (2, n) nodes and weights on the device
    truth: float | None = None
    rescale: bool = field(default=False)

    def fun(self, ind):
        return ising_integrand(ind, self.tables, self.kind)


def _tables(nodes, weights, device) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.asarray(nodes, np.float64),
                                      np.asarray(weights, np.float64)])).to(device)


def make_ising(kind: str = "C", m: int = 6, n: int = 65,
               device: str | torch.device = "cuda") -> IsingProblem:
    """Build the discretized Ising problem exactly as the reference's test
    program does (test_crs_ising.f90:102-144): Gauss-Legendre on [0, 1] with the
    measure normalization, underflow rescaling for D/E with m >= 10, and
    max-weight normalization for m >= 32.  ``device`` places the tables:
    the card unless the caller asks for ``device="cpu"`` (no fallback)."""
    from .truths import ising_truth

    kind = kind.upper()
    if kind not in ISING_KINDS:
        raise ValueError(f"unknown Ising integral kind: {kind}")
    if n % 2 == 0:
        n += 1  # the reference adjusts even n (test_crs_ising.f90:40)
    d = m - 1
    x, w = lgwt(n)
    w = 0.5 * w                 # make it a measure on [0,1]
    x = (x + 1.0) / 2.0         # [-1,1] -> [0,1]
    rescale = kind in ("D", "E") and m >= 10
    val = 5.0 * (n // 2) if rescale else float(n // 2)
    if m >= 32:
        # long chains: normalizing by the max weight bounds every weight
        # product by 1 (ttcross_tpu/apps/ising.py:443-455)
        val = float(1.0 / np.max(w))
        rescale = True
    weights = w * val
    quad_weights = np.full(n, 1.0 / val)
    try:
        truth = ising_truth(kind, m)
    except KeyError:
        truth = None
    return IsingProblem(kind=kind, m=m, d=d, n=n, nodes=x, weights=weights,
                        quad_weights=quad_weights,
                        tables=_tables(x, weights, device), truth=truth,
                        rescale=rescale)
