"""Ising susceptibility integrands C_m / D_m / E_m.

Counterpart of ttcross_tpu/apps/ising.py (:50-138, :395-466), itself the
batched form of dfunc_ising_discr (test_crs_ising.f90:176-218).  With node
values x_1..x_d and prefix products P_0..P_d (P_0 = 1), the a-term
prod_{i<j} ((P_j - P_i)/(P_j + P_i))^2 is a masked pairwise reduction and
the b-term 1/(v w) uses sums of prefix and suffix products.  The integrand
multiplies the per-dimension quadrature weights itself; the rank-1 quad
tensor carries the rescaling factor 1/val (test_crs_ising.f90:134-144).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..cross.chain_eval import ChainSpec
from ..ops.kernels import ISING_KINDS, ising_integrand_fused, small_table_lookup
from ..ops.quadrature import lgwt

__all__ = ["IsingProblem", "make_ising", "ising_integrand", "ising_c_chain"]


def ising_integrand(ind, tables, kind: str):
    """Batched Ising integrand: ind (B, d) int32 -> (B,) values.

    tables (2, n): the nodes and the rescaled weights.  kind 'C' -> 2b,
    'D' -> 2ab, 'E' -> 2a, each times the product of weights.  On CUDA one
    fused kernel does the lookup and the whole chain (ops/kernels.py::
    ising_integrand_fused); on the CPU its plain version runs."""
    return ising_integrand_fused(tables, ind, kind)


def ising_c_chain(tables) -> ChainSpec:
    """ChainSpec (cross/chain_eval.py) of the C-kind integrand: the value
    2/(v w) prod W (the b-term only) factors through the monoid

        (P, A, Q, W):  P = prod x_i             (block node product)
                       A = sum_k prod_{i<=k} x_i   (prefix-product sums)
                       Q = sum_k prod_{i>=k} x_i   (suffix-product sums)
                       W = prod W_i             (block weight product)

    with merge (L, R) -> (P_L P_R, A_L + P_L A_R, Q_R + P_R Q_L, W_L W_R)
    and finalize 2W / ((1 + A)(1 + Q)).  Nodes lie in [0, 1] and the
    max-normalized weights are <= 1, so every partial is bounded by 1.  The
    a-term of D and E needs all prefix values, not an O(1) state, so only
    kind C has a spec.

    tables (2, n): the nodes and the weights on the problem's device.  lift
    looks both up with ONE small-table lookup (kernel B on the card) on
    the index reshaped to two dimensions, a view where it is contiguous."""
    def identity():
        return dict(P=1.0, A=0.0, Q=0.0, W=1.0)

    def lift(dims, idx):
        del dims  # the mode tables are uniform on the Ising grid
        ind = idx.to(torch.int32).contiguous()      # both free for a contiguous int32 index
        ind = ind.reshape(1, -1) if ind.dim() < 2 else ind.reshape(-1, ind.shape[-1])
        x, w = small_table_lookup(tables, ind).reshape((2,) + idx.shape)
        return dict(P=x, A=x, Q=x, W=w)

    def merge(a, b):
        return dict(P=a["P"] * b["P"],
                    A=a["A"] + a["P"] * b["A"],
                    Q=b["Q"] + b["P"] * a["Q"],
                    W=a["W"] * b["W"])

    def finalize(s):
        return 2.0 * s["W"] / ((1.0 + s["A"]) * (1.0 + s["Q"]))

    return ChainSpec(identity, lift, merge, finalize)


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

    @functools.cached_property
    def chain(self):
        """ChainSpec for O(1) hunt-candidate evaluation, kind C only (None
        otherwise); pass it as cross(..., chain=prob.chain)."""
        if self.kind.upper() != "C":
            return None
        return ising_c_chain(self.tables)


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
