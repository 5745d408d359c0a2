"""Quantics problem builder: 1-D / dd-D functions on virtual base^K grids.

Counterpart of ttcross_tpu/apps/quantics.py (:1-129).  The engine crosses a
quantics tensor (a function on a 2^K grid as a K-dimensional binary tensor)
like any other, and tt.ops.value evaluates the train at real coordinates
with the reference's digit convention (dtt_value, tt.f90:702-728).  This
module packages what the reference leaves to the caller: the bit packing
of the integrand, the domain mapping, the uniform product quadrature, and
the relaxed pivot-acceptance floor that geometric quantics spectra need.

Digit convention (shared with tt.ops.value): coordinate `i` owns modes
[i*K, (i+1)*K); within a block the LAST mode holds the MOST significant
digit, u = sum_k ind[k] * base**(k - K) for k = 0..K-1.

The user's f is a torch function of x on the problem's device: (B,) -> (B,)
when dd == 1, else (B, dd) -> (B,), in float64.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["QuanticsProblem", "make_quantics", "quantics_cross"]


@dataclass
class QuanticsProblem:
    """A dd-dimensional function on the virtual (base^K)^dd grid, packed as
    a (dd*K)-dimensional base-sized tensor for the cross engine."""

    fun: Callable          # batched ind (B, dd*K) int32 -> (B,)
    f: Callable            # the underlying x-space function
    K: int                 # digits per coordinate
    dd: int                # number of real coordinates
    base: int
    domain: tuple          # (lo, hi), applied per coordinate
    device: torch.device   # where fun's indices and f's coordinates lie
    d: int = field(init=False)      # total tensor dimensionality = dd*K
    n: int = field(init=False)      # mode size = base

    def __post_init__(self):
        self.d = self.dd * self.K
        self.n = self.base

    @property
    def quad_weights(self) -> list:
        """Per-mode weight vectors whose TT contraction is the Riemann sum
        (the uniform product measure): integral ~ contract(tt, w).  The
        cell volume ((hi-lo)/base^K)^dd rides the first mode of each
        coordinate block, so the contraction needs no post-scaling."""
        lo, hi = self.domain
        w_plain = np.full(self.base, 1.0 / self.base)
        w_first = w_plain * (hi - lo)
        w = []
        for _ in range(self.dd):
            w.append(w_first.copy())
            w.extend(w_plain.copy() for _ in range(self.K - 1))
        return w

    def grid_x(self, ind) -> torch.Tensor:
        """Map index rows (B, dd*K) to coordinates (B, dd) in the domain,
        float64 on the indices' device."""
        lo, hi = self.domain
        ind = torch.as_tensor(ind)
        pows = float(self.base) ** torch.arange(-self.K, 0, dtype=torch.float64,
                                                device=ind.device)
        cols = [ind[:, i * self.K: (i + 1) * self.K].to(torch.float64) @ pows
                for i in range(self.dd)]
        return lo + (hi - lo) * torch.stack(cols, dim=1)

    def value(self, t, x) -> torch.Tensor:
        """Evaluate a crossed train at real coordinates x (B, dd) or (dd,)
        in the domain (the nearest grid point below, like dtt_value)."""
        from ..tt.ops import value as tt_value

        lo, hi = self.domain
        u = (torch.as_tensor(x, dtype=torch.float64) - lo) / (hi - lo)
        return tt_value(t, u, dd=self.dd)


def make_quantics(f: Callable, K: int, dd: int = 1, base: int = 2,
                  domain: Sequence[float] = (0.0, 1.0),
                  device: str | torch.device = "cuda") -> QuanticsProblem:
    """Package f for the cross engine on a virtual base^K grid per
    coordinate.  f is batched over x: (B,) -> (B,) when dd == 1, else
    (B, dd) -> (B,).  ``device``: where the engine's indices, and so f's
    coordinates, lie: the card unless the caller asks for ``device="cpu"``
    (no fallback)."""
    if K < 2:
        raise ValueError("K must be >= 2 (need at least one bond)")
    if dd < 1 or base < 2:
        raise ValueError("dd >= 1 and base >= 2 required")
    lo, hi = (float(domain[0]), float(domain[1]))
    if not hi > lo:
        raise ValueError(f"empty domain {domain}")

    holder = []

    def fun(ind):
        x = holder[0].grid_x(ind)
        return f(x[:, 0]) if dd == 1 else f(x)

    prob = QuanticsProblem(fun=fun, f=f, K=K, dd=dd, base=base, domain=(lo, hi),
                           device=torch.device(device))
    holder.append(prob)
    return prob


def quantics_cross(f: Callable, K: int, dd: int = 1, base: int = 2,
                   domain: Sequence[float] = (0.0, 1.0), max_rank: int = 8,
                   quad: bool = True, small_pivot: float = 1e-14,
                   device: str | torch.device = "cuda", **kw):
    """Cross f on the virtual grid and return (problem, CrossResult).

    The defaults encode the quantics regime: geometric bond-spectrum decay
    needs a relaxed relative pivot floor (the per-dtype default rejects
    pivots 5+ orders below amax, truncating the train early), and the
    Riemann-sum weights give per-sweep integral telemetry.  Deep grids
    (K ~ 18+) with non-trivial amplitude structure can stall on a
    greedy-pivot conditioning plateau (exp(x) sin(6 pi x), K = 20: ~4e-7
    point error at any rank or pivoting); refine_sweeps=1, one maxvol pivot
    replacement sweep, restores ~1e-14 for ~2x the evaluations.  Other
    keyword arguments go to cross()."""
    from ..cross import cross

    prob = make_quantics(f, K, dd=dd, base=base, domain=domain, device=device)
    res = cross(prob.fun, [prob.n] * prob.d, max_rank=max_rank,
                quad=prob.quad_weights if quad else None,
                small_pivot=small_pivot, device=device, **kw)
    return prob, res
