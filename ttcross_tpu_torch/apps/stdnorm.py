"""Product standard-normal integrand: exp(-sum x^2) on [-10, 10]^d.

Counterpart of ttcross_tpu/apps/stdnorm.py:23-43 (test_crs_stdnorm.f90:
integrand at lines 154-170, truth pi^(d/2) at line 83).  The integrand does
not apply weights; they live in the rank-1 quad tensor (lines 100-107).
The node lookup is ops/dense.py::table_lookup: kernel B on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.dense import table_lookup
from ..ops.quadrature import lgwt, map_to_interval

__all__ = ["StdnormProblem", "make_stdnorm"]


@dataclass(frozen=True)
class StdnormProblem:
    """nodes / quad_weights stay host numpy (the problem's definition);
    ``table`` is the (n,) tensor of nodes on the problem's device,
    which the integrand reads."""

    d: int
    n: int
    nodes: np.ndarray
    quad_weights: np.ndarray
    truth: float
    table: torch.Tensor

    def fun(self, ind):
        """ind (B, d) int32 on the problem's device -> (B,) values."""
        x = table_lookup(self.table, ind)
        return torch.exp(-(x * x).sum(dim=1))


def make_stdnorm(d: int = 6, n: int = 65, a: float = -10.0, b: float = 10.0,
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float64) -> StdnormProblem:
    """``device`` places the node table: the card unless the caller asks
    for ``device="cpu"`` (no fallback); ``dtype``: the table's, so the
    integrand's values' (torch.float32 for the f32 tier)."""
    if n % 2 == 0:
        n += 1
    x, w = lgwt(n)
    x, w = map_to_interval(x, w, a, b)
    return StdnormProblem(d=d, n=n, nodes=x, quad_weights=w,
                          truth=float(np.pi) ** (d / 2),
                          table=torch.from_numpy(x).to(device, dtype))
