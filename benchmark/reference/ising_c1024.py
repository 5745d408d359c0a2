"""Plain reference of the ising_c1024 configuration: the Ising
susceptibility integral C_m (Bailey, Borwein and Crandall, "Integrals of the
Ising class", J. Phys. A 39 (2006) 12271) in d = m - 1 variables, at the
substitution of the upstream test program (test_crs_ising.f90:102-144):

    C_m = sum over the grid of 2 prod_k W(i_k) / ((1 + A)(1 + Q)) * prod_k q,
    A = sum_k prod_{j <= k} x(i_j),   Q = sum_k prod_{j >= k} x(i_j),

with x and w the n-point Gauss-Legendre rule on [0, 1] (weights a measure),
the weights scaled inside the integrand, W = w * val, and each mode's
quadrature weight q = 1 / val.  val is 1 / max(w) for m >= 32 (every weight
product then stays below 1) and n // 2 below.  Worked out from these
formulas with the Gauss-Legendre rule of rules.py, in float64 numpy and plain
PyTorch; nothing of the program is imported or read.
"""

from __future__ import annotations

import numpy as np
import torch

from .rules import gauss_legendre

__all__ = ["Reference"]


class Reference:
    """The rule, the scaled weights and the truth of one config."""

    def __init__(self, config: dict, device="cpu"):
        if str(config["kind"]).upper() != "C":
            raise ValueError("this reference is the C kind's")
        self.m, self.n = int(config["m"]), int(config["n"])
        self.d = self.m - 1
        t, w = gauss_legendre(self.n)
        self.nodes = 0.5 * (t + 1.0)
        w = 0.5 * w
        val = 1.0 / float(np.max(w)) if self.m >= 32 else float(self.n // 2)
        self.scaled = w * val
        self.quad = [np.full(self.n, 1.0 / val)] * self.d
        self.truth = float(config["truth"])
        self.device = torch.device(device)
        self._x = torch.as_tensor(self.nodes, dtype=torch.float64, device=self.device)
        self._w = torch.as_tensor(self.scaled, dtype=torch.float64, device=self.device)

    def integrand(self, ind):
        """ind (B, d) int64 tensor -> (B,) float64 values."""
        x, w = self._x[ind], self._w[ind]
        A = torch.cumprod(x, dim=1).sum(dim=1)
        Q = torch.cumprod(x.flip(1), dim=1).sum(dim=1)
        return 2.0 * torch.prod(w, dim=1) / ((1.0 + A) * (1.0 + Q))
