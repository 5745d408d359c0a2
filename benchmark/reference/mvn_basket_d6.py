"""Plain reference of the mvn_basket_d6 configuration: the Black-Scholes
log-return density of an equicorrelated basket of d assets, integrated on a
box by a tensor-product Gauss-Legendre rule.

Worked out from the published formulas alone (mvn_pdf.f90:15-83 of the
upstream ttcross library; the Gauss-Legendre rule of rules.py), in float64 numpy and
plain PyTorch; nothing of the program is imported or read.  For an asset at
S0 with rate r, horizon T and volatility sigma, the log price is normal with
mean log S0 + (r - sigma^2 / 2) T and variance sigma^2 T; two assets have
covariance corr sigma^2 T.  Mode k's index i is the node x_i of the rule on
config["box"], nodes ascending.
"""

from __future__ import annotations

import numpy as np
import torch

from .rules import gauss_legendre

__all__ = ["Reference"]


class Reference:
    """The rule, the truth and each correlation's density of one config."""

    def __init__(self, config: dict, device="cpu"):
        self.d, self.n = int(config["d"]), int(config["n"])
        a, b = (float(x) for x in config["box"])
        t, w = gauss_legendre(self.n)
        self.nodes = 0.5 * ((b - a) * t + (a + b))
        self.weights = 0.5 * (b - a) * w                 # the quadrature weights of a mode
        self.quad = [self.weights] * self.d
        self.truth = float(config["truth"])
        self.S0, self.r, self.T, self.sigma = (float(config[k]) for k in ("S0", "r", "T", "sigma"))
        self.device = torch.device(device)
        self._nodes_t = torch.as_tensor(self.nodes, dtype=torch.float64, device=self.device)

    def density(self, corr: float):
        """(mean (d,), inverse covariance (d, d), normalisation) of one
        correlation, in float64 numpy."""
        d, var = self.d, self.sigma ** 2 * self.T
        mu = np.full(d, np.log(self.S0) + (self.r - 0.5 * self.sigma ** 2) * self.T)
        cov = np.full((d, d), corr * var)
        np.fill_diagonal(cov, var)
        return mu, np.linalg.inv(cov), np.sqrt((2.0 * np.pi) ** d * np.linalg.det(cov))

    def integrand(self, corr: float):
        """ind (B, d) int64 tensor -> (B,) float64 density values at the
        nodes, for one correlation."""
        mu, icov, norm = self.density(corr)
        mu_t = torch.as_tensor(mu, device=self.device)
        icov_t = torch.as_tensor(icov, device=self.device)

        def fun(ind):
            z = self._nodes_t[ind] - mu_t
            return torch.exp(-0.5 * ((z @ icov_t) * z).sum(dim=1)) / norm

        return fun
