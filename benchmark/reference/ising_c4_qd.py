"""Plain reference of the ising_c4_qd_r55 configuration, in Python's decimal
at PREC = 100 significant digits: the Ising susceptibility integral C_m
(Bailey, Borwein and Crandall, "Integrals of the Ising class", J. Phys. A 39
(2006) 12271) in d = m - 1 variables, at the substitution of the upstream
test program (test_crs_ising.f90:102-144) that reference/ising_c1024.py
writes out:

    C_m = sum over the grid of 2 prod_k W(i_k) / ((1 + A)(1 + Q)) * prod_k q,
    A = sum_k prod_{j <= k} x(i_j),   Q = sum_k prod_{j >= k} x(i_j),

with x and w the n-point Gauss-Legendre rule on [0, 1] (weights a measure),
W = w * val, and each mode's quadrature weight q = 1 / val, val = n // 2
(m < 32).  The rule is this module's own: Newton's method on the Legendre
recurrence in decimal at PREC + 20 digits, from numpy's float64 nodes, until
the step is below 10^-(PREC + 10); the weights 2 / ((1 - t^2) P_n'(t)^2);
then mapped to [0, 1] and rounded to PREC digits.  The truth is the
configuration's 500-digit string.  Nothing of the program is imported or
read; no departure from the formulas.
"""

from __future__ import annotations

from decimal import Decimal, localcontext

import numpy as np

__all__ = ["PREC", "gauss_legendre_01", "Reference"]

PREC = 100


def _legendre(n: int, t: Decimal):
    """P_n(t) and P_n'(t) by the three-term recurrence (decimal)."""
    p0, p1 = Decimal(1), t
    for k in range(2, n + 1):
        p0, p1 = p1, ((2 * k - 1) * t * p1 - (k - 1) * p0) / k
    return p1, n * (t * p1 - p0) / (t * t - 1)


def gauss_legendre_01(n: int):
    """The n-point Gauss-Legendre rule on [0, 1], nodes ascending: two
    lists of n Decimals at PREC digits."""
    seeds, _ = np.polynomial.legendre.leggauss(n)
    x, w = [], []
    with localcontext() as ctx:
        ctx.prec = PREC + 20
        tol = Decimal(10) ** -(PREC + 10)
        for s in seeds.tolist():
            t = Decimal(s)
            for _ in range(50):
                p, dp = _legendre(n, t)
                step = p / dp
                t -= step
                if abs(step) < tol:
                    break
            else:
                raise ArithmeticError(f"Newton did not converge at the node near {s}")
            _, dp = _legendre(n, t)
            x.append((t + 1) / 2)
            w.append(1 / ((1 - t * t) * dp * dp))     # the [-1, 1] weight over 2
    with localcontext() as ctx:
        ctx.prec = PREC
        return [+v for v in x], [+v for v in w]


class Reference:
    """The rule, the scaled weights, the quadrature weights and the truth
    of one C-kind configuration, all Decimals at PREC digits."""

    def __init__(self, config: dict, device="cpu"):
        if str(config["kind"]).upper() != "C":
            raise ValueError("this reference is the C kind's")
        self.m, self.n = int(config["m"]), int(config["n"])
        if self.m >= 32:
            raise ValueError("this reference takes val = n // 2, the rule below m = 32")
        self.d = self.m - 1
        self.device = device          # the check runs on the host
        self.nodes, w = gauss_legendre_01(self.n)
        val = self.n // 2
        with localcontext() as ctx:
            ctx.prec = PREC
            self.scaled = [+(v * val) for v in w]
            self.quad = [[Decimal(1) / val] * self.n] * self.d
            self.truth = +Decimal(str(config["truth"]))

    def integrand(self, ind) -> list:
        """ind (B, d) ints (any array-like) -> B Decimals at PREC digits."""
        x, W = self.nodes, self.scaled
        out = []
        with localcontext() as ctx:
            ctx.prec = PREC
            for row in np.asarray(ind, np.int64).tolist():
                xs = [x[i] for i in row]
                a = q = Decimal(0)
                pa = pq = Decimal(1)
                prod_w = Decimal(2)
                for k in range(len(row)):
                    pa *= xs[k]
                    pq *= xs[-1 - k]
                    a += pa
                    q += pq
                    prod_w *= W[row[k]]
                out.append(prod_w / ((1 + a) * (1 + q)))
        return out
