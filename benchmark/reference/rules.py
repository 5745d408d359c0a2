"""The n-point Gauss-Legendre rule on [-1, 1], nodes ascending, for the
references: numpy's rule polished by Newton's method on the Legendre
recurrence in numpy's long double (64-bit significand on x86-64), then
rounded to float64, so that nodes and weights are the float64 numbers
nearest the exact rule up to the long double's rounding."""

from __future__ import annotations

import numpy as np

__all__ = ["gauss_legendre"]


def _legendre(n: int, x):
    """P_n(x) and P_n'(x) by the three-term recurrence."""
    p0, p1 = np.ones_like(x), x
    for k in range(2, n + 1):
        p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
    return p1, n * (x * p1 - p0) / (x * x - 1)


def gauss_legendre(n: int):
    x, _ = np.polynomial.legendre.leggauss(n)
    x = x.astype(np.longdouble)
    for _ in range(3):
        p, dp = _legendre(n, x)
        x = x - p / dp
    _, dp = _legendre(n, x)
    w = 2 / ((1 - x * x) * dp * dp)
    return x.astype(np.float64), w.astype(np.float64)
