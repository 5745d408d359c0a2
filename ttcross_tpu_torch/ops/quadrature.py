"""Gauss-Legendre rule generation (host numpy, set-up time).

A copy of ttcross_tpu/ops/quadrature.py's lgwt (lgwt, quad.f90:97-131) and
map_to_interval, kept here so that the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["lgwt", "gauss_legendre", "map_to_interval"]

_TWO_PI = 6.283185307179586476925286766559005768394338798750211641949889184615632812572418


def lgwt(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes and weights on [-1, 1].

    Newton iteration on the three-term Legendre recurrence, vectorized over
    the upper half of the nodes."""
    small = 5 * np.finfo(np.float64).eps
    m = (n + 1) // 2
    i = np.arange(1, m + 1)
    z = np.cos(_TWO_PI * (4 * i - 1) / (8 * n + 4))
    for _ in range(100):
        p1 = np.ones_like(z)
        p2 = np.zeros_like(z)
        for j in range(1, n + 1):
            p3 = p2
            p2 = p1
            p1 = ((2 * j - 1) * z * p2 - (j - 1) * p3) / j
        pp = n * (z * p1 - p2) / (z * z - 1)
        z1 = z
        z = z1 - p1 / pp
        if np.all(np.abs(z - z1) <= small):
            break
    x = np.empty(n)
    w = np.empty(n)
    x[:m] = -z
    x[n - m:] = z[::-1]
    w[:m] = 2.0 / ((1 - z * z) * pp * pp)
    w[n - m:] = w[:m][::-1]
    return x, w


gauss_legendre = lgwt


def map_to_interval(x: np.ndarray, w: np.ndarray, a: float, b: float) -> tuple[np.ndarray, np.ndarray]:
    """Affine map of a [-1, 1] rule to [a, b] (test_crs_stdnorm.f90:92-95)."""
    return 0.5 * ((b - a) * x + (a + b)), 0.5 * (b - a) * w
