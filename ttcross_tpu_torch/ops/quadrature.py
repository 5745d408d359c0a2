"""Gauss-Legendre rule generation (host numpy, set-up time).

A copy of ttcross_tpu/ops/quadrature.py's lgwt (lgwt, quad.f90:97-131),
map_to_interval and the 1/t rule quad_rinv / quad_rinv_error (quad.f90:
8-95), kept here so that the port imports nothing of the JAX package; and
gauss_legendre_dd, the dd tier's rule, which the JAX package takes from
its native library (__float128 Newton, ttcross_tpu/native/src/
ttcross_native.cpp:31-64) and the port computes with Python's decimal; and
gauss_legendre_decimal, the qd tier's 80-digit rule, which the JAX package
takes from mpmath (ttcross_tpu/ops/mp.py:75-103, mp_lgwt).
"""

from __future__ import annotations

import math
from decimal import Decimal, localcontext

import numpy as np

__all__ = ["lgwt", "gauss_legendre", "gauss_legendre_dd", "gauss_legendre_decimal",
           "map_to_interval", "quad_rinv", "quad_rinv_error"]

_TWO_PI = 6.283185307179586476925286766559005768394338798750211641949889184615632812572418
_DD_DIGITS = 50                            # decimal digits of gauss_legendre_dd's Newton


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


def _dd_pair(v: Decimal) -> tuple[float, float]:
    hi = float(v)
    return hi, float(v - Decimal(hi))


def gauss_legendre_dd(n: int):
    """Gauss-Legendre nodes and weights on [-1, 1] as double-double pairs,
    ((x_hi, x_lo), (w_hi, w_lo)), each (n,) f64 numpy, accurate to ~1e-34.

    The JAX package's rule (native.gauss_legendre_dd): the Chebyshev seed
    cos(pi (4i - 1) / (4n + 2)), Newton on the Legendre recurrence until
    the step is below 1e-35; here gauss_legendre_decimal at 50 digits (its
    step below 1e-40), each value rounded to hi = the nearest double and lo
    = the nearest double of the rest.  Nodes ascend, the upper half mirrors
    the lower one, and an odd n has the node 0 exactly."""
    x, w = gauss_legendre_decimal(n, _DD_DIGITS)
    with localcontext() as ctx:
        ctx.prec = _DD_DIGITS
        (xh, xl), (wh, wl) = (np.array([_dd_pair(v) for v in vs], np.float64).reshape(n, 2).T.copy()
                              for vs in (x, w))
    return (xh, xl), (wh, wl)


def gauss_legendre_decimal(n: int, digits: int = 100):
    """Gauss-Legendre nodes and weights on [-1, 1] as Decimals at `digits`
    significant digits (lists of n, nodes ascending): mp_lgwt's algorithm
    (lgwt, quad.f90:97-131, at arbitrary precision), Newton on the
    Legendre recurrence from the seed cos(pi (k + 3/4) / (n + 1/2)) until
    the step is below 10^-(digits - 10), here in decimal.  The qd makers
    round these to qd limbs (ops/qd.py::qd_from_mp), at the JAX package's
    80 digits or beyond."""
    x, w = [Decimal(0)] * n, [Decimal(0)] * n
    with localcontext() as ctx:
        ctx.prec = digits
        one = Decimal(1)
        tol = Decimal(10) ** -(digits - 10)
        for k in range(n // 2 + n % 2):
            t = Decimal(math.cos(math.pi * (k + 0.75) / (n + 0.5)))
            for _ in range(100):
                p0, p1 = one, t
                for j in range(2, n + 1):
                    p0, p1 = p1, ((2 * j - 1) * t * p1 - (j - 1) * p0) / j
                dp = n * (t * p1 - p0) / (t * t - one)
                step = p1 / dp
                t -= step
                if abs(step) < tol:
                    break
            p0, p1 = one, t
            for j in range(2, n + 1):
                p0, p1 = p1, ((2 * j - 1) * t * p1 - (j - 1) * p0) / j
            dp = n * (t * p1 - p0) / (t * t - one)
            x[k], x[n - 1 - k] = -t, t
            w[k] = w[n - 1 - k] = 2 / ((one - t * t) * dp * dp)
        if n % 2 == 1:
            x[n // 2] = Decimal(0)
    return x, w


def map_to_interval(x: np.ndarray, w: np.ndarray, a: float, b: float) -> tuple[np.ndarray, np.ndarray]:
    """Affine map of a [-1, 1] rule to [a, b] (test_crs_stdnorm.f90:92-95)."""
    return 0.5 * ((b - a) * x + (a + b)), 0.5 * (b - a) * w


def quad_rinv(n: int) -> np.ndarray:
    """Exp-sinh quadrature approximating 1/t ~= sum_i w_i exp(-a_i t^2)
    (quad_rinv1, quad.f90:8-46).  Returns q of shape (2, m): the weights in
    row 0, the exponents in row 1."""
    nq = (n - 3) // 2
    h = np.log(_TWO_PI * nq) / nq
    log_huge = np.log(np.finfo(np.float64).max)
    rows = [(0.0, 0.0)]
    for i in range(-nq, nq + 1):
        t = i * h
        sinh_t, cosh_t = np.sinh(t), np.cosh(t)
        if abs(sinh_t) > log_huge:
            continue
        exp_sinh = np.exp(-sinh_t)
        weight = 2.0 * cosh_t * h / (np.sqrt(_TWO_PI / 2.0) * (1.0 + exp_sinh))
        alpha = np.log(1.0 + 1.0 / exp_sinh) ** 2
        rows.append((weight, alpha))
    return np.asarray(rows, dtype=np.float64).T


def quad_rinv_error(q: np.ndarray, a: float, b: float, n: int) -> float:
    """Largest relative error of the 1/t rule q on n log-spaced points of
    [a, b] (testquad_rinv, quad.f90:48-95; its file output dropped, the
    value returned)."""
    if a <= 0 or b <= 0:
        raise ValueError(f"illegal interval: {a}, {b}")
    ts = np.exp(np.linspace(np.log(min(a, b)), np.log(max(a, b)), n))
    approx = (q[0][None, :] * np.exp(-q[1][None, :] * ts[:, None] ** 2)).sum(axis=1)
    return float(np.max(ts * np.abs(1.0 / ts - approx)))
