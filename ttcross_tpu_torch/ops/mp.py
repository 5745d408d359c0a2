"""Arbitrary-precision substrate (mpmath) of the mp tier.

A copy of ttcross_tpu/ops/mp.py.  The reference's beyond-dd tier is
MPFUN-MPFR at a compile-time 120 decimal digits (mpfunf.f90:63, mpipl =
120); here, as in the JAX package, mpmath on the host plays that role.  The
tier stays on the host by design (ttcross_tpu/ops/mp.py:1-17): no torch
tensor and no card is involved, values are numpy object arrays of mpf, and
the engine's code vectorizes with numpy ufuncs dispatching to mpmath's
operators.

Log-domain magnitude bookkeeping follows dmrggmp.f90:50-53/107/364: with
120-digit data the dynamic range exceeds f64, so thresholds and `amax` live
in log10.  `mag10` scales mpmath's exact binary magnitude (mpf.mag) to
log10: monotone and cheap, which is all the threshold tests need.
"""

from __future__ import annotations

import numpy as np
from mpmath import mp, mpf

__all__ = ["workdps", "mp_array", "mp_zeros", "mag10", "mp_lgwt", "to_mpf",
           "dps_newton_iters"]

_LOG10_2 = 0.30102999566398120


class workdps:
    """Context manager pinning mp.dps (the mpipl analogue)."""

    def __init__(self, dps: int):
        self.dps = int(dps)

    def __enter__(self):
        self._saved = mp.dps
        mp.dps = self.dps
        return self

    def __exit__(self, *exc):
        mp.dps = self._saved
        return False


def to_mpf(x) -> mpf:
    """Exact conversion (floats and ints embed exactly in mpf)."""
    return mpf(x)


def mp_array(values) -> np.ndarray:
    """Object ndarray of mpf."""
    a = np.empty(np.shape(values), dtype=object)
    flat = a.reshape(-1)
    src = np.asarray(values, dtype=object).reshape(-1)
    for i, v in enumerate(src):
        flat[i] = mpf(v) if not isinstance(v, mpf) else v
    return a


def mp_zeros(shape) -> np.ndarray:
    a = np.empty(shape, dtype=object)
    a.reshape(-1)[:] = [mpf(0)] * int(np.prod(shape))
    return a


def mag10(x) -> float:
    """~log10 |x| from the exact binary magnitude (monotone; -inf at 0).
    Safe for values far beyond f64's exponent range (the D/E rescaling
    regime, test_crs_ising.f90:135-144)."""
    if x == 0:
        return float("-inf")
    return float(mp.mag(x)) * _LOG10_2


def mp_lgwt(n: int, dps: int | None = None):
    """Gauss-Legendre nodes/weights on [-1, 1] at mp precision by Newton
    iteration on the Legendre recurrence (lgwt, quad.f90:97-131 — same
    algorithm, arbitrary precision)."""
    with workdps(dps or mp.dps):
        x = np.empty(n, dtype=object)
        w = np.empty(n, dtype=object)
        for k in range(n // 2 + n % 2):
            # Chebyshev initial guess, then Newton to full precision
            t = mp.cos(mp.pi * (k + mpf(3) / 4) / (n + mpf(1) / 2))
            for _ in range(dps_newton_iters(dps or mp.dps)):
                p0, p1 = mpf(1), t
                for j in range(2, n + 1):
                    p0, p1 = p1, ((2 * j - 1) * t * p1 - (j - 1) * p0) / j
                dp = n * (t * p1 - p0) / (t * t - 1)
                t = t - p1 / dp
            p0, p1 = mpf(1), t
            for j in range(2, n + 1):
                p0, p1 = p1, ((2 * j - 1) * t * p1 - (j - 1) * p0) / j
            dp = n * (t * p1 - p0) / (t * t - 1)
            x[k] = -t
            x[n - 1 - k] = t
            wk = 2 / ((1 - t * t) * dp * dp)
            w[k] = wk
            w[n - 1 - k] = wk
        if n % 2 == 1:
            x[n // 2] = mpf(0)
        return x, w


def dps_newton_iters(dps: int) -> int:
    """Newton doubles correct digits; the Chebyshev guess is good to ~1e-3."""
    iters, digits = 0, 3.0
    while digits < dps + 5:
        digits *= 2
        iters += 1
    return iters + 1
