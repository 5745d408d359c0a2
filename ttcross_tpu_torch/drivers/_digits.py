"""Correct digits -log10|1 - value/truth| for the drivers: in decimal for
the extended-precision tiers, in f64 for the f64 drivers."""

from __future__ import annotations

from decimal import Decimal, localcontext

__all__ = ["digits_of", "report", "report_f64"]


def digits_of(value: Decimal, truth: str, prec: int) -> float:
    """Digits of `value` against the decimal string `truth` at `prec`
    significant digits (`prec` when they agree to the last one)."""
    with localcontext() as ctx:
        ctx.prec = prec
        rel = abs(1 - value / Decimal(truth))
        return float(-rel.log10()) if rel != 0 else float(prec)


def report(value: Decimal, truth: str | None, prec: int, shown: int) -> float | None:
    """Print the computed value, and with a truth the analytic value and
    the correct digits, as the JAX drivers do; returns the digits."""
    with localcontext() as ctx:
        ctx.prec = shown
        print(f"computed value: {+value}")
        if truth is None:
            return None
        print(f"analytic value: {+Decimal(truth)}")
    digits = digits_of(value, truth, prec)
    print(f"correct digits: {digits:7.2f}")
    return digits


def report_f64(value: float, truth: float | None) -> float | None:
    """The f64 drivers' lines (drivers/crs_ising.py:45-50): the computed
    value, and with a truth the analytic value and the correct digits;
    returns the digits."""
    import numpy as np

    print(f"computed value: {value:.40e}")
    if not truth:
        return None
    print(f"analytic value: {truth:.40e}")
    digits = float(-np.log10(abs(1 - value / truth)))
    print(f"correct digits: {digits:7.2f}")
    return digits
