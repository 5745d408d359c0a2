"""Precision constants of the PyTorch port.

Counterpart of ttcross_tpu/config.py:70-97.  The port never changes
torch's global default dtype: every function takes its dtype explicitly,
and the engine runs in float64 unless told otherwise.  The JAX package
switches its whole f64 / f32 tier with TTCROSS_NO_X64; the port has no
global switch: cross(dtype=torch.float32) and the makers' dtype= select
the f32 tier per call.
"""

from __future__ import annotations

import torch

__all__ = ["default_dtype", "default_complex_dtype", "eps", "precision_thresholds"]


def default_dtype() -> torch.dtype:
    """The default real dtype: torch.float64.  There is no global switch to
    f32 (the JAX package's TTCROSS_NO_X64): the f32 tier is asked for per
    call, cross(dtype=torch.float32)."""
    return torch.float64


def default_complex_dtype() -> torch.dtype:
    """The default complex dtype: torch.complex128 (no global switch, as
    default_dtype)."""
    return torch.complex128


def eps(dtype: torch.dtype = torch.float64) -> float:
    """Machine epsilon of a real torch dtype."""
    return float(torch.finfo(dtype).eps)


def precision_thresholds(dtype: torch.dtype = torch.float64) -> tuple[float, float]:
    """(small_element, small_pivot) acceptance thresholds per dtype.

    Mirrors the reference's precision dispatch (dmrgg.f90:62-84):
      real*4  -> (5 eps, 1e-3);  real*8 -> (10 eps, 1e-5).
    """
    e = eps(dtype)
    if torch.finfo(dtype).bits <= 32:
        return 5.0 * e, 1.0e-3
    return 10.0 * e, 1.0e-5
