"""Precision constants of the PyTorch port.

Counterpart of ttcross_tpu/config.py:79-97.  The port never changes
torch's global default dtype: every function takes its dtype explicitly,
and the engine runs in float64 unless told otherwise.
"""

from __future__ import annotations

import torch

__all__ = ["eps", "precision_thresholds"]


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
