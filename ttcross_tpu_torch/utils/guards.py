"""Numerical guards: NaN detection and structural checks.

Counterpart of ttcross_tpu/utils/guards.py (nan.f90's NaN detection,
ort.f90:58; the allocation-size audit dtt_memchk, tt.f90:836-877).  Debug
utilities: each reads its answer from the device.  A tensor is checked
where it lies; a numpy array goes to ``device`` (the card by default), as
everywhere in the package.
"""

from __future__ import annotations

import torch

from ..ops.dense import as_tensor
from ..tt.types import TT

__all__ = ["has_nan", "assert_finite", "tt_check"]


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(torch.view_as_real(x) if x.is_complex() else x).all())


def has_nan(*arrays, device=None) -> bool:
    """True if any array contains NaN (nan.f90:8-82)."""
    return any(bool(torch.isnan(as_tensor(a, device)).any()) for a in arrays)


def assert_finite(x, what: str = "array", device=None):
    x = as_tensor(x, device)
    if not _finite(x):
        raise FloatingPointError(f"{what} contains non-finite values")
    return x


def tt_check(t: TT) -> None:
    """Structural + numerical validation (ready + memchk analogue,
    tt.f90:836-877, 1306-1345)."""
    if not t.ready():
        raise ValueError(f"inconsistent TT core shapes: {[tuple(c.shape) for c in t.cores]}")
    for c, g in enumerate(t.cores):
        if not _finite(g):
            raise FloatingPointError(f"TT core {c} contains non-finite values")
