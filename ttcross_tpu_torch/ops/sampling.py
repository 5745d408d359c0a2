"""Weighted candidate sampling.

Counterpart of ttcross_tpu/ops/sampling.py (lottery2, rnd.f90:105-144):
draw (row, col) candidate pairs with probabilities proportional to two
weight vectors by inverse-CDF search.  The cross engine inlines its own
draw; this standalone form is for library users and tests.
"""

from __future__ import annotations

import torch

from .dense import as_tensor

__all__ = ["weighted_lottery"]


def _draw(w, u):
    """Inverse-CDF picks for uniforms u in [0, 1): the f64 CDF of |w| scaled
    by its maximum, the target clamped below the total so that a zero-weight
    tail is never drawn."""
    w = w.abs()
    cdf = torch.cumsum(w / w.max().clamp(min=torch.finfo(w.dtype).tiny), 0)
    t = torch.minimum(u * cdf[-1], cdf[-1] * (1.0 - 2.0 ** -40))
    return torch.searchsorted(cdf, t, right=True).clamp(max=w.shape[0] - 1)


def weighted_lottery(key: int, wcol, wrow, npnt: int, device="cuda"):
    """Draw npnt (row, col) index pairs, (npnt, 2) int64, with probabilities
    proportional to |wcol| and |wrow| (zero-weight entries are never
    drawn).  key seeds the CPU generator of the uniforms, so the card and
    the CPU draw the same pairs."""
    gen = torch.Generator(device="cpu").manual_seed(int(key))
    u = torch.rand((2, npnt), generator=gen, dtype=torch.float64).to(device)
    wcol, wrow = (as_tensor(w, device, torch.float64) for w in (wcol, wrow))
    return torch.stack([_draw(wcol, u[0]), _draw(wrow, u[1])], dim=1)
