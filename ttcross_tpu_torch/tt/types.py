"""Tensor-train container.

Counterpart of ttcross_tpu/tt/types.py (the reference's dtt type,
tt.f90:18-52): a TT is a tuple of cores with shapes (r[c], n[c], r[c+1]).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch

from ..ops.dense import as_tensor

__all__ = ["TT", "ones", "zeros", "from_cores", "rank1"]


@dataclass(frozen=True)
class TT:
    """A(i_0..i_{d-1}) = G_0[:, i_0, :] @ ... @ G_{d-1}[:, i_{d-1}, :].

    cores[c] has shape (r[c], n[c], r[c+1]); r[0] = r[d] = 1."""

    cores: tuple[torch.Tensor, ...]

    @property
    def d(self) -> int:
        return len(self.cores)

    @property
    def n(self) -> tuple[int, ...]:
        return tuple(int(c.shape[1]) for c in self.cores)

    @property
    def r(self) -> tuple[int, ...]:
        """Bond ranks, length d+1."""
        return tuple(int(c.shape[0]) for c in self.cores) + (int(self.cores[-1].shape[2]),)

    @property
    def dtype(self) -> torch.dtype:
        return self.cores[0].dtype

    @property
    def device(self) -> torch.device:
        return self.cores[0].device

    def ready(self) -> bool:
        """Structural validation (dtt_ready, tt.f90:1306-1345)."""
        if self.d == 0:
            return False
        r = self.r
        if r[0] != 1 or r[-1] != 1:
            return False
        return all(tuple(self.cores[c].shape[::2]) == (r[c], r[c + 1])
                   for c in range(self.d))

    def erank(self) -> float:
        """Effective rank: solves a*re^2 + b*re = mem for re (tt.f90:1228-1263)."""
        d = self.d
        if d <= 1:
            return 0.0
        n, r = self.n, self.r
        mem = sum(r[c] * n[c] * r[c + 1] for c in range(d))
        b = r[0] * n[0] + n[d - 1] * r[d]
        if d == 2:
            return mem / b
        a = sum(n[1: d - 1])
        return (math.sqrt(b * b + 4.0 * a * mem) - b) / (2.0 * a)

    def mem(self) -> int:
        """Total number of stored core entries (dtt_mem, tt.f90:1266-1281)."""
        return sum(c.numel() for c in self.cores)

    def astype(self, dtype: torch.dtype) -> "TT":
        return TT(tuple(c.to(dtype) for c in self.cores))

    def to(self, device) -> "TT":
        """The train with its cores on `device`."""
        return TT(tuple(c.to(device) for c in self.cores))

    def __repr__(self) -> str:
        return (f"TT(d={self.d}, n={list(self.n)}, r={list(self.r)}, "
                f"dtype={self.dtype}, device={self.device})")


def from_cores(cores: Sequence, device=None) -> TT:
    """A validated TT from tensors or numpy arrays; device=None leaves
    tensors where they lie and sends numpy cores to the card."""
    t = TT(tuple(as_tensor(c, device) for c in cores))
    if not t.ready():
        raise ValueError(f"inconsistent core shapes: {[tuple(c.shape) for c in t.cores]}")
    return t


def ones(n: Sequence[int], dtype: torch.dtype = torch.float64, device="cuda") -> TT:
    """Rank-1 all-ones train (dtt_ones, tt.f90)."""
    return TT(tuple(torch.ones((1, ni, 1), dtype=dtype, device=device) for ni in n))


def zeros(n: Sequence[int], dtype: torch.dtype = torch.float64, device="cuda") -> TT:
    return TT(tuple(torch.zeros((1, ni, 1), dtype=dtype, device=device) for ni in n))


def rank1(vectors: Sequence, device=None) -> TT:
    """Rank-1 train from per-mode vectors (e.g. the quadrature weight
    tensors, test_crs_ising.f90:130-131); device as in from_cores."""
    return TT(tuple(as_tensor(v, device).reshape(1, -1, 1) for v in vectors))
