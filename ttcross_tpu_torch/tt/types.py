"""Tensor-train container.

Counterpart of ttcross_tpu/tt/types.py (the reference's dtt type,
tt.f90:18-52): a TT is a tuple of cores with shapes (r[c], n[c], r[c+1]).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["TT"]


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

    def __repr__(self) -> str:
        return (f"TT(d={self.d}, n={list(self.n)}, r={list(self.r)}, "
                f"dtype={self.dtype}, device={self.device})")
