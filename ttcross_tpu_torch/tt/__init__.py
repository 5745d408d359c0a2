"""Tensor trains of the port: container, algebra, rounding."""

from .ops import contract, full, gather, value
from .ortho import chop_rank, orthogonalize, svd_round
from .types import TT

__all__ = ["TT", "chop_rank", "contract", "full", "gather", "orthogonalize",
           "svd_round", "value"]
