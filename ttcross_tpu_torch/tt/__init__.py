"""Tensor trains of the port: container, algebra, rounding, serialization."""

from .ops import (add, contract, dot, full, gather, group, hadamard, norm, scale, sumall,
                  value)
from .ortho import chop_rank, from_dense, orthogonalize, svd_round
from .serialize import (load_hdf5, load_npz, load_state, load_ttbin, load_ttbin_ref,
                        save_hdf5, save_npz, save_state, save_ttbin, save_ttbin_ref)
from .types import TT, from_cores, ones, rank1, zeros

__all__ = [
    "TT", "from_cores", "ones", "rank1", "zeros",
    "add", "contract", "dot", "full", "gather", "group", "hadamard",
    "norm", "scale", "sumall", "value",
    "chop_rank", "from_dense", "orthogonalize", "svd_round",
    "save_ttbin", "load_ttbin", "save_ttbin_ref", "load_ttbin_ref",
    "save_npz", "load_npz", "save_hdf5", "load_hdf5", "save_state", "load_state",
]
