"""The cross engines of the port: the DMRG-greedy cross and its lane-batched
family form, the alternating maxvol refinement, the frozen skeleton, and the
accuracy check."""

from .accchk import accchk
from .batch import BatchCrossResult, cross_batch, lane_batched, lane_key
from .engine import CrossConfig, CrossResult, cross, make_engine, round_and_revalue
from .maxvol import cross_maxvol, masked_solve, maxvol_refine, maxvol_select
from .skeleton import (Skeleton, derive_host_fun, extract_skeleton, reevaluate_host,
                       skeleton_tt_fn, skeleton_value_fn)
from .state import CrossState, empty_state, pad_state

__all__ = ["BatchCrossResult", "CrossConfig", "CrossResult", "CrossState", "Skeleton", "accchk",
           "cross", "cross_batch", "cross_maxvol", "derive_host_fun", "empty_state",
           "extract_skeleton", "lane_batched", "lane_key", "make_engine", "masked_solve",
           "maxvol_refine", "maxvol_select", "pad_state", "reevaluate_host", "round_and_revalue",
           "skeleton_tt_fn", "skeleton_value_fn"]
