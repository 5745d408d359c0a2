"""The cross engines of the port: the DMRG-greedy cross and its lane-batched
family form, the alternating maxvol refinement, the frozen skeleton, the
accuracy check, and the dd tier: the dd engine (cross_dd) and the
defect-corrected cross (cross_defect_corrected)."""

from .accchk import accchk
from .batch import BatchCrossResult, cross_batch, lane_batched, lane_key
from .defect import cross_defect_corrected
from .engine import CrossConfig, CrossResult, cross, make_engine, round_and_revalue
from .engine_dd import (DDConfig, DDCrossResult, DDKit, DDState, cross_dd, dd_quad_cores,
                        get_dd_engine)
from .maxvol import cross_maxvol, masked_solve, maxvol_refine, maxvol_select
from .skeleton import (Skeleton, derive_host_fun, extract_skeleton, reevaluate_host,
                       skeleton_tt_fn, skeleton_value_fn)
from .state import CrossState, empty_state, pad_state

__all__ = ["BatchCrossResult", "CrossConfig", "CrossResult", "CrossState", "DDConfig",
           "DDCrossResult", "DDKit", "DDState", "Skeleton", "accchk",
           "cross", "cross_batch", "cross_dd", "cross_defect_corrected", "cross_maxvol",
           "dd_quad_cores", "derive_host_fun", "empty_state", "get_dd_engine",
           "extract_skeleton", "lane_batched", "lane_key", "make_engine", "masked_solve",
           "maxvol_refine", "maxvol_select", "pad_state", "reevaluate_host", "round_and_revalue",
           "skeleton_tt_fn", "skeleton_value_fn"]
