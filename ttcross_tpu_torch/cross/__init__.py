"""The cross engines of the port: the DMRG-greedy cross and its lane-batched
family form, the alternating maxvol refinement, the frozen skeleton, the
accuracy check, the dd tier: the dd engine (cross_dd) and the
defect-corrected cross (cross_defect_corrected), and the qd tier: the qd
engine (cross_qd), its defect-corrected cross (cross_defect_corrected_qd)
and the extended-precision refinement of an f64 cross (refine_dd), and the
mp tier on the host: the mpmath engine (cross_mp, exported lazily: it needs
mpmath) and the compiled MPFR engine (cross_mp_native,
ising_cross_mp_native)."""

from .accchk import accchk
from .batch import BatchCrossResult, cross_batch, lane_batched, lane_key
from .defect import cross_defect_corrected, cross_defect_corrected_qd
from .engine import CrossConfig, CrossResult, cross, make_engine, round_and_revalue
from .engine_dd import (DDConfig, DDCrossResult, DDKit, DDState, cross_dd, dd_quad_cores,
                        get_dd_engine)
from .engine_mp_native import MpNativeResult, cross_mp_native, ising_cross_mp_native
from .engine_qd import QD_DPS, QdCrossResult, QdEngine, cross_qd
from .hostwalk import walk_index
from .maxvol import cross_maxvol, masked_solve, maxvol_refine, maxvol_select
from .refine import refine_dd
from .skeleton import (Skeleton, derive_host_fun, extract_skeleton, reevaluate_host,
                       skeleton_tt_fn, skeleton_value_fn)
from .state import CrossState, empty_state, pad_state

__all__ = ["BatchCrossResult", "CrossConfig", "CrossResult", "CrossState", "DDConfig",
           "DDCrossResult", "DDKit", "DDState", "MpCrossResult", "MpEngine", "MpNativeResult",
           "QD_DPS", "QdCrossResult", "QdEngine", "Skeleton",
           "accchk", "cross", "cross_batch", "cross_dd", "cross_defect_corrected",
           "cross_defect_corrected_qd", "cross_maxvol", "cross_mp", "cross_mp_native",
           "cross_qd", "ising_cross_mp_native", "mp_tt_value", "refine_dd", "walk_index",
           "dd_quad_cores", "derive_host_fun", "empty_state", "get_dd_engine",
           "extract_skeleton", "lane_batched", "lane_key", "make_engine", "masked_solve",
           "maxvol_refine", "maxvol_select", "pad_state", "reevaluate_host", "round_and_revalue",
           "skeleton_tt_fn", "skeleton_value_fn"]

# the mp tier's mpmath engine imports mpmath at module scope: exported on
# first access, so that importing this package does not need mpmath
# (ttcross_tpu/cross/__init__.py:22)
_LAZY = {"cross_mp": "engine_mp", "MpCrossResult": "engine_mp", "MpEngine": "engine_mp",
         "mp_tt_value": "engine_mp"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        val = getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
        globals()[name] = val
        return val
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
