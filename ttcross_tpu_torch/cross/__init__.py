"""The cross engines of the port: the DMRG-greedy cross, the alternating
maxvol refinement, and the accuracy check."""

from .accchk import accchk
from .engine import CrossConfig, CrossResult, cross, make_engine, round_and_revalue
from .maxvol import cross_maxvol, masked_solve, maxvol_refine, maxvol_select
from .state import CrossState, empty_state, pad_state

__all__ = ["CrossConfig", "CrossResult", "CrossState", "accchk", "cross", "cross_maxvol",
           "empty_state", "make_engine", "masked_solve", "maxvol_refine", "maxvol_select",
           "pad_state", "round_and_revalue"]
