"""The sequential DMRG-greedy cross engine of the port."""

from .engine import CrossConfig, CrossResult, cross, make_engine, round_and_revalue
from .state import CrossState, empty_state

__all__ = ["CrossConfig", "CrossResult", "CrossState", "cross", "empty_state",
           "make_engine", "round_and_revalue"]
