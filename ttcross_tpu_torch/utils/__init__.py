"""Utilities of the port."""

from .metrics import SweepRecord, history_from_run

__all__ = ["SweepRecord", "history_from_run"]
