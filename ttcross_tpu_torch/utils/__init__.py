"""Utilities of the port."""

from .guards import assert_finite, has_nan, tt_check
from .indexing import lex_compare, lex_find, lex_push, lex_sort, lin_to_multi, multi_to_lin
from .metrics import SweepRecord, history_from_run
from .printing import say, say_tt, saynnz

__all__ = [
    "assert_finite", "has_nan", "tt_check",
    "lex_compare", "lex_find", "lex_push", "lex_sort", "lin_to_multi", "multi_to_lin",
    "SweepRecord", "history_from_run",
    "say", "say_tt", "saynnz",
]
