"""Utilities of the port."""

from .cli import print_config, readarg
from .guards import assert_finite, has_nan, tt_check
from .indexing import lex_compare, lex_find, lex_push, lex_sort, lin_to_multi, multi_to_lin
from .metrics import SweepRecord, Timer, history_from_run, profile_trace, write_jsonl
from .printing import say, say_tt, saynnz

__all__ = [
    "print_config", "readarg",
    "assert_finite", "has_nan", "tt_check",
    "lex_compare", "lex_find", "lex_push", "lex_sort", "lin_to_multi", "multi_to_lin",
    "SweepRecord", "Timer", "history_from_run", "profile_trace", "write_jsonl",
    "say", "say_tt", "saynnz",
]
