"""table_lookup_roofline: kernel B (small_table_lookup, the chain
evaluator's lift) over the traced call: the sum of its launches' bounds over
the sum of its kernels' device time (benchmark/roofline.py)."""

from benchmark import roofline


def read(run):
    return roofline.share(run.trace, "table_lookup") if run.trace is not None else None
