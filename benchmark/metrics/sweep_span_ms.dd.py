"""sweep_span_ms.dd: the mean wall time, in milliseconds, of the traced
cross_dd call's engine.sweep spans: one sweep of the dd engine with its bond
visits and the stop rule's read, timed by the program (benchmark/spans.py).
A program that records no spans in cross_dd gives None."""

from benchmark import spans


def read(run):
    s = spans.named(run.trace, "engine.sweep")
    return 1e3 * sum(sp.wall_s for sp in s) / len(s) if s else None
