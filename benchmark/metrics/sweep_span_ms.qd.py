"""sweep_span_ms.qd: the mean wall time, in milliseconds, of the traced
cross_qd call's engine.sweep spans: one sweep of the qd engine with its value
chain and stop rule, timed by the program (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    s = spans.named(run.trace, "engine.sweep")
    return 1e3 * sum(sp.wall_s for sp in s) / len(s) if s else None
