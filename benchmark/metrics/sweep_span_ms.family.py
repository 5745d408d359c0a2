"""sweep_span_ms.family: the mean wall time, in milliseconds, of the traced
call's engine.sweep spans: one sweep with its value and stop rule, timed by
the program (benchmark/spans.py), where sweep_ms.family times whole calls from
outside."""

from benchmark import spans


def read(run):
    s = spans.named(run.trace, "engine.sweep")
    return 1e3 * sum(sp.wall_s for sp in s) / len(s) if s else None
