"""sweep_idle_pct.solve: the share of the traced call's engine.sweep spans,
summed, in which no op ran on the device (benchmark/spans.py): the host's
part of a sweep, which a graphed sweep would take away."""

from benchmark import spans


def read(run):
    s = spans.named(run.trace, "engine.sweep")
    wall = sum(sp.wall_s for sp in s) if s else 0.0
    return 100.0 * sum(sp.idle_s for sp in s) / wall if wall > 0 else None
