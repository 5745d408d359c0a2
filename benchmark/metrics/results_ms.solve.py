"""results_ms.solve: milliseconds of the traced call in the program's
entry.results span: the solved cores, the host reads and the per-lane
results after the last sweep (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    s = spans.named(run.trace, "entry.results")
    return 1e3 * sum(sp.wall_s for sp in s) if s else None
