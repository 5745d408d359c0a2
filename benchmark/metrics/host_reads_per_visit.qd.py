"""host_reads_per_visit.qd: the qd engine's device-to-host reads over its
bond visits in the traced call: the host_reads attribute of the last
engine.sweep span (the engine's count, set-up included) over the sweeps
times the d - 1 bonds of the root cross_qd span (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    sweeps, roots = spans.named(run.trace, "engine.sweep"), spans.named(run.trace, "cross_qd")
    if not sweeps or not roots or "host_reads" not in sweeps[-1].attrs:
        return None
    bonds = int(roots[-1].attrs["d"]) - 1
    return sweeps[-1].attrs["host_reads"] / (len(sweeps) * bonds) if bonds > 0 else None
