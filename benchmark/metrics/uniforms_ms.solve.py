"""uniforms_ms.solve: milliseconds of the traced call in the program's
entry.uniforms span: the lottery uniforms drawn on the host and copied to
the device (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    s = spans.named(run.trace, "entry.uniforms")
    return 1e3 * sum(sp.wall_s for sp in s) if s else None
