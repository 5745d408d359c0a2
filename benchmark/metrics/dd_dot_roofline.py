"""dd_dot_roofline: D4 (dd_dot, the small dd GEMM of the accept, the solved
cores and the quadrature) in both regimes over the traced call: the sum of
its launches' bounds over the sum of its kernels' device time
(benchmark/roofline_dd.py)."""

from benchmark import roofline_dd


def read(run):
    return roofline_dd.share(run.trace, "dd_dot") if run.trace is not None else None
