"""qd_dot_roofline: Q4 (qd_dot, the small qd product) in all three regimes
over the traced call: the sum of its launches' bounds over the sum of its
kernels' device time (benchmark/roofline_qd.py)."""

from benchmark import roofline_qd


def read(run):
    return roofline_qd.share(run.trace, "qd_dot") if run.trace is not None else None
