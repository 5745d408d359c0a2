"""qd_score_roofline: Q2 (qd_score_residual_argmax, the qd residual argmax)
over the traced call: the sum of its launches' bounds over the sum of its
kernels' device time (benchmark/roofline_qd.py)."""

from benchmark import roofline_qd


def read(run):
    return roofline_qd.share(run.trace, "qd_score") if run.trace is not None else None
