"""dd_score_roofline: D1 (dd_score_residual_argmax, the dd residual argmax of
the lottery, the rook passes and the accept) over the traced call: the sum
of its launches' bounds over the sum of its kernels' device time
(benchmark/roofline_dd.py)."""

from benchmark import roofline_dd


def read(run):
    return roofline_dd.share(run.trace, "dd_score") if run.trace is not None else None
