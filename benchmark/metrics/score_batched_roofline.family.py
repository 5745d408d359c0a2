"""score_batched_roofline.family: the batched kernel A
(score_residual_argmax_batched) over the traced call: the sum of its
launches' bounds over the sum of its kernels' device time (benchmark/roofline.py)."""

from benchmark import roofline


def read(run):
    return roofline.share(run.trace, "score_batched") if run.trace is not None else None
