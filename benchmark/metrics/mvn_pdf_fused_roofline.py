"""mvn_pdf_fused_roofline: the fused MVN integrand (mvn_pdf_fused) over the
traced call: the sum of its launches' bounds over the sum of its kernels'
device time (benchmark/roofline.py)."""

from benchmark import roofline


def read(run):
    return roofline.share(run.trace, "mvn_pdf_fused") if run.trace is not None else None
