"""ising_qd_roofline: Q1 (ising_c_integrand_qd_fused, the qd Ising
integrand) over the traced call: the sum of its launches' bounds over the
sum of its kernels' device time (benchmark/roofline_qd.py)."""

from benchmark import roofline_qd


def read(run):
    return roofline_qd.share(run.trace, "ising_qd") if run.trace is not None else None
