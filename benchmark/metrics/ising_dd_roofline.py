"""ising_dd_roofline: D2 (ising_c_integrand_dd_fused, the dd Ising
integrand) over the traced call: the sum of its launches' bounds over the
sum of its kernels' device time (benchmark/roofline_dd.py)."""

from benchmark import roofline_dd


def read(run):
    return roofline_dd.share(run.trace, "ising_dd") if run.trace is not None else None
