"""MVN probability mass by TT-cross on the card:
`python -m ttcross_tpu_torch.drivers.crs_mvn D N RANK PIV`.

The counterpart of drivers/crs_mvn.py (test_crs_mvn.f90): the
equicorrelated lognormal-model pdf on the cumulant box, truth 1; the mean
and the covariance are printed for D < 10.  The integrand is one fused
launch a call (mvn_pdf_fused), the rook passes kernel A."""

from __future__ import annotations

import sys


def main(argv=None, device="cuda") -> int:
    import numpy as np

    from ..apps import make_mvn
    from ..cross import cross
    from ..utils.cli import maybe_accchk, print_config, readarg
    from ._digits import report_f64

    d = readarg(1, 6, argv=argv)
    n = readarg(2, 65, argv=argv)
    rank = readarg(3, 20, argv=argv)
    piv = readarg(4, 1, argv=argv)

    print("Hi, this is TT cross interpolation for computing integrals...")
    prob = make_mvn(d=d, n=n, device=device)
    print_config(dimension=d, quadratur=prob.n, TT_ranks=rank, pivoting=piv)
    if d < 10:
        print("Mean vector (mu):")
        print(prob.density.mu)
        print("Covariance matrix:")
        print(prob.density.cov)
    acc = 500 * np.finfo(np.float64).eps
    res = cross(prob.fun, [prob.n] * d, max_rank=rank, accuracy=acc, pivoting=piv,
                quad=[prob.quad_weights] * d, truth=1.0, verbose=True, device=device)
    print(f"...with {res.neval} evaluations completed in {res.time:.4e} sec.")
    report_f64(res.values[-1], 1.0)
    maybe_accchk(res, prob.fun)
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
