"""Product standard-normal integral on the card:
`python -m ttcross_tpu_torch.drivers.crs_stdnorm D N RANK PIV`.

The counterpart of drivers/crs_stdnorm.py (test_crs_stdnorm.f90): the
integral of exp(-|x|^2) over [-10, 10]^D, truth pi^(D/2), at accuracy
5 eps.  The integrand's node lookup is kernel B, the rook passes kernel A."""

from __future__ import annotations

import sys


def main(argv=None, device="cuda") -> int:
    import numpy as np

    from ..apps import make_stdnorm
    from ..cross import cross
    from ..utils.cli import maybe_accchk, print_config, readarg
    from ._digits import report_f64

    d = readarg(1, 6, argv=argv)
    n = readarg(2, 65, argv=argv)
    rank = readarg(3, 20, argv=argv)
    piv = readarg(4, 1, argv=argv)

    print("Hi, this is TT cross interpolation for computing integrals...")
    prob = make_stdnorm(d=d, n=n, device=device)
    print_config(dimension=d, quadratur=prob.n, TT_ranks=rank, pivoting=piv)
    acc = 5 * np.finfo(np.float64).eps
    res = cross(prob.fun, [prob.n] * d, max_rank=rank, accuracy=acc, pivoting=piv,
                quad=[prob.quad_weights] * d, truth=prob.truth, verbose=True, device=device)
    print(f"...with {res.neval} evaluations completed in {res.time:.4e} sec.")
    report_f64(res.values[-1], prob.truth)
    maybe_accchk(res, prob.fun)
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
