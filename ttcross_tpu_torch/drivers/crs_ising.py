"""Ising susceptibility integrals by TT-cross on the card:
`python -m ttcross_tpu_torch.drivers.crs_ising KIND INDEX N RANK PIV`.

The counterpart of drivers/crs_ising.py (test_crs_ising.f90): KIND in
{C, D, E}, INDEX = m of C_m / D_m / E_m, N the quadrature size (made odd),
RANK the maximum TT rank, PIV the pivoting (-1 full / 0 lottery / k rook).
The sequential cross(), as the JAX driver runs it: kernel A scores every
rook pass and every integrand call is one fused launch.  D and E at
m >= 10 rescale their weights against underflow (apps/ising.py::
make_ising, test_crs_ising.f90:135-144) and have no truth, so the driver
prints the per-sweep convergence and no digits, as the JAX driver does."""

from __future__ import annotations

import sys


def main(argv=None, device="cuda") -> int:
    import numpy as np

    from ..apps import make_ising
    from ..cross import cross
    from ..utils.cli import maybe_accchk, print_config, readarg
    from ._digits import report_f64

    kind = readarg(1, "c", argv=argv)
    m = readarg(2, 6, argv=argv)
    n = readarg(3, 65, argv=argv)
    rank = readarg(4, 20, argv=argv)
    piv = readarg(5, 1, argv=argv)

    print("Hi, this is TT cross interpolation computing Ising integral...")
    prob = make_ising(kind, m=m, n=n, device=device)
    print_config(integral=kind.upper(), dimension=m, quadratur=prob.n, TT_ranks=rank,
                 pivoting=piv)
    acc = 500 * np.finfo(np.float64).eps
    res = cross(prob.fun, [prob.n] * prob.d, max_rank=rank, accuracy=acc, pivoting=piv,
                quad=[prob.quad_weights] * prob.d, truth=prob.truth, verbose=True, device=device)
    print(f"...with {res.neval} evaluations completed in {res.time:.4e} sec.")
    report_f64(res.values[-1], prob.truth)
    maybe_accchk(res, prob.fun)
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
