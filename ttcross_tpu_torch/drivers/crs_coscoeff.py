"""Cross the COS coefficient tensor on the card:
`python -m ttcross_tpu_torch.drivers.crs_coscoeff D N RANK PIV CORR`.

The counterpart of drivers/crs_coscoeff.py (test_crs_coscoeff.f90): the
black box is the D-dimensional COS coefficient of a Gaussian CHF
(apps/cos.py, a (B, 2^(D-1), D) sweep per integrand call); the train is
saved to out/coeff-tt-<D>-<N>-10-<CORR>.h5 (skipped with a line when h5py
is absent).  The rook passes run kernel A."""

from __future__ import annotations

import sys


def main(argv=None, device="cuda") -> int:
    import os

    import numpy as np

    from ..apps import make_cos_coefficients, make_mvn_density
    from ..cross import cross
    from ..tt.serialize import save_hdf5
    from ..utils.cli import maybe_accchk, print_config, readarg

    d = readarg(1, 6, argv=argv)
    n = readarg(2, 65, argv=argv)
    rank = readarg(3, 20, argv=argv)
    piv = readarg(4, 1, argv=argv)
    corr = readarg(5, 0.5, argv=argv)

    dens = make_mvn_density(d, corr=corr, device=device)
    cc = make_cos_coefficients(d, dens.mu, dens.cov, 0.52517, 8.52517, device=device)
    print_config(dimension=d, modes=n, TT_ranks=rank, pivoting=piv, corr=corr)
    acc = 500 * np.finfo(np.float64).eps
    res = cross(cc.fun, [n] * d, max_rank=rank, accuracy=acc, pivoting=piv, verbose=True,
                device=device)
    maybe_accchk(res, cc.fun)
    print(f"...with {res.neval} evaluations completed in {res.time:.4e} sec.")

    os.makedirs("out", exist_ok=True)
    path = f"out/coeff-tt-{d}-{n}-10-{corr}.h5"
    try:
        save_hdf5(res.tt, path)
        print(f"wrote {path}")
    except ImportError:
        print("(h5py unavailable; skipping HDF5)")
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
