"""Table of COS coefficients over an index line:
`python -m ttcross_tpu_torch.drivers.print_cos_coeff D KMAX`.

The counterpart of drivers/print_cos_coeff.py (test_print_cos_coeff.f90, a
serial table for inspection): the coefficients of the equicorrelated
density's Gaussian CHF at the indices (0, ..., 0, k), k < KMAX, as one
(KMAX, D) index batch through the COS integrand on `device`."""

from __future__ import annotations

import sys


def main(argv=None, device="cuda") -> int:
    import torch

    from ..apps import make_cos_coefficients, make_mvn_density
    from ..utils.cli import readarg

    d = readarg(1, 4, argv=argv)
    kmax = readarg(2, 32, argv=argv)

    dens = make_mvn_density(d, device=device)
    cc = make_cos_coefficients(d, dens.mu, dens.cov, 0.52517, 8.52517, device=device)
    ind = torch.zeros((kmax, d), dtype=torch.int32, device=device)
    ind[:, -1] = torch.arange(kmax, device=device)     # grid 1 x 1 x ... x kmax
    vals = cc.fun(ind).cpu().numpy()
    for k, row in enumerate(ind.cpu().numpy()):
        print(f"  ind={tuple(int(x) for x in row)}  coeff={vals[k]: .16e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
