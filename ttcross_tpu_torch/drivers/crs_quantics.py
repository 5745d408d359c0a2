"""Quantics TT-cross on the card:
`python -m ttcross_tpu_torch.drivers.crs_quantics K RANK PIV REFINE`.

The counterpart of drivers/crs_quantics.py: f(x) = exp(x) sin(6 pi x) on a
virtual 2^K grid (K binary modes, the exponential-grid regime that
dtt_value serves in the reference, tt.f90:702-728), crossed by
apps/quantics.py::quantics_cross with REFINE maxvol sweeps (one removes
the greedy pivots' conditioning plateau, ~4e-7 at K = 20).  Prints the
Riemann sum against its closed form (a geometric sum over the dyadic grid)
and the largest point error on a 64-point dyadic probe.  The rook passes
run kernel A."""

from __future__ import annotations

import sys


def main(argv=None, device="cuda") -> int:
    import numpy as np
    import torch

    from ..apps import quantics_cross
    from ..utils.cli import print_config, readarg

    K = readarg(1, 20, argv=argv)
    rank = readarg(2, 10, argv=argv)
    piv = readarg(3, 1, argv=argv)
    refine = readarg(4, 1, argv=argv)

    print("Hi, this is quantics TT cross interpolation...")
    print_config(bits=K, virtual_grid=f"2^{K} = {2 ** K}", TT_ranks=rank, pivoting=piv,
                 refine_sweeps=refine)

    def f(x):
        return torch.exp(x) * torch.sin(6 * np.pi * x)

    prob, res = quantics_cross(f, K, max_rank=rank, pivoting=piv, accuracy=1e-13,
                               refine_sweeps=refine, verbose=True, device=device)
    # the exact left-Riemann sum of exp(x) sin(6 pi x): the geometric sum of
    # exp((1 + 6 pi i) x) over the dyadic grid
    h = 2.0 ** -K
    z = complex(1.0, 6 * np.pi)
    tru = (h * (np.exp(z) - 1.0) / (np.exp(z * h) - 1.0)).imag
    val = res.values[-1]
    err = abs(1.0 - val / tru)
    print(f"...with {res.neval} evaluations "
          f"(of {2 ** K} virtual grid points) in {res.time:.4e} sec.")
    print(f"computed value: {val:.15e}")
    print(f"analytic value: {tru:.15e}")
    print(f"correct digits: {-np.log10(err) if err > 0 else 16.0:7.2f}")

    xs = torch.arange(64, dtype=torch.float64, device=device) / 64.0
    e_pt = float((prob.value(res.tt, xs[:, None]) - f(xs)).abs().max())
    print(f"max point-eval error on the 64-point dyadic probe: {e_pt:.2e}")
    print(f"TT ranks: {res.ranks}")
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
