"""MVN probability through the complex contraction on the card:
`python -m ttcross_tpu_torch.drivers.crs_mvn_complex D N RANK PIV`.

The counterpart of drivers/crs_mvn_complex.py (test_crs_mvn_complex.f90):
the MVN pdf crossed as in crs_mvn, then contracted against complex128
weights with a unit real part (the reference's dtt -> ztt promotion and
ztt_quad, test_crs_mvn_complex.f90:154-160), in complex128 on the card
(tt/ops.py::contract; the JAX package's (re, im) pairs are a TPU
workaround)."""

from __future__ import annotations

import sys


def main(argv=None, device="cuda") -> int:
    import numpy as np

    from ..apps import make_mvn
    from ..cross import cross
    from ..tt import contract
    from ..utils.cli import maybe_accchk, print_config, readarg

    d = readarg(1, 6, argv=argv)
    n = readarg(2, 65, argv=argv)
    rank = readarg(3, 20, argv=argv)
    piv = readarg(4, 1, argv=argv)

    prob = make_mvn(d=d, n=n, device=device)
    print_config(dimension=d, quadratur=prob.n, TT_ranks=rank, pivoting=piv)
    acc = 500 * np.finfo(np.float64).eps
    res = cross(prob.fun, [prob.n] * d, max_rank=rank, accuracy=acc, pivoting=piv,
                device=device)
    maybe_accchk(res, prob.fun)
    print(f"...with {res.neval} evaluations completed in {res.time:.4e} sec.")

    w_complex = [prob.quad_weights.astype(np.complex128) * (1.0 + 0.0j)] * d
    val = complex(contract(res.tt, w_complex))
    print(f"computed value: {val.real:.40e} {val.imag:.40e}")
    print(f"analytic value: {1.0:.40e}")
    print(f"correct digits: {-np.log10(abs(1 - val)):7.2f}")
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
