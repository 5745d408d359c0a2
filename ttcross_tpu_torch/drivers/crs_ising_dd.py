"""High-precision Ising C_m by defect-corrected cross on the card:
`python -m ttcross_tpu_torch.drivers.crs_ising_dd INDEX N RANK1 RANK2`.

The counterpart of drivers/crs_ising_dd.py (the reference's test_mpf_ising
role): both crosses run in the f64 engine (kernel A and the fused
integrand); the second one crosses the defect A_dd - TT1, evaluated in dd
arithmetic (D2 + D3), and the quadratures contract in dd (D4).  The JAX
driver needs its native library for the dd rule; the port's rule is its
own (ops/quadrature.py)."""

from __future__ import annotations

import sys
from decimal import Decimal, localcontext


def main(argv=None, device="cuda") -> int:
    from ..apps import ISING_C_STR, make_ising_dd
    from ..cross import cross_defect_corrected
    from ..utils.cli import print_config, readarg
    from ._digits import report

    m = readarg(1, 6, argv=argv)
    n = readarg(2, 65, argv=argv)
    r1 = readarg(3, 32, argv=argv)
    r2 = readarg(4, 48, argv=argv)

    prob, fun_dd, wh, wl = make_ising_dd(m=m, n=n, device=device)
    print_config(integral=f"C_{m}", quadratur=prob.n, rank1=r1, rank2=r2,
                 tier="defect-corrected dd")
    hi, lo, info = cross_defect_corrected(prob.fun, fun_dd, [prob.n] * prob.d, wh, wl,
                                          max_rank=r1, max_rank2=r2, device=device)
    with localcontext() as ctx:
        ctx.prec = 60
        got = Decimal(hi) + Decimal(lo)
    print(f"evaluations   : {info['neval1']} + {info['neval2']} (defect)")
    report(got, ISING_C_STR.get(m), 60, 60)
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
