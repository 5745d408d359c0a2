"""Very-high-precision Ising C_m by three-level qd defect-corrected cross on
the card: `python -m ttcross_tpu_torch.drivers.crs_ising_qd INDEX N RANK1
RANK2 LEVELS`.

The counterpart of drivers/crs_ising_qd.py: every cross runs in the f64
engine (kernel A, the fused integrand); the correction levels cross the
defect A_qd - sum TT_i evaluated in quad-double arithmetic (Q1 + Q3), and
the quadratures contract in qd (Q4).  The JAX driver forces its CPU
platform, since a TPU's emulated f64 breaks the qd arithmetic; the card's
f64 is IEEE binary64, so this one runs on the card.  Measured by the JAX
package on C_4 (n = 33, 3 levels): 33.7 digits at rank2 = 33 (full)."""

from __future__ import annotations

import sys


def main(argv=None, device="cuda") -> int:
    from ..apps import ISING_C_STR, make_ising_qd
    from ..cross import cross_defect_corrected_qd
    from ..ops.qd import qd_to_mp
    from ..utils.cli import print_config, readarg
    from ._digits import report

    m = readarg(1, 4, argv=argv)
    n = readarg(2, 33, argv=argv)
    r1 = readarg(3, 16, argv=argv)
    r2 = readarg(4, 33, argv=argv)   # full rank for the default n = 33
    levels = readarg(5, 3, argv=argv)

    prob, fun_qd, wq = make_ising_qd(m=m, n=n, device=device)
    print_config(integral=f"C_{m}", quadratur=prob.n, rank1=r1, rank2=r2, levels=levels,
                 tier="defect-corrected qd")
    limbs, info = cross_defect_corrected_qd(prob.fun, fun_qd, [prob.n] * prob.d, wq,
                                            max_rank=r1, max_rank2=r2, levels=levels,
                                            device=device)
    print(f"evaluations   : {info['nevals']}")
    report(qd_to_mp(*(float(e) for e in limbs)), ISING_C_STR.get(m), 80, 60)
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
