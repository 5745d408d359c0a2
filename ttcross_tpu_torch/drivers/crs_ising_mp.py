"""High-precision Ising C_m with the double-double engine on the card:
`python -m ttcross_tpu_torch.drivers.crs_ising_mp INDEX N RANK`.

The counterpart of drivers/crs_ising_mp.py: despite its name the dd
engine (cross/engine_dd.py, the mptt_dmrgg analogue in dd arithmetic):
every fiber, factor and residual hunt runs in dd, through D1 (the residual
argmax), D2 (the Ising integrand) and D4 (the dd products)."""

from __future__ import annotations

import sys
from decimal import Decimal, localcontext


def main(argv=None, device="cuda") -> int:
    from ..apps import ISING_C_STR, make_ising_dd
    from ..cross import cross_dd
    from ..utils.cli import print_config, readarg
    from ._digits import report

    m = readarg(1, 4, argv=argv)
    n = readarg(2, 65, argv=argv)
    rank = readarg(3, 32, argv=argv)

    prob, fun_dd, wh, wl = make_ising_dd(m=m, n=n, device=device)
    print_config(integral=f"C_{m}", quadratur=prob.n, TT_ranks=rank,
                 tier="double-double engine")
    res = cross_dd(fun_dd, [prob.n] * prob.d, wh, wl, max_rank=rank, pivoting=1, verbose=True,
                   device=device)
    with localcontext() as ctx:
        ctx.prec = 60
        got = Decimal(res.value[0]) + Decimal(res.value[1])
    print(f"...with {res.neval} dd evaluations, ranks {res.ranks}")
    report(got, ISING_C_STR.get(m), 60, 60)
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
