"""Arbitrary-precision Ising integrals with the mpmath cross engine:
`python -m ttcross_tpu_torch.drivers.crs_ising_mpf KIND INDEX N RANK DPS WORKERS`.

The counterpart of drivers/crs_ising_mpf.py (the test_mpf_ising role,
cross/engine_mp.py = the mptt_dmrgg analogue, dmrggmp.f90:11-704).  Host
code by design, like the reference's MPFUN-MPFR tier and the JAX
package's mp tier: no device.  Defaults to the reference's 120 decimal
digits (mpipl, mpfunf.f90:63).  WORKERS > 1 runs the bond-slab
distributed mp engine (parallel/engine_mp.py) over spawned worker
processes."""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from mpmath import mp

    from ..apps import ising_truth_mp, make_ising_mp
    from ..cross import cross_mp
    from ..ops.mp import workdps
    from ..parallel import cross_mp_parallel
    from ..utils.cli import print_config, readarg

    kind = readarg(1, "C", argv=argv)
    m = readarg(2, 4, argv=argv)
    n = readarg(3, 65, argv=argv)
    rank = readarg(4, 48, argv=argv)
    dps = readarg(5, 120, argv=argv)
    workers = readarg(6, 1, argv=argv)

    d, n, fun_mp, quad_w, truth = make_ising_mp(kind, m=m, n=n, dps=dps)
    print_config(integral=f"{kind}_{m}", quadratur=n, TT_ranks=rank,
                 precision=f"{dps} decimal digits (mpmath)", workers=workers)
    kw = dict(max_rank=rank, pivoting=1, quad=quad_w, truth=truth, dps=dps, verbose=True)
    if workers > 1:
        res = cross_mp_parallel(fun_mp, [n] * d, n_workers=workers, **kw)
    else:
        res = cross_mp(fun_mp, [n] * d, **kw)
    with workdps(dps):
        print(f"computed value: {mp.nstr(res.value, dps)}")
        print(f"...with {res.neval} mp evaluations, ranks {res.ranks}")
        tru = ising_truth_mp(kind, m, dps)
        rel = abs(1 - res.value / tru)
        digits = float(-mp.log10(rel)) if rel != 0 else float(dps)
        print(f"analytic value: {mp.nstr(tru, dps)}")
        print(f"correct digits: {digits:7.2f}")
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
