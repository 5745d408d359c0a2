"""Very-high-precision Ising C_m with the quad-double engine on the card:
`python -m ttcross_tpu_torch.drivers.crs_ising_qde INDEX N RANK PIV WORKERS`.

The counterpart of drivers/crs_ising_qde.py: the whole cross (fibers,
factors, residual hunts, bordered inverses, quadrature) runs in quad-double
arithmetic (cross/engine_qd.py) through Q1 (the Ising integrand), Q2 (the
residual argmax) and Q4 (the qd products).  WORKERS > 1 runs the
bond-slab-distributed qd cross over spawned worker processes
(parallel/engine_qd.py, the qd rendering of mptt_dmrgg's MPI mode).  The
JAX driver forces its CPU platform; the card's f64 is IEEE binary64.
Measured by the JAX package: C_4 n = 65 rank 55 gives 64.2 digits."""

from __future__ import annotations

import sys


def main(argv=None, device="cuda") -> int:
    from ..apps import ISING_C_STR, make_ising_qd
    from ..cross import cross_qd
    from ..ops.qd import qd_to_mp, qd_to_string
    from ..parallel import cross_qd_parallel
    from ..utils.cli import print_config, readarg
    from ._digits import digits_of

    m = readarg(1, 4, argv=argv)
    n = readarg(2, 65, argv=argv)
    rank = readarg(3, 33, argv=argv)
    piv = readarg(4, 1, argv=argv)
    workers = readarg(5, 1, argv=argv)

    prob, fun_qd, wq = make_ising_qd(m=m, n=n, device=device)
    print_config(integral=f"C_{m}", quadratur=prob.n, TT_ranks=rank, tier="quad-double engine",
                 workers=workers)
    kw = dict(max_rank=rank, pivoting=piv, quad=wq, truth=ISING_C_STR.get(m), verbose=True,
              device=device)
    if workers > 1:
        res = cross_qd_parallel(fun_qd, [prob.n] * prob.d, n_workers=workers, **kw)
    else:
        res = cross_qd(fun_qd, [prob.n] * prob.d, **kw)
    print(f"computed value: {qd_to_string(res.value, 65)}")
    print(f"...with {res.neval} qd evaluations, ranks {res.ranks}")
    if m in ISING_C_STR:
        digits = digits_of(qd_to_mp(*(float(e) for e in res.value)), ISING_C_STR[m], 80)
        print(f"analytic value: {ISING_C_STR[m][:67]}")
        print(f"correct digits: {digits:7.2f}")
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
