"""Ising C/D/E at arbitrary precision with the native MPFR engine:
`python -m ttcross_tpu_torch.drivers.crs_ising_mpn KIND INDEX N RANK PIV DPS`.

The counterpart of drivers/crs_ising_mpn.py: the reference's MPFUN-MPFR
tier at compiled speed, played by the port's copy of the engine
(csrc/mpfr_cross.cpp, built with g++ at first use).  Host code by design,
like the whole mp tier: no device.  Measured by the JAX package: C_4 n = 33
rank 16 dps 120 gives 20 digits in ~0.1 s."""

from __future__ import annotations

import sys
import time


def main(argv=None) -> int:
    from .. import native
    from ..cross import ising_cross_mp_native
    from ..utils.cli import print_config, readarg

    kind = str(readarg(1, "C", argv=argv)).upper()
    m = readarg(2, 4, argv=argv)
    n = readarg(3, 33, argv=argv)
    rank = readarg(4, 16, argv=argv)
    piv = readarg(5, 1, argv=argv)
    dps = readarg(6, 120, argv=argv)
    if not native.mpfr_available():
        print("native MPFR engine unavailable (needs g++ + libmpfr.so.6); "
              "use crs_ising_mpf (mpmath) instead")
        return 1

    print("Hi, this is NATIVE-MPFR TT cross interpolation...")
    print_config(integral=f"{kind}_{m}", quadratur=n, TT_ranks=rank, pivoting=piv,
                 decimal_digits=dps)
    t0 = time.time()
    res = ising_cross_mp_native(kind, m=m, n=n, max_rank=rank, pivoting=piv, dps=dps)
    el = time.time() - t0
    for h in res.history:
        line = f"{h['it']:3d}  log10|pivot| {h['pivotmax_log10']:8.2f}"
        if h["err_log10"] is not None:
            line += f"  log10 err {h['err_log10']:8.2f}"
        print(line)
    print(f"...with {res.neval} evaluations completed in {el:.4e} sec.")
    print(f"computed value: {res.value_str[:dps // 2 + 8]}")
    if res.digits is not None:
        print(f"correct digits: {res.digits:7.2f}")
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
