"""Extended-precision product Gaussian: `python -m
ttcross_tpu_torch.drivers.crs_stdnorm_dd D N RANK`.

The counterpart of drivers/crs_stdnorm_dd.py: an f64 cross on the card
(kernel A, kernel B), then the cross data and the quadrature re-evaluated
in dd with a dd Gauss-Legendre rule (cross/refine.py::refine_dd).  The JAX
driver takes its dd rule and its __float128 integrand from its native
library; this one uses the port's own dd rule (ops/quadrature.py) and dd
integrand (apps/stdnorm.py::StdnormDD) on the card.  For the rank-exact
product Gaussian this reaches ~30 correct digits against pi^(D/2)."""

from __future__ import annotations

import sys
from decimal import Decimal, localcontext

PI_STR = "3.14159265358979323846264338327950288419716939937510582097494"


def main(argv=None, device="cuda") -> int:
    import numpy as np
    import torch

    from ..apps import make_stdnorm
    from ..apps.stdnorm import StdnormDD
    from ..cross import cross, refine_dd
    from ..ops.dd import DD, dd, dd_mul
    from ..ops.quadrature import gauss_legendre_dd
    from ..utils.cli import print_config, readarg
    from ._digits import digits_of

    d = readarg(1, 4, argv=argv)
    n = readarg(2, 101, argv=argv)
    rank = readarg(3, 4, argv=argv)
    if n % 2 == 0:
        n += 1

    print_config(dimension=d, quadratur=n, TT_ranks=rank, tier="double-double")
    scale = 8.5
    (xh, xl), (wh, wl) = gauss_legendre_dd(n)
    X = dd_mul(DD(torch.from_numpy(xh), torch.from_numpy(xl)), dd(scale))
    W = dd_mul(DD(torch.from_numpy(wh), torch.from_numpy(wl)), dd(scale))

    prob = make_stdnorm(d=d, n=n, a=-scale, b=scale, device=device)
    res = cross(prob.fun, [n] * d, max_rank=rank, pivoting=1, accuracy=25e-16,
                return_state=True, device=device)
    print(f"cross: {res.neval} evaluations, ranks {res.ranks}")
    hi, lo, nev = refine_dd(res.state, [n] * d, StdnormDD(X, device), [np.asarray(W.hi)] * d,
                            [np.asarray(W.lo)] * d, device=device)
    with localcontext() as ctx:
        ctx.prec = 60
        tru = Decimal(PI_STR) ** (Decimal(d) / 2)
        got = Decimal(hi) + Decimal(lo)
    digits = digits_of(got, str(tru), 60)
    print(f"refined value : {got}")
    print(f"analytic value: {tru}")
    print(f"correct digits: {digits:7.2f}   (+{nev} extended-precision evals)")
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
