"""Batched parameter-family cross on the card:
`python -m ttcross_tpu_torch.drivers.crs_batch D N RANK LANES [COMPARE]`.

The counterpart of drivers/crs_batch.py: an MVN correlation family (corr
linspace(0.2, 0.7, LANES), every lane's mass 1) crossed in one
cross_batch, the lanes' steps as one (kernel A batched over the lanes,
kernel B once for every lane's integrand batch), in place of one run of
the reference binary per `par` value (fun(m, ind, n, par), dmrgg.f90:18).
With COMPARE=1 it also times the batch and each lane's single cross(),
steady (second calls), every wall ending in a synchronize of the card,
and prints the family's speedup."""

from __future__ import annotations

import sys
import time


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, device="cuda") -> int:
    import numpy as np

    from ..apps import make_mvn_family
    from ..cross import cross, cross_batch
    from ..utils.cli import print_config, readarg

    d = readarg(1, 6, argv=argv)
    n = readarg(2, 65, argv=argv)
    rank = readarg(3, 14, argv=argv)
    lanes = readarg(4, 4, argv=argv)
    compare = readarg(5, 0, argv=argv)

    corrs = np.linspace(0.2, 0.7, lanes)
    fam = make_mvn_family(d=d, n=n, corrs=corrs, device=device)
    print_config(dimension=d, quadratur=fam.n, TT_ranks=rank, lanes=lanes,
                 correlations=np.round(corrs, 3).tolist())
    acc = 500 * np.finfo(np.float64).eps
    kw = dict(max_rank=rank, accuracy=acc, pivoting=1, quad=[fam.quad_weights] * d, truth=1.0,
              device=device)

    res = cross_batch(fam.fun, [fam.n] * d, fam.params, verbose=True, **kw)
    print(f"family: {lanes} lanes, {res.neval} evaluations, "
          f"{res.time:.4e} sec total ({res.time / lanes:.4e} per lane)")
    for lane, r in enumerate(res):
        digits = -np.log10(abs(1.0 - r.values[-1]))
        print(f"  corr {corrs[lane]:.3f}: value {r.values[-1]:.12e} "
              f"correct digits {digits:6.2f} ranks {r.ranks}")

    if compare:
        # steady walls: the batch again, and each lane's single run twice,
        # timing the second
        t0 = time.perf_counter()
        cross_batch(fam.fun, [fam.n] * d, fam.params, **kw)
        _sync(device)
        batch_wall = time.perf_counter() - t0
        singles = 0.0
        for lane in range(lanes):
            par = fam.lane(lane)

            def fun1(ind, par=par):
                return fam.fun(ind, par)

            cross(fun1, [fam.n] * d, **kw)
            _sync(device)
            t0 = time.perf_counter()
            cross(fun1, [fam.n] * d, **kw)
            _sync(device)
            singles += time.perf_counter() - t0
        print(f"steady wall: batch {batch_wall:.3f} s vs {lanes} single runs "
              f"{singles:.3f} s -> family speedup {singles / batch_wall:.2f}x")
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
