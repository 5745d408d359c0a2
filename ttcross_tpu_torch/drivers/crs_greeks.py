"""Parameter sensitivities (Greeks) of a cross integral on the card:
`python -m ttcross_tpu_torch.drivers.crs_greeks D N RANK [NRHO]`.

The counterpart of drivers/crs_greeks.py: the equicorrelated MVN mass is
crossed once at rho = 0.5 (key 5), its pivot skeleton frozen
(cross/skeleton.py), and the skeleton interpolant's value differentiated
in the correlation with torch.func.grad and swept over NRHO values of rho
with torch.func.vmap: no further pivot hunt, one batched integrand call
per parameter point, whose node lookup is kernel B.  The printed sanity
column is a central difference of the skeleton value (it matches the
gradient to ~1e-6)."""

from __future__ import annotations

import sys

__all__ = ["mvn_rho_fun", "main"]


def mvn_rho_fun(nodes, d, sigma=0.4, T=1.0):
    """The MVN pdf with the equicorrelation rho a differentiable parameter:
    the closed-form Sherman-Morrison inverse of cov = s2 ((1 - rho) I +
    rho 11^T), so autograd flows through the integrand.  nodes: the (n,)
    node tensor on the run's device.  The node lookup is kernel B: its
    inputs, the indices and the nodes, are free of rho, so it runs under
    torch.func.grad and once under torch.func.vmap over rho."""
    import numpy as np
    import torch

    from ..ops.dense import table_lookup

    s2 = sigma * sigma * T
    mu = float(np.log(100.0) - 0.5 * sigma * sigma * T)

    def fun(ind, rho):
        diff = table_lookup(nodes, ind) - mu
        denom = 1.0 + (d - 1.0) * rho
        q = ((diff * diff).sum(dim=1) - rho / denom * diff.sum(dim=1) ** 2) / (s2 * (1.0 - rho))
        det = (s2 ** d) * ((1.0 - rho) ** (d - 1)) * denom
        return torch.exp(-0.5 * q) / torch.sqrt((2.0 * np.pi) ** d * det)

    return fun


def main(argv=None, device="cuda") -> int:
    import numpy as np
    import torch

    from ..apps.mvn import MVN_BOX
    from ..cross import cross, extract_skeleton, skeleton_value_fn
    from ..ops.quadrature import lgwt, map_to_interval
    from ..utils.cli import print_config, readarg

    d = readarg(1, 6, argv=argv)
    n = readarg(2, 65, argv=argv)
    rank = readarg(3, 14, argv=argv)
    nrho = readarg(4, 5, argv=argv)
    rho0 = 0.5

    x, w = map_to_interval(*lgwt(n), *MVN_BOX)
    fun = mvn_rho_fun(torch.from_numpy(x).to(device), d)
    print_config(dimension=d, quadratur=n, TT_ranks=rank, rho0=rho0)

    def f64(v):
        return torch.tensor(v, dtype=torch.float64, device=device)

    acc = 500 * np.finfo(np.float64).eps
    r0 = f64(rho0)
    res = cross(lambda i: fun(i, r0), [n] * d, max_rank=rank, accuracy=acc, pivoting=1,
                quad=[w] * d, truth=1.0, key=5, verbose=True, return_state=True, device=device)
    skel = extract_skeleton(res, [n] * d, device=device)
    vfn = skeleton_value_fn(fun, skel, weights=[w] * d)

    v0 = float(vfn(r0))
    g = float(torch.func.grad(vfn)(r0))
    h = 1e-5
    fd = (float(vfn(f64(rho0 + h))) - float(vfn(f64(rho0 - h)))) / (2 * h)
    print(f"mass({rho0}) = {v0:.12e}   (cross value {res.values[-1]:.12e}, "
          f"{skel.n_samples} skeleton samples)")
    print(f"d mass / d rho = {g:.10e}   central-FD check {fd:.10e}")

    rhos = torch.linspace(0.3, 0.7, nrho, dtype=torch.float64, device=device)
    masses = torch.func.vmap(vfn)(rhos)
    greeks = torch.func.vmap(torch.func.grad(vfn))(rhos)
    print("frozen-skeleton rho sweep (vmap, one device call):")
    for r, m, gg in zip(rhos.tolist(), masses.tolist(), greeks.tolist()):
        print(f"  rho {r:.3f}: mass {m:.10e}  d/drho {gg:+.6e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
