"""Basket-sum characteristic function on the card:
`python -m ttcross_tpu_torch.drivers.crs_chf D N RANK PIV`.

The counterpart of drivers/crs_chf.py (test_crs_chf.f90): the MVN pdf
crossed once, then 32 complex contractions against the Fourier weights
w(x) exp(i omega_k e^x / d), omega_k = k pi / 300, as one batched complex
chain (apps/chf.py::basket_chf); at D = 6 each is printed beside its
golden value (CHF_RHO05, regenerated at the source's parameters) and the
reference's stale table (CHF_REFERENCE).

TTCROSS_MESH=N is the JAX driver's switch (drivers/crs_chf.py:38-50) carried
across: there it builds an N-device mesh inside one process; here a mesh
rank is a process (parallel/mesh.py::bond_mesh), so the driver runs under

    torchrun --nproc-per-node N -m ttcross_tpu_torch.drivers.crs_chf ARGS

with TTCROSS_MESH=N in the environment.  Every rank joins the group from
torchrun's environment (NCCL on the cards, gloo with device="cpu"; a
group already initialized is used as it is), raises if the world size is
not N, runs the same cross on its own device, and contracts the 32 weight
tensors in one distributed pass (parallel/quad.py::pcontract); rank 0
prints."""

from __future__ import annotations

import contextlib
import io
import os
import sys


def _mesh(want: int, device):
    """The bond mesh of the TTCROSS_MESH=want run: joins torchrun's group
    unless one is initialized, and checks its size."""
    import torch.distributed as dist

    from ..parallel import bond_mesh

    if not dist.is_initialized():
        dist.init_process_group("gloo" if str(device) == "cpu" else "nccl")
    if dist.get_world_size() != want:
        raise RuntimeError(f"TTCROSS_MESH={want} but the process group has "
                           f"{dist.get_world_size()} ranks (run under torchrun "
                           f"--nproc-per-node {want})")
    return bond_mesh(device="cpu" if str(device) == "cpu" else None)


def main(argv=None, device="cuda") -> int:
    ndev_s = os.environ.get("TTCROSS_MESH", "")
    mesh = _mesh(int(ndev_s), device) if ndev_s else None
    quiet = mesh is not None and mesh.rank != 0
    with contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext():
        _run(argv, device if mesh is None else mesh.device, mesh)
    return 0


def _run(argv, device, mesh) -> None:
    import numpy as np

    from ..apps import CHF_REFERENCE, CHF_RHO05, basket_chf, make_mvn
    from ..cross import cross
    from ..parallel import pcontract
    from ..utils.cli import maybe_accchk, print_config, readarg

    d = readarg(1, 6, argv=argv)
    n = readarg(2, 65, argv=argv)
    rank = readarg(3, 20, argv=argv)
    piv = readarg(4, 1, argv=argv)

    prob = make_mvn(d=d, n=n, device=device)
    print_config(dimension=d, quadratur=prob.n, TT_ranks=rank, pivoting=piv)
    acc = 500 * np.finfo(np.float64).eps
    print("   Running TT-cross...")
    res = cross(prob.fun, [prob.n] * d, max_rank=rank, accuracy=acc, pivoting=piv,
                device=device)
    maybe_accchk(res, prob.fun)
    print(f"...with {res.neval} evaluations completed in {res.time:.4e} sec.")

    print("   Preparing quadrature tensor...")
    if mesh is not None:
        # the 32 Fourier contractions in one distributed pass
        # (test_crs_chf.f90:153-168 runs 32 ztt_quad calls)
        omega = np.arange(32) * np.pi / 300.0
        phase = omega[:, None] * np.exp(prob.nodes)[None, :] / d
        w_k = prob.quad_weights[None, :] * np.exp(1j * phase)
        phis = pcontract(res.tt, [w_k] * d, mesh)
    else:
        phis = basket_chf(res.tt, prob.nodes, prob.quad_weights, 32).cpu().numpy()
    for k in range(32):
        print(f"computed value: {phis[k].real:.16e} {phis[k].imag:.16e}")
        if d == 6:  # the goldens are d = 6 values (test_crs_chf.f90:232-271)
            ref, stale = CHF_RHO05[k], CHF_REFERENCE[k]
            print(f"golden  value: {ref.real:.16e} {ref.imag:.16e}")
            print(f"agreement digits: {-np.log10(abs(1 - phis[k] / ref)):7.2f}"
                  f"  (vs stale reference table: "
                  f"{-np.log10(abs(1 - phis[k] / stale)):5.2f})")
    print(f"phi_0 (mass) = {phis[0].real:.8f} (should be ~1)")
    print("Good bye.")


if __name__ == "__main__":
    sys.exit(main())
