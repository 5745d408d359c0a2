"""crs_pdf with persistence, on the card:
`python -m ttcross_tpu_torch.drivers.crs_store D N RANK PIV`.

The counterpart of drivers/crs_store.py (test_crs_store.f90): the MVN pdf
crossed once; the train saved to out/tensor_train.h5 in the reference's
HDF5 schema (skipped with a line when h5py is absent) and to the binary
stream format out/tensor_train.ttx (tt/serialize.py); the density written
to out/tt-cross-pdf.txt as crs_pdf writes it."""

from __future__ import annotations

import sys


def main(argv=None, device="cuda") -> int:
    import os

    import numpy as np

    from ..apps import make_mvn
    from ..cross import cross
    from ..tt.serialize import save_hdf5, save_ttbin
    from ..utils.cli import maybe_accchk, print_config, readarg
    from .crs_pdf import PDF_PATH, write_pdf

    d = readarg(1, 6, argv=argv)
    n = readarg(2, 65, argv=argv)
    rank = readarg(3, 20, argv=argv)
    piv = readarg(4, 1, argv=argv)

    prob = make_mvn(d=d, n=n, device=device)
    print_config(dimension=d, quadratur=prob.n, TT_ranks=rank, pivoting=piv)
    acc = 500 * np.finfo(np.float64).eps
    res = cross(prob.fun, [prob.n] * d, max_rank=rank, accuracy=acc, pivoting=piv,
                device=device)
    maybe_accchk(res, prob.fun)
    print(f"...with {res.neval} evaluations completed in {res.time:.4e} sec.")

    os.makedirs("out", exist_ok=True)
    try:
        save_hdf5(res.tt, "out/tensor_train.h5")
        print("wrote out/tensor_train.h5")
    except ImportError:
        print("(h5py unavailable; skipping HDF5)")
    save_ttbin(res.tt, "out/tensor_train.ttx")
    print("wrote out/tensor_train.ttx")
    write_pdf(res.tt, prob)
    print(f"wrote {PDF_PATH}")
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
