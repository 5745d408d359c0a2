"""Basket-sum density by TT-cross and COS on the card:
`python -m ttcross_tpu_torch.drivers.crs_pdf D N RANK PIV`.

The counterpart of drivers/crs_pdf.py (test_crs_pdf.f90): the MVN pdf
crossed once, 32 CHF values by one batched complex chain, the density
reconstructed on 200 points of [0, 300] (apps/chf.py::basket_pdf) and
written to out/tt-cross-pdf.txt under the working directory.  The plot
(plot_ttcross_data.plot_pdf, host code needing matplotlib) is optional:
any failure of it prints a line and the run goes on, as in the JAX
driver."""

from __future__ import annotations

import sys

PDF_PATH = "out/tt-cross-pdf.txt"


def write_pdf(tt, prob, path: str = PDF_PATH) -> None:
    """The density on linspace(0, 300, 200) as "x pdf" lines."""
    import os

    import numpy as np

    from ..apps import basket_pdf

    xs = np.linspace(0.0, 300.0, 200)
    pdf = basket_pdf(tt, prob.nodes, prob.quad_weights, xs, n_terms=32).cpu().numpy()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for x, y in zip(xs, pdf):
            f.write(f"{x:.10e} {y:.10e}\n")


def main(argv=None, device="cuda") -> int:
    import numpy as np

    from ..apps import make_mvn
    from ..cross import cross
    from ..utils.cli import maybe_accchk, print_config, readarg

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

    write_pdf(res.tt, prob)
    print(f"wrote {PDF_PATH}")
    try:
        from .plot_ttcross_data import plot_pdf

        plot_pdf(PDF_PATH, "out/tt-cross-pdf.png")
        print("wrote out/tt-cross-pdf.png")
    except Exception as e:  # matplotlib optional
        print(f"(plotting skipped: {e})")
    print("Good bye.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
