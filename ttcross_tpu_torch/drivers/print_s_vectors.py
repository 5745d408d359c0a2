"""Print all 2^(D-1) sign vectors:
`python -m ttcross_tpu_torch.drivers.print_s_vectors D`.

The counterpart of drivers/print_s_vectors.py (test_s_vectors.f90): the
rows are read back from the sign table that the COS integrand holds on
`device` (apps/cos.py::make_cos_coefficients' sv_t, built from
s_vectors), so they are the signs the card's coefficient sweep uses."""

from __future__ import annotations

import sys


def main(argv=None, device="cuda") -> int:
    import numpy as np

    from ..apps import make_cos_coefficients
    from ..utils.cli import readarg

    d = readarg(1, 4, argv=argv)
    cc = make_cos_coefficients(d, np.zeros(d), np.eye(d), 0.0, 1.0, device=device)
    for row in cc.sv_t.cpu().numpy():
        print(" ".join(f"{int(x):+d}" for x in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
