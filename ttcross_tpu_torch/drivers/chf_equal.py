"""Cross-language CHF check: `python -m ttcross_tpu_torch.drivers.chf_equal D G`.

The counterpart of drivers/chf_equal.py (test_chf_equal.f90:44-63): the
port's apps/cos.py::gaussian_chf on the card against the independent C++
long-double implementation (native.gaussian_chf_native, csrc/
ttcross_native.cpp) over a G^D parameter grid.  Exit code 0 when they agree
to 1e-13, 2 when not, 1 without the native library."""

from __future__ import annotations

import sys

RTOL = 1e-13


def main(argv=None, device="cuda") -> int:
    import numpy as np

    from .. import native
    from ..apps.cos import gaussian_chf
    from ..utils.cli import readarg

    d = readarg(1, 4, argv=argv)
    g = readarg(2, 3, argv=argv)
    if not native.available():
        print("native toolchain unavailable; nothing to compare")
        return 1

    rng = np.random.default_rng(0)
    mu = rng.standard_normal(d)
    A = rng.standard_normal((d, d))
    sigma = A @ A.T / d
    grids = np.meshgrid(*[np.linspace(-1.0, 1.0, g)] * d, indexing="ij")
    omega = np.stack([x.ravel() for x in grids], axis=1)

    ours = gaussian_chf(omega, mu, sigma, device=device).cpu().numpy()
    cpp = native.gaussian_chf_native(omega, mu, sigma)
    err = np.abs(ours - cpp).max()
    print(f"compared {len(omega)} CHF values: max |torch - c++| = {err:.3e}")
    print("EQUAL" if err < RTOL else "MISMATCH")
    return 0 if err < RTOL else 2


if __name__ == "__main__":
    sys.exit(main())
