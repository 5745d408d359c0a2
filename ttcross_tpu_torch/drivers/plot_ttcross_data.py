"""Plot the TT-cross pdf curve, optionally against TT-SVD data:
`python -m ttcross_tpu_torch.drivers.plot_ttcross_data [PATH [OUT [SVD_PATH]]]`.

The counterpart of drivers/plot_ttcross_data.py (plot-ttcross-data.py:1-19,
plot-ttcross-and-ttsvd-data.py:1-29): reads (x, pdf) pairs from a text
file (crs_pdf's out/tt-cross-pdf.txt), saves a PNG and, given a TT-SVD
comparison file, prints the mean absolute error.  Host code: it takes no
device and needs matplotlib, raising ImportError without it, as the JAX
function does."""

from __future__ import annotations

import sys

__all__ = ["plot_pdf"]


def plot_pdf(path: str = "out/tt-cross-pdf.txt", out: str = "out/tt-cross-pdf.png",
             svd_path: str | None = None) -> None:
    import matplotlib
    import numpy as np

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.loadtxt(path)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(data[:, 0], data[:, 1], label="TT-cross")
    if svd_path:
        svd = np.loadtxt(svd_path)
        ax.plot(svd[:, 0], svd[:, 1], "--", label="TT-SVD")
        m = min(len(svd), len(data))
        print("mean abs error:", np.abs(data[:m, 1] - svd[:m, 1]).mean())
    ax.set_xlabel("basket value")
    ax.set_ylabel("density")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)


if __name__ == "__main__":
    plot_pdf(*(sys.argv[1:] or []))
