"""Matrix / tensor pretty-printers and structural summaries.

Counterpart of ttcross_tpu/utils/printing.py (say_lib, say.f90:9-181:
1/2/3-D real, complex and integer printers and the thresholded nonzero
dump; dtt_say, tt.f90:1200-1225).  Tensors are read from their device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tt.types import TT

__all__ = ["say", "saynnz", "say_tt"]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def say(a, fmt: str = "{:12.5e}", max_rows: int = 32, max_cols: int = 16) -> None:
    """Print a 0/1/2/3-D real or complex array (say.f90:9-119)."""
    a = _host(a)
    if a.ndim == 0:
        print(fmt.format(complex(a) if np.iscomplexobj(a) else float(a)))
        return
    if a.ndim == 1:
        a = a[None, :]
    if a.ndim == 3:
        for k in range(a.shape[2]):
            print(f"[:, :, {k}]")
            say(a[:, :, k], fmt, max_rows, max_cols)
        return
    rows = min(a.shape[0], max_rows)
    cols = min(a.shape[1], max_cols)
    for i in range(rows):
        cells = []
        for j in range(cols):
            v = a[i, j]
            if np.iscomplexobj(a):
                cells.append(f"{v.real:10.3e}{v.imag:+10.3e}i")
            elif np.issubdtype(a.dtype, np.integer):
                cells.append(f"{int(v):8d}")
            else:
                cells.append(fmt.format(float(v)))
        suffix = " ..." if cols < a.shape[1] else ""
        print(" ".join(cells) + suffix)
    if rows < a.shape[0]:
        print(f"... ({a.shape[0] - rows} more rows)")


def saynnz(a, tol: float = 0.0) -> None:
    """Dump entries with |a| > tol as (index, value) lines (say.f90:121-181)."""
    a = _host(a)
    idx = np.argwhere(np.abs(a) > tol)
    for ind in idx:
        print(tuple(int(x) for x in ind), a[tuple(ind)])


def say_tt(t: TT) -> None:
    """Mode/rank summary of a TT (dtt_say, tt.f90:1200-1225)."""
    print(f"TT d={t.d} dtype={t.dtype} device={t.device}")
    print("  n:", list(t.n))
    print("  r:", list(t.r))
    print(f"  erank={t.erank():.2f} mem={t.mem()}")
