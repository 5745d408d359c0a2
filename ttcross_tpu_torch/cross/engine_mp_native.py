"""Native (MPFR) arbitrary-precision cross: the compiled mp tier.

A copy of ttcross_tpu/cross/engine_mp_native.py.  The reference's 120-digit
tier is compiled MPFR (MPFUN-MPFR over C shims, mpinterface.c:4-85; engine
mptt_dmrgg, dmrggmp.f90:11-704).  This wrapper drives the port's own copy
of the native engine (csrc/mpfr_cross.cpp, the algorithm of
cross/engine_mp.py compiled over libmpfr, built by native/_mpfr.py), which
runs the hot loops at compiled speed.  Host code by design, like the whole
mp tier (ttcross_tpu/ops/mp.py:1-17): no device is involved.

Two entry points:
  * ising_cross_mp_native: the built-in Ising C/D/E integrand family
    (nodes, weights, integrand and quadrature all native; the
    test_mpf_ising role).
  * cross_mp_native: the native engine with an arbitrary integrand through
    a Python callback exchanging decimal strings (one string round trip
    per evaluation).

Values come back as decimal strings, and as mpmath mpf when mpmath is
importable.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from .. import native

__all__ = ["MpNativeResult", "ising_cross_mp_native", "cross_mp_native"]

_HIST_CAP = 256


@dataclass
class MpNativeResult:
    value: object            # mpf (or decimal string if mpmath is absent)
    value_str: str
    neval: int
    sweeps: int
    ranks: tuple
    history: list            # per-sweep {it, pivotmax_log10, err_log10}
    digits: float | None     # vs truth, when truth was given


def _to_mp(s: str, dps: int):
    try:
        from mpmath import mpf, workdps

        with workdps(dps):
            return mpf(s)
    except ImportError:
        return s


def _require():
    lib = native.load_mpfr()
    if lib is None:
        raise RuntimeError(
            "native MPFR engine unavailable (g++ or libmpfr.so.6 missing); "
            "use cross_mp (mpmath) instead")
    return lib


def ising_cross_mp_native(kind: str = "C", m: int = 4, n: int = 33,
                          max_rank: int = 16, pivoting: int = 1,
                          dps: int = 120, seed: int = 0, snum: int = 8,
                          small_element_log10: float | None = None,
                          small_pivot_log10: float = -7.0,
                          accuracy_log10: float | None = None,
                          truth: str | None = "auto") -> MpNativeResult:
    """Ising C_m/D_m/E_m cross at `dps` decimal digits, fully native.

    truth="auto" looks up the tabulated constant (apps/truths.py) for
    per-sweep err telemetry and the final digits figure; pass None to
    skip (D/E indexes without tabulated truths report convergence only).
    """
    lib = _require()
    kind = kind.upper()
    if kind not in ("C", "D", "E"):
        raise ValueError(f"unknown Ising kind {kind!r}")
    if truth == "auto":
        from ..apps.truths import ising_truth_str

        try:
            truth = ising_truth_str(kind, m)
        except KeyError:
            truth = None
    val = ctypes.create_string_buffer(dps + 64)
    neval = ctypes.c_int64()
    sweeps = ctypes.c_int64()
    ranks = np.zeros(m + 1, np.int64)   # d+1 = m bond ranks, pad one
    sl = np.zeros(_HIST_CAP)
    se = np.zeros(_HIST_CAP)
    rc = lib.mp_ising_cross(
        kind.encode(), m, n, max_rank, pivoting, dps, seed, snum,
        small_element_log10 if small_element_log10 is not None else 1e300,
        small_pivot_log10,
        accuracy_log10 if accuracy_log10 is not None else 1e300,
        (truth or "").encode(), val, len(val),
        ctypes.byref(neval), ctypes.byref(sweeps), ranks, sl, se, _HIST_CAP)
    if rc != 0:
        raise RuntimeError(f"mp_ising_cross failed: rc={rc}")
    s = val.value.decode()
    nsw = int(sweeps.value)
    history = [{"it": i + 1, "pivotmax_log10": float(sl[i]),
                "err_log10": (float(se[i]) if truth else None)}
               for i in range(min(nsw, _HIST_CAP))]
    digits = None
    if truth and nsw:
        digits = -float(se[min(nsw, _HIST_CAP) - 1])
    return MpNativeResult(value=_to_mp(s, dps), value_str=s,
                          neval=int(neval.value), sweeps=nsw,
                          ranks=tuple(int(x) for x in ranks[:m]),
                          history=history, digits=digits)


def cross_mp_native(fun_mp: Callable, n: Sequence[int],
                    max_rank: int = 16, pivoting: int = 1,
                    quad: Sequence | None = None, truth=None,
                    dps: int = 120, seed: int = 0, snum: int = 8,
                    small_element_log10: float | None = None,
                    small_pivot_log10: float = -7.0,
                    accuracy_log10: float | None = None) -> MpNativeResult:
    """Native engine + arbitrary Python integrand (mp values cross the
    boundary as decimal strings).

    fun_mp: ind (B, d) int64 numpy -> (B,) of objects with a decimal
    `str()` (mpmath mpf works; so do plain floats).  quad: per-mode
    weight vectors of such objects.  truth: object with decimal str()."""
    lib = _require()
    n = [int(x) for x in n]
    d = len(n)
    cap = dps + 32

    def _cb(B, ind_ptr, dd, out_ptr, out_cap):
        ind = np.ctypeslib.as_array(ind_ptr, shape=(B, dd)).copy()
        vals = fun_mp(ind)
        buf = ctypes.cast(out_ptr,
                          ctypes.POINTER(ctypes.c_char * (B * out_cap)))
        for b in range(B):
            sv = _dec(vals[b], dps).encode()[: out_cap - 1]
            ctypes.memmove(ctypes.addressof(buf.contents) + b * out_cap,
                           sv + b"\0", len(sv) + 1)

    cb = native.MP_FUN_CB(_cb)
    quad_buf = None
    stride = 0
    if quad is not None:
        stride = cap
        rows = []
        for c in range(d):
            wc = list(quad[c])
            if len(wc) != n[c]:
                raise ValueError("quad length mismatch")
            rows.extend(_dec(v, dps) for v in wc)
        quad_buf = b"".join(s.encode().ljust(stride, b"\0")[:stride]
                            for s in rows)
    val = ctypes.create_string_buffer(dps + 64)
    neval = ctypes.c_int64()
    sweeps = ctypes.c_int64()
    ranks = np.zeros(d + 2, np.int64)
    rc = lib.mp_cross_cb(
        cb, d, np.asarray(n, np.int64), max_rank, pivoting, dps, seed, snum,
        small_element_log10 if small_element_log10 is not None else 1e300,
        small_pivot_log10,
        accuracy_log10 if accuracy_log10 is not None else 1e300,
        quad_buf, stride, _dec(truth, dps).encode() if truth is not None
        else b"", val, len(val), ctypes.byref(neval), ctypes.byref(sweeps),
        ranks)
    if rc != 0:
        raise RuntimeError(f"mp_cross_cb failed: rc={rc}")
    s = val.value.decode()
    return MpNativeResult(value=_to_mp(s, dps), value_str=s,
                          neval=int(neval.value), sweeps=int(sweeps.value),
                          ranks=tuple(int(x) for x in ranks[: d + 1]),
                          history=[], digits=None)


def _dec(v, dps: int) -> str:
    """Decimal string of an mp-ish value at full precision."""
    try:
        from mpmath import mp, workdps

        with workdps(dps):
            return mp.nstr(v, dps, strip_zeros=False) if not isinstance(
                v, str) else v
    except ImportError:
        return repr(v) if not isinstance(v, str) else v
