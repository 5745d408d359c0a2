"""Native (C++) host components of the port, bound by ctypes: the
counterpart of ttcross_tpu/native/__init__.py.

Two libraries, each the port's own copy of the JAX package's source, built
with g++ at first use into the checkout's ``build/`` (native/_gxx.py):
  * csrc/ttcross_native.cpp (``-lquadmath``): the __float128 Gauss-Legendre
    rule, the quad-precision TT contraction, binary TT IO, the long-double
    Gaussian characteristic function, the __float128 stdnorm / Ising C
    integrands and the cross-interpolant value (the dd tier's verification
    twins);
  * csrc/mpfr_cross.cpp (MPFR): the compiled mp engine of
    cross/engine_mp_native.py (native/_mpfr.py).

This is host code compiled with g++, not a kernel of the card: the port's
kernels are csrc/*.cu.  So, as in the JAX package, a name keeps a Python
fallback where the port has a twin of its own when g++ is missing:
``gauss_legendre_dd`` falls back to ops/quadrature.py::gauss_legendre_dd,
``tt_write_native`` / ``tt_read_native`` to tt/serialize.py's ``save_ttbin``
/ ``load_ttbin``; the rest raise.  Trains come in as the port's TT, whose
cores may lie on the card: they are copied to host numpy first, and
``tt_read_native`` places what it reads on ``device`` (the card unless the
caller asks for ``device="cpu"``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ._gxx import CSRC, build_library
from ._mpfr import MP_FUN_CB, build_mpfr, load_mpfr, mpfr_available

__all__ = ["available", "gauss_legendre_dd", "contract_q", "tt_write_native", "tt_read_native",
           "gaussian_chf_native", "build", "mpfr_available", "build_mpfr", "stdnorm_dd",
           "ising_c_dd", "cross_value_dd", "MP_FUN_CB"]

NATIVE_SRC = CSRC / "ttcross_native.cpp"
NATIVE_LIBS = ("-lquadmath",)


def build(force: bool = False) -> bool:
    """Compile csrc/ttcross_native.cpp with g++ (once per checkout); False
    when g++ or libquadmath is missing."""
    path = build_library(NATIVE_SRC, "ttcross_torch_native", NATIVE_LIBS, force=force)[0]
    return path is not None


@functools.lru_cache(maxsize=None)
def _load():
    """The loaded library with its entry points declared (once per
    process), or None when it does not build."""
    path = build_library(NATIVE_SRC, "ttcross_torch_native", NATIVE_LIBS)[0]
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.gauss_legendre_q.argtypes = [ctypes.c_int64, f64p, f64p, f64p, f64p]
    lib.dd_contract_chain.argtypes = [
        ctypes.c_int64, i64p, i64p, f64p, f64p, f64p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    lib.tt_write_raw.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p, i64p, f64p,
                                 ctypes.c_int64, ctypes.c_int32]
    lib.tt_read_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int32), i64p, i64p, ctypes.c_int64]
    lib.tt_read_data.argtypes = [ctypes.c_char_p, ctypes.c_int64, f64p, ctypes.c_int64]
    lib.gaussian_chf_batch.argtypes = [ctypes.c_int64, ctypes.c_int64, f64p, f64p, f64p, f64p,
                                       f64p]
    lib.stdnorm_q.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, f64p, f64p, f64p, f64p]
    lib.ising_c_q.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, f64p, f64p, f64p, f64p,
                              f64p, f64p]
    lib.cross_value_q.argtypes = [
        ctypes.c_int64, i64p, i64p, f64p, f64p, f64p, f64p, f64p, f64p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    return lib


def available() -> bool:
    return _load() is not None


def _host(a, dtype=np.float64) -> np.ndarray:
    """A C-contiguous host numpy copy of a tensor (on any device) or array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype=dtype)


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ or libquadmath missing)")
    return lib


def gauss_legendre_dd(n: int):
    """Gauss-Legendre nodes and weights on [-1, 1] as double-double pairs
    ((x_hi, x_lo), (w_hi, w_lo)), computed in __float128 (~1e-34), each
    (n,) f64 numpy.  Without the library: the port's own dd rule
    (ops/quadrature.py::gauss_legendre_dd, decimal at 50 digits)."""
    lib = _load()
    if lib is None:
        from ..ops.quadrature import gauss_legendre_dd as rule

        return rule(n)
    xh, xl, wh, wl = (np.zeros(n) for _ in range(4))
    rc = lib.gauss_legendre_q(n, xh, xl, wh, wl)
    if rc != 0:
        raise RuntimeError(f"gauss_legendre_q failed: {rc}")
    return (xh, xl), (wh, wl)


def _weights(d, nm, weights_hi, weights_lo):
    N = int(nm.max())
    wh = np.zeros((d, N))
    wl = np.zeros((d, N))
    for c in range(d):
        wh[c, : nm[c]] = _host(weights_hi[c])
        if weights_lo is not None:
            wl[c, : nm[c]] = _host(weights_lo[c])
    return N, wh, wl


def contract_q(t, weights_hi, weights_lo=None):
    """Quad-precision chain contraction of a real TT against per-mode dd
    weights, on the host (the verification reference of the dd path).
    t: the port's TT (cores on any device).  Returns (hi, lo) floats."""
    lib = _require()
    d = t.d
    rk = np.asarray(t.r, dtype=np.int64)
    nm = np.asarray(t.n, dtype=np.int64)
    flat = np.concatenate([_host(c).ravel() for c in t.cores])
    N, wh, wl = _weights(d, nm, weights_hi, weights_lo)
    hi, lo = ctypes.c_double(), ctypes.c_double()
    rc = lib.dd_contract_chain(d, rk, nm, flat, wh.ravel(), wl.ravel(), N, ctypes.byref(hi),
                               ctypes.byref(lo))
    if rc != 0:
        raise RuntimeError(f"dd_contract_chain failed: {rc}")
    return hi.value, lo.value


def stdnorm_dd(ind, nodes_hi, nodes_lo):
    """exp(-sum x^2) at dd nodes in __float128; ind (B, d) -> (hi, lo) numpy."""
    lib = _require()
    ind = _host(ind, np.int64)
    B, d = ind.shape
    hi, lo = np.zeros(B), np.zeros(B)
    lib.stdnorm_q(B, d, ind, _host(nodes_hi), _host(nodes_lo), hi, lo)
    return hi, lo


def ising_c_dd(ind, nodes_hi, nodes_lo, w_hi, w_lo):
    """The Ising C-kind integrand at dd nodes / weights in __float128;
    ind (B, d) -> (hi, lo) numpy."""
    lib = _require()
    ind = _host(ind, np.int64)
    B, d = ind.shape
    hi, lo = np.zeros(B), np.zeros(B)
    lib.ising_c_q(B, d, ind, _host(nodes_hi), _host(nodes_lo), _host(w_hi), _host(w_lo), hi, lo)
    return hi, lo


def cross_value_dd(rk, n, cores_hi, cores_lo, ahat_hi, ahat_lo, weights_hi, weights_lo):
    """Quadrature value of the cross interpolant in __float128: the chain of
    per-core contractions with Ahat^{-1} LU solves (the mp tier's dtt_lua +
    dtt_quad).  cores / ahat: lists of hi and lo arrays; returns (hi, lo)."""
    lib = _require()
    d = len(n)
    rk = _host(rk, np.int64)
    nm = _host(n, np.int64)
    ch = np.concatenate([_host(c).ravel() for c in cores_hi])
    cl = np.concatenate([_host(c).ravel() for c in cores_lo])
    if len(ahat_hi):
        ahh = np.concatenate([_host(a).ravel() for a in ahat_hi])
        ahl = np.concatenate([_host(a).ravel() for a in ahat_lo])
    else:
        ahh, ahl = np.zeros(1), np.zeros(1)
    N, wh, wl = _weights(d, nm, weights_hi, weights_lo)
    hi, lo = ctypes.c_double(), ctypes.c_double()
    rc = lib.cross_value_q(d, rk, nm, ch, cl, ahh, ahl, wh.ravel(), wl.ravel(), N,
                           ctypes.byref(hi), ctypes.byref(lo))
    if rc != 0:
        raise RuntimeError(f"cross_value_q failed: {rc} (singular pivot block?)")
    return hi.value, lo.value


def gaussian_chf_native(omega, mu, sigma):
    """An independent C++ (long double) Gaussian characteristic function,
    the twin of apps/cos.py::gaussian_chf for the cross-language check
    (test_chf_equal.f90:44-63).  omega (B, n) -> complex128 numpy (B,)."""
    lib = _require()
    omega = _host(omega)
    B, n = omega.shape
    re, im = np.zeros(B), np.zeros(B)
    lib.gaussian_chf_batch(B, n, omega, _host(mu), _host(sigma).ravel(), re, im)
    return re + 1j * im


def tt_write_native(t, path: str) -> None:
    """Write the port's TT (cores on any device, real or complex) in the
    native 'TTXN' stream format; without the library, tt/serialize.py's
    save_ttbin."""
    lib = _load()
    if lib is None:
        from ..tt.serialize import save_ttbin

        save_ttbin(t, path)
        return
    cores = [c.detach().cpu().numpy() if hasattr(c, "detach") else np.asarray(c)
             for c in t.cores]
    is_complex = np.iscomplexobj(cores[0])
    flat = np.ascontiguousarray(np.concatenate(
        [np.ascontiguousarray(a, np.complex128).view(np.float64).ravel() if is_complex
         else a.astype(np.float64).ravel() for a in cores]))
    rc = lib.tt_write_raw(str(path).encode(), t.d, np.asarray(t.n, np.int64),
                          np.asarray(t.r, np.int64), flat, flat.size, 1 if is_complex else 0)
    if rc != 0:
        raise RuntimeError(f"tt_write_raw failed: {rc}")


def tt_read_native(path: str, device="cuda"):
    """Read a native 'TTXN' file into the port's TT on ``device``; without
    the library, tt/serialize.py's load_ttbin."""
    from ..tt.types import from_cores

    lib = _load()
    if lib is None:
        from ..tt.serialize import load_ttbin

        return load_ttbin(path, device=device)
    max_d = 4096
    d, cx = ctypes.c_int64(), ctypes.c_int32()
    n = np.zeros(max_d, np.int64)
    r = np.zeros(max_d + 1, np.int64)
    rc = lib.tt_read_header(str(path).encode(), ctypes.byref(d), ctypes.byref(cx), n, r, max_d)
    if rc != 0:
        raise ValueError(f"not a native TT file (rc={rc})")
    d = d.value
    n, r = n[:d], r[: d + 1]
    mult = 2 if cx.value else 1
    count = int(sum(r[c] * n[c] * r[c + 1] for c in range(d))) * mult
    flat = np.zeros(count)
    rc = lib.tt_read_data(str(path).encode(), d, flat, count)
    if rc != 0:
        raise ValueError(f"tt_read_data failed (rc={rc})")
    cores, off = [], 0
    for c in range(d):
        cnt = int(r[c] * n[c] * r[c + 1]) * mult
        buf = flat[off: off + cnt]
        off += cnt
        if cx.value:
            buf = buf.view(np.complex128)
        cores.append(np.ascontiguousarray(buf.reshape(int(r[c]), int(n[c]), int(r[c + 1]))))
    return from_cores(cores, device=device)
