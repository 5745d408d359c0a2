"""The native MPFR cross engine's library (csrc/mpfr_cross.cpp), bound by
ctypes: the port's counterpart of ttcross_tpu/native/__init__.py:77-145.

The host image ships libmpfr.so.6 / libgmp.so.10 without their development
links or mpfr.h, so the source declares the MPFR ABI itself and links the
versioned names (-l:libmpfr.so.6 -l:libgmp.so.10).  Before the library is
trusted, its ABI self-test must compute exp(1)'s first eight digits
(mp_selftest() == 27182818).  Host code: the mp tier never uses the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ._gxx import CSRC, build_library

__all__ = ["MP_FUN_CB", "SELFTEST", "build_mpfr", "mpfr_available", "load_mpfr"]

MPFR_SRC = CSRC / "mpfr_cross.cpp"
MPFR_LIBS = ("-l:libmpfr.so.6", "-l:libgmp.so.10")
SELFTEST = 27182818

MP_FUN_CB = ctypes.CFUNCTYPE(None, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                             ctypes.POINTER(ctypes.c_char), ctypes.c_int64)


def build_mpfr(force: bool = False) -> bool:
    """Compile csrc/mpfr_cross.cpp with g++ (once per checkout); False when
    g++ or the MPFR / GMP libraries are missing."""
    path = build_library(MPFR_SRC, "ttcross_torch_mpfr", MPFR_LIBS, force=force)[0]
    return path is not None


@functools.lru_cache(maxsize=None)
def load_mpfr():
    """The loaded library with its entry points declared (once per
    process), or None when it does not build or fails its ABI self-test."""
    path = build_library(MPFR_SRC, "ttcross_torch_mpfr", MPFR_LIBS)[0]
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.mp_selftest.argtypes = []
    lib.mp_selftest.restype = ctypes.c_int64
    lib.mp_ising_cross.restype = ctypes.c_int64
    lib.mp_ising_cross.argtypes = [
        ctypes.c_char, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        i64p, f64p, f64p, ctypes.c_int64]
    lib.mp_cross_cb.restype = ctypes.c_int64
    lib.mp_cross_cb.argtypes = [
        MP_FUN_CB, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), i64p]
    if lib.mp_selftest() != SELFTEST:     # the hand-declared struct layout is wrong
        return None
    return lib


def mpfr_available() -> bool:
    return load_mpfr() is not None
