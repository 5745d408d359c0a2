"""Build and load the port's CUDA kernels (csrc/kernels.cu).

The source is compiled with nvcc for sm_90a into a shared library with a
plain C interface and loaded with ctypes, at first use: the build lands in
``build/ttcross_tpu_torch/<hash>/`` at the root of the checkout, keyed by a
hash of the source and the flags, so a changed source is rebuilt and an
unchanged one is reused within a checkout.  Nothing is built or loaded when
the package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCE", "NVCC_FLAGS", "build", "load"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "kernels.cu"
BUILD_ROOT = _PKG.parent / "build" / "ttcross_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "ttc_configure": ([_I], _I),
    "ttc_score_residual_argmax": (
        [_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _P, _P], _I),
    "ttc_score_residual_argmax_batched": (
        [_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P, _P], _I),
    "ttc_small_table_lookup": ([_P, _I, _I, _P, _LL, _P, _I, _P], _I),
    "ttc_ising_integrand": ([_P, _I, _P, _LL, _I, _I, _I, _I, _I, _I, _D, _P, _P], _I),
    "ttc_threads_per_block": ([], _I),
    "ttc_tile_threads": ([], _I),
    "ttc_tile_smem": ([], _I),
    "ttc_simt_threads": ([], _I),
    "ttc_integrand_rows_threads": ([], _I),
    "ttc_integrand_rows_d_max": ([], _I),
    "ttc_integrand_warp_d_max": ([], _I),
}


_F32_ENTRIES = ("ttc_score_residual_argmax", "ttc_score_residual_argmax_batched",
                "ttc_small_table_lookup", "ttc_ising_integrand")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "of ttcross_tpu_torch cannot be built")
    return found


def build() -> tuple[Path, float, str]:
    """Compile csrc/kernels.cu unless this source's library exists.

    Returns (library path, seconds spent compiling, nvcc's -Xptxas=-v
    report); the seconds are 0.0 when the library was already built."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / tag
    lib = out_dir / "libttcross_kernels.so"
    log = out_dir / "nvcc.log"
    if lib.is_file():
        return lib, 0.0, log.read_text() if log.is_file() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libttcross_kernels.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{report}")
    log.write_text(report)
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    return lib, seconds, report


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process with every
    entry point's argtypes/restype declared; each kernel's f32 entry point
    (name + "_f32") takes the arguments of its f64 one."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        for suffix in (("", "_f32") if name in _F32_ENTRIES else ("",)):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = restype
    return lib
