"""Build and load the port's CUDA kernels (csrc/kernels.cu, csrc/dd_kernels.cu,
csrc/qd_kernels.cu, and the header csrc/ising_rows.cuh that the last two include).

The sources are compiled with nvcc for sm_90a, one nvcc per source, all
started together, and their objects linked into one shared library with a
plain C interface, loaded with ctypes, at first use: the build lands in
``build/ttcross_tpu_torch/<hash>/`` at the root of the checkout, keyed by a
hash of the sources, the header and the flags, so a changed source is rebuilt and
unchanged ones are reused within a checkout.  Nothing is built or loaded
when the package is imported.
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

__all__ = ["SOURCES", "NVCC_FLAGS", "build", "load"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "kernels.cu",      # kernels A and B, the fused integrands, MT19937
           _PKG / "csrc" / "dd_kernels.cu",   # the dd tier's kernels
           _PKG / "csrc" / "qd_kernels.cu")   # the qd tier's kernels
HEADERS = (_PKG / "csrc" / "ising_rows.cuh",)   # D2's and Q1's body, launch and plan
BUILD_ROOT = _PKG.parent / "build" / "ttcross_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_D = ctypes.c_double
_PP = ctypes.POINTER(ctypes.c_void_p)   # a host array of the 4 limb pointers of a qd operand
_LLP = ctypes.POINTER(_LL)              # a host array of long longs (a shape, strides, a plan)
_SIGNATURES = {
    "ttc_configure": ([_I], _I),
    "ttc_score_residual_argmax": (
        [_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _P, _P], _I),
    "ttc_score_residual_argmax_batched": (
        [_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _P, _P], _I),
    "ttc_small_table_lookup": ([_P, _I, _I, _P, _LL, _P, _I, _P], _I),
    "ttc_ising_integrand": ([_P, _I, _P, _LL, _I, _I, _I, _I, _I, _I, _D, _P, _P], _I),
    "ttc_mvn_pdf": ([_P, _I, _P, _LL, _LL, _I, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ttc_mvn_threads": ([], _I),
    "ttc_lane_uniforms": ([_P, _LL, _I, _I, _P, _P], _I),
    "ttc_mt_threads": ([], _I),
    "ttc_threads_per_block": ([], _I),
    "ttc_tile_threads": ([], _I),
    "ttc_tile_smem": ([], _I),
    "ttc_simt_threads": ([], _I),
    "ttc_integrand_rows_threads": ([], _I),
    "ttc_integrand_rows_d_max": ([], _I),
    "ttc_integrand_warp_d_max": ([], _I),
    "ttd_score_residual_argmax": (
        [_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _LL, _LL, _LL, _P, _I, _P, _I, _I, _P, _P, _P],
        _I),
    "ttd_dd_score_plan": ([_LL, _I, ctypes.POINTER(_LL)], _I),
    "ttd_dot": ([_P, _P, _P, _P, _LL, _LL, _I, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I, _I, _P, _P,
                 _P], _I),
    "ttd_dd_dot_plan": ([_LL, _LL, _I, ctypes.POINTER(_LL)], _I),
    "ttd_gather_tt": ([_P, _P, _I, _I, _I, _P, _LL, _I, _I, _P, _P, _P], _I),
    "ttd_dd_gather_plan": ([_LL, _I, _I, _I, ctypes.POINTER(_LL)], _I),
    "ttd_ising_c_integrand": ([_P, _I, _P, _LL, _I, _I, _P, _P, _P], _I),
    "ttd_dd_ising_plan": ([_LL, _I, _I, ctypes.POINTER(_LL)], _I),
    "ttd_threads": ([], _I),
    "ttd_gather_rmax": ([], _I),
    "ttq_score_residual_argmax": (
        [_PP, _PP, _PP, _LL, _I, _LL, _LL, _LL, _LL, _I, _I, _P, _P, _P], _I),
    "ttq_score_plan": ([_LL, _I, ctypes.POINTER(_LL)], _I),
    "ttq_dot": (
        [_PP, _PP, _LL, _LL, _I, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I, _I, _I, _P, _P], _I),
    "ttq_dot_plan": ([_LL, _LL, _I, _I, ctypes.POINTER(_LL)], _I),
    "ttq_gather_tt": ([_P, _P, _I, _I, _I, _P, _LL, _I, _I, _P, _P], _I),
    "ttq_gather_rows": ([_I, _LL], _I),
    "ttq_ising_c_integrand": ([_P, _I, _P, _LL, _I, _I, _P, _P], _I),
    "ttq_q1_plan": ([_LL, _I, _I, ctypes.POINTER(_LL)], _I),
    "ttq_threads": ([], _I),
    "ttq_rows_threads": ([], _I),
    "ttq_gather_rmax": ([], _I),
    "ttq_tree_max": ([], _I),
    "ttq_div": ([_PP, _PP, _LLP, _LLP, _LLP, _I, _P, _P], _I),
    "ttq_div_plan": ([_LL, _LLP], _I),
    "ttq_div_dims": ([], _I),
}


_F32_ENTRIES = ("ttc_score_residual_argmax", "ttc_score_residual_argmax_batched",
                "ttc_small_table_lookup", "ttc_ising_integrand", "ttc_mvn_pdf")


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
    """Compile the sources unless their library exists: one nvcc -c per
    source, all started together, then one nvcc -shared that links the
    objects.

    Returns (library path, seconds spent compiling and linking, nvcc's
    -Xptxas=-v report of every source); the seconds are 0.0 when the
    library was already built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / "libttcross_kernels.so"
    log = out_dir / "nvcc.log"
    if lib.is_file():
        return lib, 0.0, log.read_text() if log.is_file() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs, running = [], []
    for src in SOURCES:
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        running.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), cmd))
        objs.append(obj)
    reports = []
    try:
        for proc, cmd in running:
            report = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{report}")
            reports.append(report)
    finally:
        for proc, _ in running:   # after a failure, stop the other compiles
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = out_dir / f"libttcross_kernels.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    seconds = time.perf_counter() - t0
    report = "".join(reports)
    log.write_text(report)
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    for obj in objs:
        obj.unlink()
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
