"""g++ builds of the port's two host libraries (csrc/ttcross_native.cpp,
csrc/mpfr_cross.cpp).

Each source is compiled at first use into ``build/ttcross_tpu_torch/<hash>/``
at the root of the checkout (the directory of ops/_build.py's CUDA library),
keyed by a hash of the source, the flags and the libraries, so a changed
source is rebuilt and an unchanged one reused within a checkout.  Nothing is
built when the package is imported, and nothing of the JAX package's
native directory is built or loaded.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path

from ..ops._build import BUILD_ROOT

__all__ = ["CSRC", "GXX_FLAGS", "build_library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")


def build_library(src: Path, stem: str, libs: tuple = (), force: bool = False,
                  timeout: float = 180.0) -> tuple[Path | None, float, str]:
    """Compile `src` into lib<stem>.so unless it exists (or `force`).

    Returns (library path or None when g++ failed, seconds spent compiling,
    g++'s output); the seconds are 0.0 when the library was already built."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS + tuple(libs)).encode())
    digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / f"lib{stem}.so"
    if lib.is_file() and not force:
        return lib, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{stem}.{os.getpid()}.tmp.so"
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(src), *libs]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        return None, time.perf_counter() - t0, repr(e)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None, seconds, proc.stdout + proc.stderr
    os.replace(tmp, lib)      # atomic: a concurrent loader sees all or nothing
    return lib, seconds, proc.stdout + proc.stderr
