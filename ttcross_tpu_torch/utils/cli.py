"""Positional command-line arguments with defaults, and the driver banner.

Counterpart of ttcross_tpu/utils/cli.py (readarg, default.f90:40-78):
drivers take positional arguments and fall back to defaults, e.g.
``crs_ising.py C 6 64 24 1``.
"""

from __future__ import annotations

import os
import subprocess
import sys

__all__ = ["readarg", "maybe_accchk", "print_config"]


def readarg(pos: int, default, cast=None, argv=None):
    """Positional argument `pos` (1-based) of the command line with a
    default; the cast is the default's type unless given.  argv: the
    arguments after the program's name (sys.argv[1:] when None), so a
    driver's main(argv) reads a list given in process."""
    if cast is None:
        cast = type(default)
    args = sys.argv[1:] if argv is None else list(argv)
    if len(args) >= pos:
        return cast(args[pos - 1])
    return default


def maybe_accchk(res, fun, nlot: int = 1 << 14) -> None:
    """Randomized accuracy check of a driver's result, on with
    TTCROSS_ACCCHK=1 (the dtt_accchk pattern of the reference's demo,
    main.f90:50), on the device the train lies on."""
    if os.environ.get("TTCROSS_ACCCHK", "").lower() in ("", "0", "false", "no", "off"):
        return
    from ..cross.accchk import accchk

    chk = accchk(res.tt, fun, nlot=nlot, device=res.tt.device)
    print(f"accchk: einf {chk['einf']:.3e} efro {chk['efro']:.3e} "
          f"ainf {chk['ainf']:.3e} afro {chk['afro']:.3e} "
          f"worst {chk['worst_index']}")


def _device_banner():
    """The card's name and power limit as nvidia-smi reports them
    (``name, power.limit`` of every GPU) and the number of CUDA devices;
    without a card, the CPU and 0.  Nothing here initializes CUDA."""
    import torch

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        lines = out.stdout.strip().splitlines() if out.returncode == 0 else []
    except (OSError, subprocess.TimeoutExpired):
        lines = []
    if not lines:
        return "cpu (no NVIDIA GPU found)", 0
    return "; ".join(lines), torch.cuda.device_count()


def print_config(**kv) -> None:
    """Driver banner (the pattern of test_crs_*.f90's configuration
    summaries), ending with the device and the number of devices."""
    for k, v in kv.items():
        print(f"   {k:<10s}: {v}")
    dev, ndev = _device_banner()
    print(f"   {'device':<10s}: {dev}")
    print(f"   {'n devices':<10s}: {ndev}")
