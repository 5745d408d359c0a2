"""Per-sweep records of a cross run, a JSONL writer, a profiler hook and a
timer (counterpart of ttcross_tpu/utils/metrics.py: the reference's
per-iteration report, dmrgg.f90:969-1008, as structured records)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import asdict, dataclass

__all__ = ["SweepRecord", "history_from_run", "write_jsonl", "profile_trace", "Timer"]


@dataclass
class SweepRecord:
    it: int
    direction: str        # '>>', '<<', or 'rd' for the rounding revaluation
    n_evals: int
    pivotmax: float
    value: float | None = None
    err: float | None = None      # |1 - val/tru| when the truth is known
    cnv: float | None = None      # |1 - val/val_prev| otherwise


def history_from_run(last_it, vals, pmax, nev, truth=None, with_quad=False, it0: int = 0):
    """SweepRecords from the run's per-sweep host arrays (index 0 = init);
    it0: the sweeps made before this run (a resumed run)."""
    recs = []
    for i in range(1, int(last_it) + 1):
        rec = SweepRecord(it=it0 + i, direction=">>" if (it0 + i) % 2 == 1 else "<<",
                          n_evals=int(nev[i]), pivotmax=float(pmax[i]))
        if with_quad:
            rec.value = float(vals[i])
            if truth is not None:
                rec.err = abs(1.0 - rec.value / truth)
            elif vals[i - 1] != 0:
                rec.cnv = abs(1.0 - rec.value / float(vals[i - 1]))
        recs.append(rec)
    return recs


def write_jsonl(records, path: str) -> None:
    """One JSON object per record (its fields that are not None), one per
    line."""
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps({k: v for k, v in asdict(r).items() if v is not None}) + "\n")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """torch.profiler around a phase (CPU and, when there is a card, CUDA
    activity), its Chrome trace written to logdir/trace.json at the end:
    the counterpart of the JAX package's XLA profiler hook.  Yields the
    profiler, whose key_averages() tabulate the phase."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timer:
    """Wall-clock timer (timef analogue, timef.f90:25): calling it gives the
    seconds since it was made."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self) -> float:
        return time.perf_counter() - self.t0
