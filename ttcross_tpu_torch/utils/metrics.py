"""Per-sweep records of a cross run (counterpart of
ttcross_tpu/utils/metrics.py: the reference's per-iteration report,
dmrgg.f90:969-1008, as structured records)."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["SweepRecord", "history_from_run"]


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
