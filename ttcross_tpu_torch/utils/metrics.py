"""Per-sweep records of a cross run, a JSONL writer, a profiler hook and a
timer (counterpart of ttcross_tpu/utils/metrics.py: the reference's
per-iteration report, dmrgg.f90:969-1008, as structured records), and the
spans of a call: named host intervals that the engines record while a
torch.profiler session is active."""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import asdict, dataclass, field, replace

import torch

__all__ = ["SweepRecord", "history_from_run", "write_jsonl", "profile_trace", "Timer",
           "SpanRecord", "span", "spans", "reset_spans"]


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
    profiler, whose key_averages() tabulate the phase.  The spans the
    phase recorded go to logdir/spans.jsonl, one SpanRecord a line, and
    leave spans()."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    n0 = len(_SPANS)
    try:
        with profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        # the window's spans, their parent and call ids counted from its first
        write_jsonl([replace(r, parent=None if r.parent is None else r.parent - n0,
                             call=r.call - n0) for r in _SPANS[n0:]],
                    os.path.join(logdir, "spans.jsonl"))
    finally:
        # the window's records are in its file: dropped, so that a process
        # that profiles many phases does not accumulate them
        with _LOCK:
            del _SPANS[n0:]


class Timer:
    """Wall-clock timer (timef analogue, timef.f90:25): calling it gives the
    seconds since it was made."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self) -> float:
        return time.perf_counter() - self.t0


@dataclass
class SpanRecord:
    """One span: start and end in time.perf_counter() seconds, parent the
    index (in spans()) of the enclosing span or None, call the index of
    the root span it lies in."""

    name: str
    start: float
    end: float | None = None
    parent: int | None = None
    call: int = 0
    attrs: dict = field(default_factory=dict)


_SPANS: list[SpanRecord] = []
_LOCK = threading.Lock()
_OPEN = threading.local()           # .stack: [(index, SpanRecord)] of the thread's open spans
_profiler_enabled = torch.autograd._profiler_enabled


class _NoSpan:
    """What span() gives with no profiler active: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name: str, attrs: dict):
        self.rec = SpanRecord(name, 0.0, attrs=attrs)

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        rec = self.rec
        with _LOCK:
            index = len(_SPANS)
            _SPANS.append(rec)
        if stack:
            rec.parent, rec.call = stack[-1][0], stack[-1][1].call
        else:
            rec.call = index
        stack.append((index, rec))
        rec.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.rec.end = time.perf_counter()
        _OPEN.stack.pop()
        return False

    def set(self, **attrs):
        """Add attributes known only inside the span."""
        self.rec.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager that records the host interval it encloses as a
    SpanRecord, nested in the thread's open span, while a torch.profiler
    session is active in this thread (torch.profiler.record_function's
    rule); otherwise one check and a shared no-op.  It never reads a
    device value: what it times is the host's enqueue and waits."""
    if not _profiler_enabled():
        return _NO_SPAN
    return _Span(name, attrs)


def spans() -> list[SpanRecord]:
    """The spans recorded since the last reset_spans(), in opening order."""
    return list(_SPANS)


def reset_spans() -> None:
    """Drop the recorded spans; spans() then counts from 0 again.  Refused
    inside an open span of this thread, whose later children would point
    at dropped records."""
    if getattr(_OPEN, "stack", None):
        raise RuntimeError("reset_spans() inside an open span")
    with _LOCK:
        _SPANS.clear()
