"""What the card did during one traced call, from torch.profiler.

One call runs under torch.profiler with the CUDA activity alone (no host
op is recorded, so the host is slowed as little as the profiler allows).
A spin kernel launched just before the call marks the host's clock on the
device's timeline, so that each idle gap of the device is labelled by the
benchmark's own span that the host was in when the gap began, and by the
device op that ended it.  Its ops are those that chip_smoke.py's
device_launches (:2243-2253) counts: every device event of the profiler,
kernels, copies and sets, not only the hand kernels.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass

__all__ = ["Op", "Trace", "short_name", "base_name", "busy_and_gaps", "traced_call"]


@dataclass
class Op:
    """One device op: its profiler name, and start and end in seconds on
    the host's clock since the traced call began."""

    name: str
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def base(self) -> str:
        return base_name(self.name)


@dataclass
class Trace:
    ops: list                  # [Op] of the call, in start order
    window_s: float            # the traced window: the call and its result handling
    busy_s: float              # seconds in which some op ran on the device
    gaps: list                 # [(label, seconds)] idle gaps summed by label, longest first
    launch_shapes: dict        # the program's launch counter over the call
    marker_found: bool         # the spin kernel that ties the device's clock to the host's
    sweeps: int = 0            # sweeps the call ran


def short_name(name: str, width: int = 120) -> str:
    """A device op's name without its return type and argument list."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)", "anon")
    depth = 0
    for i, ch in enumerate(s):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            s = s[:i]
            break
    return s.strip()[:width]


def base_name(name: str) -> str:
    """A kernel's function name alone: no namespace, template or arguments."""
    s = short_name(name, 10_000).split("<")[0]
    return s.rsplit("::", 1)[-1].strip()


def busy_and_gaps(ops, t0: float, t1: float, spans):
    """The union of the ops' intervals within [t0, t1] (busy seconds), and
    the idle gaps summed by label: the span (label, start, end) in which
    the gap began, and the op that ended it ("end of window" for the last)."""
    busy, gaps = 0.0, defaultdict(float)
    cur = t0
    for op in sorted(ops, key=lambda o: o.start):
        s, e = max(op.start, t0), min(op.end, t1)
        if e <= cur:
            continue
        if s > cur:
            gaps[f"{_span_at(spans, cur)} before {short_name(op.name, 60)}"] += s - cur
            cur = s
        busy += e - cur
        cur = e
    if t1 > cur:
        gaps[f"{_span_at(spans, cur)} before end of window"] += t1 - cur
    return busy, sorted(gaps.items(), key=lambda kv: -kv[1])


def _span_at(spans, t: float) -> str:
    for label, s, e in spans:
        if s <= t < e:
            return label
    return "between spans"


def traced_call(fn, handle, counters):
    """Run fn() once under the profiler, then handle(result), each in a span
    of its own; counters = (reset, read) of the program's launch counter.
    Returns (result, Trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    reset, read = counters
    torch.cuda.synchronize()
    reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_mark = time.perf_counter()
        torch.cuda._sleep(1000)                       # the marker on the device's timeline
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        handle(res)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    shapes = read()
    dev = sorted((e for e in prof.events() if "CUDA" in str(getattr(e, "device_type", ""))),
                 key=lambda e: e.time_range.start)
    marks = [e for e in dev if "spin_kernel" in e.name]
    mark_us = marks[0].time_range.start if marks else (dev[0].time_range.start if dev else 0.0)
    # seconds since t0 on the host's clock: the marker started at t_mark
    shift = (t_mark - t0) - mark_us * 1e-6
    ops = [Op(e.name, e.time_range.start * 1e-6 + shift, e.time_range.end * 1e-6 + shift)
           for e in dev if not (marks and e is marks[0])]
    spans = [("call", 0.0, t1 - t0), ("result", t1 - t0, t2 - t0)]
    busy, gaps = busy_and_gaps(ops, 0.0, t2 - t0, spans)
    return res, Trace(ops=ops, window_s=t2 - t0, busy_s=busy, gaps=gaps, launch_shapes=shapes,
                      marker_found=bool(marks))
