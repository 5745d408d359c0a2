"""The program's own spans in the traced call, on the device trace's clock.

ttcross_tpu_torch records named spans (its ``span()``, in
ttcross_tpu_torch/utils/metrics.py) while a torch.profiler session is
active: a root ``cross`` or ``cross_batch`` around the call, its lottery
draws, sweeps, hunts and results below it.  The traced call of a run
(devtrace.traced_call) is the only profiled call, so its spans are the
last root span of the program's records and the spans of that call.

Both clocks are time.perf_counter(): Trace.ops are seconds since the traced
call began, and the root span opens microseconds after that, so the spans
are moved onto the trace's clock with the root's start at 0.  For each span
this gives its wall time, its self time (wall less the union of its
children), the time some op ran on the device within it (busy) and the
rest (idle).  A checkout of the program that records no span gives None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass

__all__ = ["SpanTime", "program_spans", "call_spans", "named", "table"]


@dataclass
class SpanTime:
    name: str
    attrs: dict
    parent: int | None        # index in call_spans()'s list
    start: float              # seconds on the trace's clock
    end: float
    self_s: float = 0.0
    busy_s: float = 0.0

    @property
    def wall_s(self) -> float:
        return self.end - self.start

    @property
    def idle_s(self) -> float:
        return self.wall_s - self.busy_s


def program_spans():
    """The program's span records, or None where it has no recorder."""
    try:
        from ttcross_tpu_torch.utils.metrics import spans
    except ImportError:
        return None
    return spans()


def _union(intervals):
    """Disjoint sorted (start, end) pairs covering the intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(merged, starts, s, e) -> float:
    """Seconds of [s, e] inside the disjoint sorted intervals merged."""
    total = 0.0
    for a, b in merged[max(bisect.bisect_right(starts, s) - 1, 0):]:
        if a >= e:
            break
        total += max(0.0, min(b, e) - max(a, s))
    return total


def call_spans(trace, records=None):
    """The spans of the traced call (the last root span and every span of
    its call, in opening order) on the trace's clock, each with its self,
    busy and idle time; None without a trace or without spans."""
    if trace is None:
        return None
    records = program_spans() if records is None else records
    roots = [i for i, r in enumerate(records or []) if r.parent is None and r.end is not None]
    if not roots:
        return None
    root = roots[-1]
    t0 = records[root].start
    index, out = {}, []
    for i, r in enumerate(records[root:], root):
        if r.call != root or r.end is None:
            continue
        index[i] = len(out)
        out.append(SpanTime(r.name, dict(r.attrs), index.get(r.parent), r.start - t0, r.end - t0))
    kids = defaultdict(list)
    for sp in out:
        if sp.parent is not None:
            kids[sp.parent].append((sp.start, sp.end))
    busy = _union((op.start, op.end) for op in trace.ops)
    starts = [a for a, _ in busy]
    for k, sp in enumerate(out):
        sp.self_s = sp.wall_s - sum(min(e, sp.end) - max(s, sp.start)
                                    for s, e in _union(kids[k]))
        sp.busy_s = _overlap(busy, starts, sp.start, sp.end)
    return out


def named(trace, name: str, records=None):
    """The traced call's spans called name (a list, maybe empty), or None
    without a trace or without spans."""
    spans = call_spans(trace, records)
    return None if spans is None else [sp for sp in spans if sp.name == name]


def table(trace, records=None):
    """Rows (name, calls, wall, self, busy, idle seconds) summed by span
    name, in the order the names first open; None without spans."""
    spans = call_spans(trace, records)
    if spans is None:
        return None
    rows = {}
    for sp in spans:
        row = rows.setdefault(sp.name, [sp.name, 0, 0.0, 0.0, 0.0, 0.0])
        row[1] += 1
        row[2] += sp.wall_s
        row[3] += sp.self_s
        row[4] += sp.busy_s
        row[5] += sp.idle_s
    return [tuple(r) for r in rows.values()]
