"""benchmark/spans.py and the four span-read metrics on a synthetic trace
and synthetic spans: the last root span moved onto the trace's clock, each
span's wall, self, busy and idle time, and None wherever there is nothing
to read (no trace, no spans, a program without the recorder)."""

from __future__ import annotations

import sys
import types

import pytest

from benchmark import core, devtrace, spans
from benchmark.core import Run
from bench_tiny import REPO
from ttcross_tpu_torch.utils.metrics import SpanRecord

T0 = 100.0          # the root's start on the host's clock


def _records():
    """An earlier call (indices 0-1), then the traced one (from index 2)."""
    def rec(name, s, e, parent, **attrs):
        return SpanRecord(name, T0 + s, T0 + e, parent, 2, attrs)

    earlier = [SpanRecord("cross_batch", 1.0, 2.0, None, 0, {}),
               SpanRecord("engine.sweep", 1.1, 1.9, 0, 0, {"it": 1})]
    return earlier + [
        rec("cross_batch", 0.0, 1.0, None, lanes=4),       # 2
        rec("entry.uniforms", 0.001, 0.401, 2),            # 3
        rec("entry.upload", 0.3, 0.4, 3, bytes=64),        # 4
        rec("engine.init", 0.401, 0.451, 2),               # 5
        rec("engine.sweep", 0.5, 0.7, 2, it=1),            # 6
        rec("engine.hunt", 0.5, 0.6, 6, bond=0),           # 7
        rec("engine.accept", 0.6, 0.65, 6),                # 8
        rec("engine.sweep", 0.7, 0.9, 2, it=2),            # 9
        rec("entry.results", 0.9, 0.999, 2, lanes=4),      # 10
    ]


def _trace():
    ops = [devtrace.Op("Memcpy HtoD", 0.3, 0.4), devtrace.Op("a", 0.55, 0.6),
           devtrace.Op("b", 0.58, 0.62), devtrace.Op("c", 0.75, 0.8),
           devtrace.Op("d", 0.95, 0.97)]
    return devtrace.Trace(ops=ops, window_s=1.0, busy_s=0.0, gaps=[], launch_shapes={},
                          marker_found=True, sweeps=2)


def test_the_last_root_is_moved_onto_the_trace_clock():
    got = spans.call_spans(_trace(), _records())
    assert [sp.name for sp in got] == ["cross_batch", "entry.uniforms", "entry.upload",
                                       "engine.init", "engine.sweep", "engine.hunt",
                                       "engine.accept", "engine.sweep", "entry.results"]
    assert [sp.parent for sp in got] == [None, 0, 1, 0, 0, 4, 4, 0, 0]
    assert got[0].start == 0.0 and got[0].end == pytest.approx(1.0)
    assert got[0].attrs == {"lanes": 4} and got[4].attrs == {"it": 1}
    want = {  # index: (wall, self, busy)
        0: (1.0, 1.0 - 0.4 - 0.05 - 0.2 - 0.2 - 0.099, 0.1 + 0.07 + 0.05 + 0.02),
        1: (0.4, 0.3, 0.1), 2: (0.1, 0.1, 0.1), 3: (0.05, 0.05, 0.0),
        4: (0.2, 0.05, 0.07), 5: (0.1, 0.1, 0.05), 6: (0.05, 0.05, 0.02),
        7: (0.2, 0.2, 0.05), 8: (0.099, 0.099, 0.02)}
    for k, (wall, self_s, busy) in want.items():
        sp = got[k]
        assert (sp.wall_s, sp.self_s, sp.busy_s) == pytest.approx((wall, self_s, busy), abs=1e-9)
        assert sp.idle_s == pytest.approx(wall - busy, abs=1e-9)


def test_the_table_sums_by_name():
    rows = {r[0]: r[1:] for r in spans.table(_trace(), _records())}
    assert list(rows)[:3] == ["cross_batch", "entry.uniforms", "entry.upload"]
    calls, wall, self_s, busy, idle = rows["engine.sweep"]
    assert calls == 2 and (wall, self_s, busy, idle) == pytest.approx((0.4, 0.25, 0.12, 0.28))


def test_nothing_to_read_gives_none(monkeypatch):
    assert spans.call_spans(None, _records()) is None
    assert spans.call_spans(_trace(), []) is None
    assert spans.named(_trace(), "engine.sweep", []) is None and spans.table(None) is None
    # a checkout of the program without the recorder
    monkeypatch.setitem(sys.modules, "ttcross_tpu_torch.utils.metrics", types.ModuleType("m"))
    assert spans.program_spans() is None and spans.call_spans(_trace()) is None


READINGS = {"uniforms_ms": 400.0, "results_ms": 99.0, "sweep_span_ms": 200.0,
            "sweep_idle_pct": 70.0}


@pytest.mark.parametrize("kind", ["family", "solve"])
@pytest.mark.parametrize("metric", sorted(READINGS))
def test_the_span_metrics(metric, kind, monkeypatch):
    read = core._reader(REPO, f"{metric}.{kind}")
    run = Run(setup_s=1.0, window_s=10.0, calls=[], trace=_trace())
    monkeypatch.setattr(spans, "program_spans", _records)
    assert read(run) == pytest.approx(READINGS[metric])
    assert read(Run(setup_s=1.0, window_s=10.0, calls=[], trace=None)) is None
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    assert read(run) is None
    # a call whose root holds no span of the metric's
    monkeypatch.setattr(spans, "program_spans", lambda: _records()[:1])
    assert read(run) is None
