"""One traced run of a benchmark cell, and where its traced call's time went
by the program's own spans.

    python3 tools/span_breakdown.py --workload <cell> --seed <n> --seconds <s>

runs benchmark/run.py's --trace 1 run (its result line is printed as the
command prints it), then prints, from benchmark/spans.py: each span name's
calls and its wall, self, busy (some op on the device) and idle
milliseconds; the share of the root's wall that its direct children cover;
the share of the device's idle time in the root that falls in the root's
self time; the traced call's wall against the window's median call (the
cost of tracing on); and a span's cost to the host with no profiler active
and recording under a CUDA-only one.  On the card only, as benchmark/run.py.
"""

from __future__ import annotations

import contextlib
import re
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import core, devtrace, run, spans  # noqa: E402


def _span_cost_us(profiled: bool, n: int = 20_000) -> float:
    """Microseconds a span costs the host, with no profiler active or
    recording under a CUDA-only one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ttcross_tpu_torch.utils import reset_spans, span

    with profile(activities=[ProfilerActivity.CUDA]) if profiled else contextlib.nullcontext():
        t = time.perf_counter()
        for i in range(n):
            with span("engine.sweep", it=i):
                pass
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
    reset_spans()
    return dt / n * 1e6


def main(argv=None) -> int:
    got = {}
    traced, run_cell = devtrace.traced_call, core.run_cell

    def keep_trace(*a, **kw):
        res, tr = traced(*a, **kw)
        got["trace"] = tr
        return res, tr

    def keep_notes(*a, **kw):
        out, notes = run_cell(*a, **kw)
        got["notes"] = notes
        return out, notes

    devtrace.traced_call, core.run_cell = keep_trace, keep_notes
    rc = run.main(list(argv if argv is not None else sys.argv[1:]) + ["--trace", "1"])
    if rc != 0 or "trace" not in got:
        return rc or 1
    return report(got["trace"], got["notes"])


def report(tr, notes) -> int:
    """Print the traced call's spans against the trace tr; notes: the run's
    lines for standard error, which give each window call's wall time."""
    rows = spans.table(tr)
    if rows is None:
        print("the program recorded no span", file=sys.stderr)
        return 1
    print(f"{'span':<16}{'calls':>7}{'wall ms':>11}{'self ms':>11}{'busy ms':>11}{'idle ms':>11}")
    for name, calls, wall, self_s, busy, idle in rows:
        print(f"{name:<16}{calls:>7}{1e3 * wall:>11.3f}{1e3 * self_s:>11.3f}"
              f"{1e3 * busy:>11.3f}{1e3 * idle:>11.3f}")
    sp = spans.call_spans(tr)
    root = sp[0]
    kids = sum(s.wall_s for s in sp if s.parent == 0)
    kid_idle = sum(s.idle_s for s in sp if s.parent == 0)
    walls = [float(m.group(1)) for line in notes
             if (m := re.search(r"wall ([0-9.]+) s,", line))]
    print(f"root {root.name} wall {1e3 * root.wall_s:.3f} ms; direct children cover "
          f"{100 * kids / root.wall_s:.2f} %; device idle in the root {1e3 * root.idle_s:.3f} ms, "
          f"of it in the root's self time {100 * (root.idle_s - kid_idle) / root.idle_s:.2f} %")
    print(f"spans in the call {len(sp)}; the traced call {1e3 * root.wall_s:.3f} ms (window "
          f"{1e3 * tr.window_s:.3f} ms with its result handling) against the "
          f"window's median call {1e3 * statistics.median(walls):.3f} ms over {len(walls)} calls")
    print(f"a span with no profiler active: {_span_cost_us(False):.3f} us; recording under a "
          f"CUDA-only profiler: {_span_cost_us(True):.3f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
