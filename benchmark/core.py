"""The harness of the port's benchmark: one cell, one run.

BENCHMARK.json at the root of the checkout names the cells ("workloads"),
their configurations and the metrics.  Everything that belongs to one of
them sits in files of its own under benchmark/, found by name:

    configs/<config>.json       the configuration as it is run; its "drive"
                                and "reference" name the two modules below
    drive/<drive>.py            how a call of the port is made and judged
    reference/<reference>.py    the plain reference the check holds it to
    traffic/<traffic>.json      the traffic mix (traffic.py reads it)
    limits/<cell>.json          the limit of each number the check compares
    metrics/<metric>.py         read(run) -> the metric's value, or None

A run: set-up (the port's kernels built or loaded, the problem made on the
card, one warm-up call at the cell's shapes), then a window of closed-loop
calls for the given seconds, then with --trace 1 one more call under the
profiler, then the check of the window's answers against the reference, and
the result line.  Nothing here is particular to one cell.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

from . import devtrace
from . import traffic as traffic_mod

__all__ = ["FORBIDDEN", "forbidden_modules", "Cell", "load_cell", "CallRecord", "Run",
           "run_cell", "main"]

FORBIDDEN = ("jax", "jaxlib", "flax", "ttcross_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules (of ``modules``, default sys.modules) whose
    top-level name (before the first dot) is one of FORBIDDEN, compared
    whole: ttcross_tpu_torch is not ttcross_tpu."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in list(mods) if m.split(".")[0] in FORBIDDEN)


@dataclass
class Cell:
    name: str
    root: Path
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list          # [(name, unit)] the cell reports with --trace 0
    per_layer: list           # [(name, unit)] ... with --trace 1


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell named ``workload`` of root/BENCHMARK.json, with its files."""
    root = Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / "benchmark"
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    return Cell(name=workload, root=root, config=json.loads((root / cfg["file"]).read_text()),
                traffic=traffic_mod.load(bench / "traffic" / f"{w['traffic']}.json"),
                chips=int(w["chips"]), limits=limits["limits"],
                end_to_end=[(m["name"], m["unit"]) for m in spec["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[(m["name"], m["unit"]) for m in spec["per_layer"]
                           if _reports(m, workload)])


def _reader(root: Path, metric: str):
    """read(run) of benchmark/metrics/<metric>.py, loaded by its path."""
    path = Path(root) / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class CallRecord:
    index: int
    key: int
    wall: float               # seconds of the call, host clock, ending in a synchronize
    integrals: int            # integrals it answered
    neval: int
    sweeps: int
    values: list              # its answers


@dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    calls: list               # [CallRecord] of the window
    trace: object = None      # devtrace.Trace of the traced call (--trace 1 on the card)


def _digits(err: float) -> float:
    return -math.log10(err) if err > 0 else math.inf


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             dtype=None):
    """One run of the cell: returns (the result line's object, the lines
    for standard error).  ``dtype`` other than the configuration's runs the
    port's lower tier (the check's control); ``device`` "cpu" runs the
    port's plain versions (the tests), with no profiler."""
    import torch

    drv = importlib.import_module(f"benchmark.drive.{cell.config['drive']}")
    ref_mod = importlib.import_module(f"benchmark.reference.{cell.config['reference']}")
    dtype = dtype or getattr(torch, cell.config["dtype"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    notes = []

    prob = drv.setup(cell.config, cell.traffic, dev, dtype)
    per_call = int(prob.integrals_per_call)
    drv.summarize(prob, drv.call(prob, traffic_mod.warmup_key(seed)))
    sync()
    setup_s = time.perf_counter() - t_start

    rng = traffic_mod.sample_rng(seed)
    calls, kept, values = [], [], []
    attempted = failed = 0
    t_win = time.perf_counter()
    deadline = t_win + float(seconds)
    while time.perf_counter() < deadline:
        i = len(calls)
        key = traffic_mod.call_key(seed, i)
        attempted += per_call
        t = time.perf_counter()
        try:
            res = drv.call(prob, key)
            sync()
        except Exception:   # a call that fails is counted and reported, and the run goes on
            notes.append(f"call {i} key {key} failed:\n{traceback.format_exc()}")
            failed += per_call
            calls.append(CallRecord(i, key, time.perf_counter() - t, 0, 0, 0, []))
            continue
        wall = time.perf_counter() - t
        s = drv.summarize(prob, res)
        answered = [v for v in s.values if math.isfinite(v)]
        failed += per_call - len(answered)
        values.extend(answered)
        kept.extend(drv.keep(prob, res, rng))
        calls.append(CallRecord(i, key, wall, len(answered), s.neval, s.sweeps, answered))
        del res
    window_s = time.perf_counter() - t_win
    truth = float(cell.config["truth"])
    for c in calls:
        if c.values:
            dg = sorted(_digits(abs(1.0 - v / truth)) for v in c.values)
            notes.append(f"digits call {c.index} key {c.key}: min {dg[0]:.4f} median "
                         f"{statistics.median(dg):.4f} max {dg[-1]:.4f} over {len(dg)}; "
                         f"wall {c.wall:.6f} s, {c.sweeps} sweeps, {c.neval} evals")

    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    tr = None
    if trace and on_card:
        from ttcross_tpu_torch.ops import kernels as K

        summ = {}
        res, tr = devtrace.traced_call(
            lambda: drv.call(prob, traffic_mod.call_key(seed, len(calls))),
            lambda r: summ.setdefault("s", drv.summarize(prob, r)),
            (K.reset_launch_counts, K.launch_shapes))
        tr.sweeps = summ["s"].sweeps
        if not tr.marker_found:
            notes.append("profiler: no marker kernel; the idle gaps' labels are approximate")
        del res
    if on_card:
        torch.cuda.empty_cache()

    t_chk = time.perf_counter()
    numbers = drv.check(prob, kept, values, ref_mod.Reference(cell.config, dev)) if kept else {}
    notes.append(f"check: {len(kept)} sampled answers and {len(values)} values of "
                 f"{len(calls)} calls in {time.perf_counter() - t_chk:.3f} s")
    checks = {k: {"value": numbers.get(k, math.inf), "limit": float(v)}
              for k, v in cell.limits.items()}
    correct = (attempted > 0 and failed == 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))

    run = Run(setup_s=setup_s, window_s=window_s, calls=calls, trace=tr)
    metrics = {}
    for name, unit in (cell.per_layer if trace else cell.end_to_end):
        value = _reader(cell.root, name)(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": unit}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        by_op = {}
        for op in tr.ops:
            name = devtrace.short_name(op.name)
            by_op[name] = by_op.get(name, 0.0) + op.seconds
        out["breakdown"] = {
            "device_ops": [[k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k, v] for k, v in tr.gaps[:10]]}
    out["checks"] = checks
    notes += [f"{k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return out, notes


def main(args, root: Path, t_start: float) -> int:
    """The command line's run (benchmark/run.py): on the card only."""
    bad = forbidden_modules()
    if bad:
        print(f"refusing to run: loaded {bad}", file=sys.stderr)
        return 3
    cell = load_cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    out, notes = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: no result", file=sys.stderr)
        return 3
    for line in notes:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
