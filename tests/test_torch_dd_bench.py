"""The double-double deployment of the benchmark (cell ising_c6_dd_r64.dd_solve)
on the CPU: the plain decimal reference against the port's dd integrand and
rule, the spans and pivots of cross_dd (cross/engine_dd.py) under a profiler
session and without one, the cell's span- and counter-read metrics, the
frozen dd roofline bounds against chip_smoke.py's, a tiny dd cell that runs
correct through the harness while its float64 control does not, and the
reference's imports."""

import json
import shutil
import subprocess
import sys
import time
from decimal import Decimal, localcontext
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from benchmark import core, devtrace, roofline_dd
from benchmark.reference import tt_check_qd
from benchmark.reference.ising_c6_dd import PREC, Reference
from ttcross_tpu_torch.apps import ISING_C_STR, make_ising_dd
from ttcross_tpu_torch.cross import cross_dd
from ttcross_tpu_torch.utils import reset_spans, spans
from torch_qd_helpers import one_torch_thread  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parents[1]
CELL = "ising_c6_dd_r64.dd_solve"
SMALL = dict(m=4, n=17, max_rank=8)
SEED = 2 ** 33 + 77
SPAN_NAMES = {"cross_dd", "engine.init", "engine.sweep", "engine.hunt", "engine.accept",
              "engine.value", "dd.solve"}


def _decimal(limbs):
    """Each entry's limbs (leading first) summed into a Decimal."""
    return tt_check_qd.to_decimal([np.asarray(torch.as_tensor(e).cpu(), np.float64)
                                   for e in limbs])


def _gap(port, ref):
    with localcontext() as ctx:
        ctx.prec = PREC
        return max(abs(p - r) / abs(r) for p, r in zip(port, ref))


@pytest.mark.parametrize("n", [17, 65])
def test_reference_integrand_matches_the_port_dd_integrand(n):
    ref = Reference({"kind": "C", "m": 6, "n": n, "truth": ISING_C_STR[6]})
    _, fun_dd, _, _ = make_ising_dd(m=6, n=n, device="cpu")
    ind = np.random.default_rng(n).integers(0, n, (512, 5))
    port = _decimal(fun_dd(torch.from_numpy(ind.astype(np.int32))))
    assert _gap(port, ref.integrand(ind)) <= Decimal("1e-29")


@pytest.mark.parametrize("n", [9, 17, 33])
def test_reference_rule_matches_the_port_dd_rule(n):
    ref = Reference({"kind": "C", "m": 6, "n": n, "truth": ISING_C_STR[6]})
    _, fun_dd, wh, wl = make_ising_dd(m=6, n=n, device="cpu")
    tables = fun_dd.tables
    nodes, scaled = _decimal(tables[:2]), _decimal(tables[2:])
    assert _gap(nodes, ref.nodes) <= Decimal("1e-30")          # a few dd ulps
    assert _gap(scaled, ref.scaled) <= Decimal("1e-30")
    assert _gap(_decimal([wh[0], wl[0]]), ref.quad[0]) == 0


def _run():
    _, fun_dd, wh, wl = make_ising_dd(m=SMALL["m"], n=SMALL["n"], device="cpu")
    return cross_dd(fun_dd, [SMALL["n"]] * (SMALL["m"] - 1), wh, wl,
                    max_rank=SMALL["max_rank"], pivoting=1, key=SEED, device="cpu")


@pytest.fixture(scope="module")
def runs():
    """cross_dd at SMALL without a profiler, then under a CPU-only one:
    (plain result, profiled result, the profiled run's span records)."""
    plain = _run()
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _run()
    return plain, traced, spans()


def test_spans_change_nothing(runs):
    plain, traced, _ = runs
    assert [float(e) for e in traced.value] == [float(e) for e in plain.value]
    assert (traced.neval, traced.sweeps, traced.ranks) == (plain.neval, plain.sweeps, plain.ranks)
    assert np.array_equal(traced.vip, plain.vip)
    for a, b in zip(traced.cores_hi + traced.cores_lo, plain.cores_hi + plain.cores_lo):
        assert np.array_equal(a, b)


def test_span_tree(runs):
    _, res, recs = runs
    assert {r.name for r in recs} == SPAN_NAMES
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert len(roots) == 1 and recs[roots[0]].name == "cross_dd"
    assert recs[0].attrs == {"d": 3, "n": (17, 17, 17), "max_rank": 8}
    kids = [r for r in recs if r.parent == 0]
    assert [r.name for r in kids] == (["engine.init"] + ["engine.sweep"] * res.sweeps
                                      + ["dd.solve", "engine.value"])
    sweeps = [i for i, r in enumerate(recs) if r.name == "engine.sweep"]
    assert [recs[i].attrs["it"] for i in sweeps] == list(range(1, res.sweeps + 1))
    for k, i in enumerate(sweeps):
        below = [r for r in recs if r.parent == i]
        bonds = [0, 1] if k % 2 == 0 else [1, 0]          # '>>' on odd it
        assert [(r.name, r.attrs["bond"]) for r in below] == [
            (name, b) for b in bonds for name in ("engine.hunt", "engine.accept")]
    root = recs[0]
    covered = sum(r.end - r.start for r in kids)
    assert covered >= 0.99 * (root.end - root.start)


def test_verbose_sweeps_record_their_values(capsys):
    _, fun_dd, wh, wl = make_ising_dd(m=4, n=9, device="cpu")
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        res = cross_dd(fun_dd, [9] * 3, wh, wl, max_rank=4, pivoting=1, key=SEED,
                       verbose=True, truth=ISING_C_STR[4], device="cpu")
    recs = spans()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if " dd lg(pivotmax)" in ln]
    assert len(lines) == res.sweeps
    values = [r for r in recs if r.name == "engine.value"]
    assert len(values) == res.sweeps + 1
    assert all(recs[r.parent].name == "engine.sweep" for r in values[:-1])
    assert values[-1].parent == 0


def test_vip_rebuilds_the_cross_points(runs):
    """The pivots as tt_check.pivot_sets reads them: the dd train
    reproduces the port's own dd integrand at every cross point."""
    _, res, _ = runs
    assert res.vip.shape == (2, SMALL["max_rank"], 4)
    n = SMALL["n"]
    _, fun_dd, _, _ = make_ising_dd(m=4, n=n, device="cpu")
    grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1).reshape(-1, 3)
    table = _decimal(fun_dd(torch.from_numpy(grid.astype(np.int32)))).reshape(n, n, n)

    def port(ind):
        return [table[tuple(row)] for row in np.asarray(ind).tolist()]

    cores = [_decimal(g) for g in zip(res.cores_hi, res.cores_lo)]
    assert tt_check_qd.interp_gap(cores, res.vip, res.ranks, port) < 1e-29


def _trace_of(recs, sweeps, ops=(), launch_shapes=None):
    ends = [r.end for r in recs]
    return devtrace.Trace(ops=list(ops), window_s=max(ends) - recs[0].start, busy_s=0.0, gaps=[],
                          launch_shapes=launch_shapes or {}, marker_found=False, sweeps=sweeps)


def _read(name, trace=None, calls=()):
    return core._reader(REPO, name)(core.Run(setup_s=0.0, window_s=1.0, calls=list(calls),
                                             trace=trace))


def test_span_metrics_read_the_profiled_call(runs, monkeypatch):
    from benchmark import spans as bench_spans

    _, res, recs = runs
    monkeypatch.setattr(bench_spans, "program_spans", lambda: recs)
    walls = [r.end - r.start for r in recs if r.name == "engine.sweep"]
    value = _read("sweep_span_ms.dd", _trace_of(recs, res.sweeps))
    assert value == pytest.approx(1e3 * sum(walls) / len(walls))
    assert _read("sweep_span_ms.dd", None) is None
    # no device op in the CPU call: every sweep is the host's
    assert _read("sweep_idle_pct.solve", _trace_of(recs, res.sweeps)) == pytest.approx(100.0)
    assert _read("sweep_idle_pct.solve", None) is None


def test_counter_metrics_read_the_window(runs):
    _, res, recs = runs
    calls = [core.CallRecord(i, i, 0.1, 1, res.neval + i, res.sweeps, [0.5]) for i in range(3)]
    assert _read("evals_per_integral.dd", calls=calls) == res.neval + 1
    assert _read("sweep_ms.solve", calls=calls) == pytest.approx(1e3 * 0.3 / (3 * res.sweeps))
    ops = [devtrace.Op(f"k{i}", 0.001 * i, 0.001 * i + 0.0005) for i in range(6)]
    tr = _trace_of(recs, res.sweeps, ops)
    tr.busy_s = 0.003
    assert _read("kernels_per_sweep.dd", tr) == 6 / res.sweeps
    assert _read("device_idle_pct.dd", tr) == pytest.approx(100 * (1 - 0.003 / tr.window_s))


@pytest.mark.parametrize("metric,kernel", [("dd_score_roofline", "dd_score"),
                                           ("dd_dot_roofline", "dd_dot"),
                                           ("ising_dd_roofline", "ising_dd")])
def test_roofline_metrics_follow_the_share_rule(metric, kernel):
    wrapper, names, bound = roofline_dd.KERNELS[kernel]
    shape = {"dd_score": (4160, 64), "dd_dot": (64, 65, 64), "ising_dd": (4160, 5, 65)}[kernel]
    ops = [devtrace.Op(f"void (anonymous namespace)::{names[0]}(int)", 0.0, 2e-5),
           devtrace.Op(f"void (anonymous namespace)::{names[-1]}(int)", 1e-4, 1.3e-4),
           devtrace.Op("at::native::other_kernel", 2e-4, 3e-4)]
    tr = devtrace.Trace(ops=ops, window_s=1e-3, busy_s=2e-4, gaps=[], sweeps=1,
                        launch_shapes={wrapper: {shape: 2}}, marker_found=True)
    assert [op.base in names for op in ops] == [True, True, False]
    want = 100 * 2 * bound(shape) * 1e-6 / 5e-5
    assert _read(metric, tr) == pytest.approx(want)
    tr.launch_shapes = {wrapper: {shape: 4}}              # two of four launches recorded
    assert _read(metric, tr) == pytest.approx(want)
    tr.launch_shapes = {}
    assert _read(metric, tr) is None
    assert _read(metric, None) is None


@pytest.mark.cuda
def test_metrics_read_a_traced_call_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the dd kernels and their trace run only on the GPU")
    from ttcross_tpu_torch.ops import kernels as K

    _, fun_dd, wh, wl = make_ising_dd(m=4, n=17, device="cuda")
    res, tr = devtrace.traced_call(
        lambda: cross_dd(fun_dd, [17] * 3, wh, wl, max_rank=8, key=SEED, device="cuda"),
        lambda r: None, (K.reset_launch_counts, K.launch_shapes))
    tr.sweeps = res.sweeps
    for name in ("sweep_span_ms.dd", "kernels_per_sweep.dd", "device_idle_pct.dd",
                 "sweep_idle_pct.solve", "dd_score_roofline", "dd_dot_roofline",
                 "ising_dd_roofline"):
        value = _read(name, tr)
        assert value is not None and value > 0, name
        if name.endswith("roofline"):
            assert value <= 100, (name, value)


# Every shape the cell launched each kernel at in one solve on the card
# (ops/kernels.py::launch_shapes(), C_6, n 65, rank 64; the final ranks
# (1, 31, 64, 64, 32, 1)), then chip_smoke.py's kernel tables.
CELL_SHAPES = {
    "dd_score_residual_argmax": [(258, 64), (4160, 64), (64, 64)],
    "dd_dot": [(65, 64, 64), (64, 65, 64), (4160, 64, 64), (64, 4160, 64), (1, 31, 65), (1, 31, 1),
               (31, 64, 65), (1, 64, 31), (64, 64, 65), (1, 64, 64), (64, 32, 65), (1, 32, 64),
               (32, 1, 65), (1, 1, 32)],
    "ising_c_integrand_dd_fused": [(520, 5, 65), (325, 5, 65), (258, 5, 65), (4160, 5, 65)],
}


@pytest.mark.parametrize("kernel,name", [("dd_score", "dd_score_residual_argmax"),
                                         ("dd_dot", "dd_dot"),
                                         ("ising_dd", "ising_c_integrand_dd_fused")])
def test_frozen_dd_bounds_are_chip_smokes(kernel, name):
    import chip_smoke

    wrapper, _, bound = roofline_dd.KERNELS[kernel]
    assert wrapper == name
    assert set(roofline_dd.KERNELS[kernel][1]) == set(chip_smoke.DD_KERNEL_SYMBOLS[name])
    for shape in CELL_SHAPES[name] + list(chip_smoke.DD_TABLES[name]):
        assert bound(shape) == chip_smoke._dd_bound(name, shape)[0]


# ------------------------------------------------------------ a tiny dd cell
TINY = "tiny_dd.solve"
TINY_LIMITS = {"interp_gap": 1e-24, "value_gap": 1e-24, "err_worst": 1e-9}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout-like root with the benchmark and a tiny dd cell (C_4, n 17,
    rank 8) added as a later change would: new files and entries only.  At
    this size the rank, not the tier, sets |1 - value / truth| (about 1e-10
    for both tiers), so err_worst's limit is 1e-9 and the gaps tell the
    tiers apart: about 1e-31 in dd, 1e-16 to 1e-14 in the float64 control."""
    root = tmp_path_factory.mktemp("bench_dd") / "root"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "ising_c6_dd_r64.json").read_text())
    cfg.update(m=SMALL["m"], n=SMALL["n"], max_rank=SMALL["max_rank"], truth=ISING_C_STR[4])
    _write(bench / "configs" / "tiny_dd.json", cfg)
    _write(bench / "limits" / f"{TINY}.json", {"limits": TINY_LIMITS, "set_from": "tests"})
    spec["configs"].append({"name": "tiny_dd", "source": "tests",
                            "file": "benchmark/configs/tiny_dd.json",
                            "reduced": ["m", "n", "max_rank"], "why": "CPU size"})
    spec["workloads"].append({"name": TINY, "config": "tiny_dd", "traffic": "dd_solve",
                              "chips": 1, "why": "t"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"] = m["workloads"] + [TINY]
    _write(root / "BENCHMARK.json", spec)
    return root


def _run_tiny(root, **kw):
    return core.run_cell(core.load_cell(root, TINY), 2 ** 33 + 41, 0.3, False, "cpu",
                         time.perf_counter(), **kw)


def test_the_tiny_dd_cell_is_correct(tiny_root):
    out, notes = _run_tiny(tiny_root)
    assert out["correct"], notes[-4:]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"solve_s", "setup_s"}
    assert out["checks"]["interp_gap"]["value"] < 1e-29
    assert out["checks"]["value_gap"]["value"] < 1e-29


def test_the_f64_control_is_not_correct(tiny_root):
    out, notes = _run_tiny(tiny_root, dtype=torch.float32)
    assert not out["correct"], notes[-4:]
    failed = {k for k, c in out["checks"].items() if not c["value"] <= c["limit"]}
    assert {"interp_gap", "value_gap"} <= failed


def test_the_cell_is_declared():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in spec["workloads"]}[CELL]
    cfg = json.loads((REPO / "benchmark" / "configs" / "ising_c6_dd_r64.json").read_text())
    assert (cell["chips"], cfg["m"], cfg["n"], cfg["max_rank"]) == (1, 6, 65, 64)
    assert (cfg["pivoting"], cfg["reduced"]) == (1, [])
    assert cfg["truth"] == ISING_C_STR[6]
    reported = core.load_cell(REPO, CELL)
    assert [m for m, _ in reported.end_to_end] == ["solve_s", "setup_s"]
    assert {m for m, _ in reported.per_layer} == {
        "sweep_span_ms.dd", "kernels_per_sweep.dd", "device_idle_pct.dd", "evals_per_integral.dd",
        "dd_score_roofline", "dd_dot_roofline", "ising_dd_roofline", "sweep_ms.solve",
        "sweep_idle_pct.solve"}
    for name, _ in reported.per_layer:
        assert (REPO / "benchmark" / "metrics" / f"{name}.py").exists()


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import benchmark.reference.ising_c6_dd, benchmark.reference.tt_check_qd, "
            "benchmark.roofline_dd; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('ttcross_tpu_torch', 'ttcross_tpu', 'jax', 'jaxlib')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_drive_imports_nothing_of_jax():
    code = ("import sys; import benchmark.drive.ising_dd; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('ttcross_tpu', 'jax', 'jaxlib')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
