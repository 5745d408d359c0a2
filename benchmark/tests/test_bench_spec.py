"""BENCHMARK.json and the files it names: each loads by name, and the
frozen yardsticks (roofline arithmetic, trace reading, traffic keys)
give what they should."""

from __future__ import annotations

import importlib
import json
import re
from types import SimpleNamespace

import pytest

from benchmark import core, devtrace, roofline, traffic
from bench_tiny import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_workload_loads_with_its_files(workload):
    cell = core.load_cell(REPO, workload)
    assert cell.chips == 1
    importlib.import_module(f"benchmark.drive.{cell.config['drive']}")
    ref = importlib.import_module(f"benchmark.reference.{cell.config['reference']}")
    assert ref.Reference(cell.config).truth > 0
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    # every cell reports setup_s, one more end-to-end metric and a per-layer one
    names = [n for n, _ in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_every_metric_file_loads_by_name(metric):
    assert callable(core._reader(REPO, metric))


def test_spec_keeps_to_the_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[group]]
        assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        # a per-layer metric's cells all report the metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    for c in SPEC["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == [] and c["source"] == cfg["source"]


def test_the_roofline_arithmetic_gives_the_recorded_bounds():
    # PERF.md's kernel table, chip_smoke.py's bounds at the shapes it recorded (µs)
    assert roofline.batched_bound(1022, 170, 1, 10) == pytest.approx(4.65, rel=2e-3)
    assert roofline.batched_bound(254, 170, 1, 10) == pytest.approx(1.155, rel=2e-3)
    assert roofline.batched_bound(4, 1300, 1, 20) == pytest.approx(0.263, rel=3e-3)
    assert roofline.batched_bound(20, 1300, 1, 20) == pytest.approx(1.313, rel=2e-3)
    assert roofline.batched_bound(4, 1300, 1, 20, esz=4) == pytest.approx(0.132, rel=5e-3)
    assert roofline.lookup_bound(2, 1022 * 54, 17) == pytest.approx(0.330, rel=3e-3)
    assert roofline.lookup_bound(2, 254 * 54, 17) == pytest.approx(0.082, rel=7e-3)
    assert roofline.mvn_bound(1, 1300, 6, 65) == pytest.approx(0.0127, rel=5e-3)
    assert roofline.mvn_bound(1, 26000, 6, 65) == pytest.approx(0.249, rel=3e-3)
    assert roofline.mvn_bound(4, 1300, 6, 65) == pytest.approx(0.050, rel=1e-2)
    assert roofline.integrand_bound("C", 43180, 255, 17) == pytest.approx(13.25, rel=1e-3)
    assert roofline.integrand_bound("C", 1950, 5, 65) == pytest.approx(0.0166, rel=5e-3)


def _trace(ops, shapes):
    return SimpleNamespace(ops=[devtrace.Op(*o) for o in ops], launch_shapes=shapes)


def test_roofline_share_reads_counter_and_device_time():
    b = roofline.batched_bound(4, 1300, 1, 20)
    name = "void score_fiber_batched_cluster_kernel<double>(double const*, int)"
    tr = _trace([(name, 0.0, 2 * b * 1e-6), (name, 1.0, 1.0 + 2 * b * 1e-6)],
                {"score_residual_argmax_batched": {(4, 1300, 1, 20): 2}})
    assert roofline.share(tr, "score_batched") == pytest.approx(50.0)
    # the profiler recorded one of two launches: the bound of one
    tr.ops = tr.ops[:1]
    assert roofline.share(tr, "score_batched") == pytest.approx(50.0)
    assert roofline.share(tr, "mvn_pdf_fused") is None
    tr.launch_shapes = {}
    assert roofline.share(tr, "score_batched") is None


def test_op_names_and_busy_time_and_gaps():
    long = ("void at::native::(anonymous namespace)::foo_kernel<double, 4>"
            "(at::TensorIteratorBase&, double)")
    assert devtrace.short_name(long) == "at::native::anon::foo_kernel<double, 4>"
    assert devtrace.base_name(long) == "foo_kernel"
    assert devtrace.base_name("void lookup_kernel<double>(double const*, int)") == "lookup_kernel"
    assert devtrace.short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    ops = [devtrace.Op("a(x)", 0.1, 0.3), devtrace.Op("b(x)", 0.2, 0.4), devtrace.Op("c(x)", 0.7, 0.8)]
    busy, gaps = devtrace.busy_and_gaps(ops, 0.0, 1.0, [("call", 0.0, 0.5), ("result", 0.5, 1.0)])
    assert busy == pytest.approx(0.4)
    assert dict(gaps) == pytest.approx({"call before a": 0.1, "call before c": 0.3,
                                        "result before end of window": 0.2})


def test_traffic_keys_follow_the_seed_alone():
    big = 2 ** 33 + 17
    assert traffic.call_key(big, 3) == traffic.call_key(big, 3)
    keys = {traffic.call_key(big, i) for i in range(50)} | {traffic.warmup_key(big)}
    assert len(keys) == 51 and all(0 <= k < 2 ** 63 for k in keys)
    assert traffic.call_key(big, 0) != traffic.call_key(big + 1, 0)
    for name in ("scen1024", "scen1024_jacobi", "rb_chain"):
        assert traffic.load(REPO / "benchmark" / "traffic" / f"{name}.json")["loop"] == "closed"


def test_the_import_check_compares_whole_top_level_names():
    mods = {"ttcross_tpu_torch": 1, "ttcross_tpu_torch.cross": 1, "jaxtyping": 1, "numpy": 1}
    assert core.forbidden_modules(modules=mods) == []
    mods.update({"jax.numpy": 1, "ttcross_tpu.cross": 1, "flax": 1})
    assert core.forbidden_modules(modules=mods) == ["flax", "jax.numpy", "ttcross_tpu.cross"]
