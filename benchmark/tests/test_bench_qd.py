"""The quad-double cell's check at a CPU size: a tiny qd cell (C_4, n 17,
rank 10: chip_smoke.py's QD_SMALL) runs correct through core.run_cell, and
the check fails what it should there: the tier below (cross_dd, the check's
control), a fault that drops the last two limbs of every integrand value
(dd precision) and one that drops them from each reported value.

At n 17 the quadrature, not the tier, sets |1 - value / truth| (about 1e-12
for both tiers), so the tiny cell's err_worst limit is 1e-10 and the two
gaps tell the tiers apart: at most 2e-64 for qd, at least 6e-33 for dd on
these runs, against limits of 1e-45.  A train built from dd-precision
integrand values is self-consistent, so only interp_gap sees that fault; a
value rounded after the train is built, only value_gap."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from benchmark import core
from bench_tiny import REPO

CELL = "tiny_qd.solve"
LIMITS = {"interp_gap": 1e-45, "value_gap": 1e-45, "err_worst": 1e-10}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_qd_root(tmp: Path) -> Path:
    """A checkout-like root under tmp with the benchmark and a tiny qd cell
    added as a later change to the benchmark would: new files and new
    entries only."""
    root = Path(tmp) / "root"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "ising_c4_qd_r55.json").read_text())
    cfg.update(n=17, max_rank=10)
    _write(bench / "configs" / "tiny_qd.json", cfg)
    _write(bench / "limits" / f"{CELL}.json", {"limits": LIMITS, "set_from": "tests"})
    spec["configs"].append({"name": "tiny_qd", "source": "tests",
                            "file": "benchmark/configs/tiny_qd.json",
                            "reduced": ["n", "max_rank"], "why": "CPU size"})
    spec["workloads"].append({"name": CELL, "config": "tiny_qd", "traffic": "qd_solve",
                              "chips": 1, "why": "t"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "ising_c4_qd_r55.qd_solve" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + [CELL]
    _write(root / "BENCHMARK.json", spec)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # thousands of small qd ops: one thread each
    yield make_qd_root(tmp_path_factory.mktemp("bench_qd"))
    torch.set_num_threads(n)


def _run(root, seed=2 ** 33 + 41, **kw):
    return core.run_cell(core.load_cell(root, CELL), seed, 0.3, False, "cpu", time.perf_counter(),
                         **kw)


def _failed(out):
    return {k for k, c in out["checks"].items() if not c["value"] <= c["limit"]}


def test_the_tiny_qd_cell_is_correct(root):
    out, notes = _run(root)
    assert out["correct"], notes[-4:]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"solve_s", "setup_s"}
    assert out["checks"]["interp_gap"]["value"] < 1e-60


def test_the_dd_control_is_not_correct(root):
    out, notes = _run(root, dtype=torch.float32)
    assert not out["correct"], notes[-4:]
    assert {"interp_gap", "value_gap"} <= _failed(out)


def _dd_integrand(monkeypatch):
    from ttcross_tpu_torch.apps import ising
    from ttcross_tpu_torch.ops.qd import QD

    orig = ising.IsingQD.__call__

    def dropped(self, ind):
        v = orig(self, ind)
        return QD(v.e0, v.e1, torch.zeros_like(v.e2), torch.zeros_like(v.e3))

    monkeypatch.setattr(ising.IsingQD, "__call__", dropped)


def _dd_answer(monkeypatch):
    from ttcross_tpu_torch.cross import engine_qd
    from ttcross_tpu_torch.ops.qd import QD

    orig = engine_qd.qd_tt_value

    def dropped(*a, **kw):
        v = orig(*a, **kw)
        return QD(v.e0, v.e1, torch.zeros_like(v.e2), torch.zeros_like(v.e3))

    monkeypatch.setattr(engine_qd, "qd_tt_value", dropped)


@pytest.mark.parametrize("fault,caught", [(_dd_integrand, "interp_gap"),
                                          (_dd_answer, "value_gap")],
                         ids=["integrand_limbs_dropped", "answer_limbs_dropped"])
def test_dropped_limbs_are_not_correct(root, monkeypatch, fault, caught):
    fault(monkeypatch)
    out, notes = _run(root)
    assert not out["correct"], notes[-4:]
    assert caught in _failed(out)
