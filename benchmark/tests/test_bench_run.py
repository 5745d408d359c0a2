"""The harness end to end on the CPU: tiny cells added as new files, run
through core.run_cell, give a result line to the contract with correct
true; the command line refuses without the card; a run loads no module of
jax or of the JAX package, and the references nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from benchmark import core
from bench_tiny import DUMMY_METRIC, ISING_CELL, MVN_CELL, REPO, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, trace=False, seed=2 ** 33 + 5, seconds=0.6, **kw):
    return core.run_cell(core.load_cell(root, cell), seed, seconds, trace, "cpu",
                         time.perf_counter(), **kw)


@pytest.mark.parametrize("cell,rate", [(MVN_CELL, "integrals_per_s"), (ISING_CELL, "solve_s")])
def test_a_tiny_cell_runs_end_to_end_and_is_correct(root, cell, rate):
    out, notes = _run(root, cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"], notes[-4:]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {rate, "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"]
        assert notes[-len(out["checks"]):].count(f"{name} {c['value']!r} limit {c['limit']!r}") == 1
    assert any(line.startswith("digits call 0 ") for line in notes)
    json.dumps(out)


def test_the_added_metric_is_read_in_the_traced_run(root):
    out, _ = _run(root, MVN_CELL, trace=True)
    # the per-layer metrics that need no device trace, and the one added by a file
    assert set(out["metrics"]) == {"evals_per_integral.family", "sweep_ms.family", DUMMY_METRIC}
    assert out["metrics"][DUMMY_METRIC]["value"] == 4
    assert "breakdown" not in out and "busy_s" not in out["device"]


def test_a_failed_call_is_counted_and_makes_the_run_incorrect(root, monkeypatch):
    from benchmark.drive import ising_chain

    warm, calls = ising_chain.call, []

    def flaky(prob, key):
        calls.append(key)
        if len(calls) == 1:          # the warm-up call
            return warm(prob, key)
        raise RuntimeError("no answer")

    monkeypatch.setattr(ising_chain, "call", flaky)
    out, notes = _run(root, ISING_CELL, seconds=0.3)
    assert not out["correct"] and out["failed"] == out["attempted"] > 0
    assert any("no answer" in line for line in notes)


def test_the_command_refuses_without_the_card(tmp_path):
    probe = subprocess.run([sys.executable, "-c", "import torch; print(torch.cuda.is_available())"],
                           capture_output=True, text=True, check=True)
    if probe.stdout.strip() == "True":
        pytest.skip("this machine has a CUDA device")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ising_c1024.rb_chain",
                        "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and r.stdout == ""
    assert "needs 1 CUDA device" in r.stderr


def test_a_run_loads_nothing_of_jax_and_the_references_nothing_of_the_program(root):
    code = f"""
import sys, time
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
import benchmark.reference.mvn_basket_d6, benchmark.reference.ising_c1024
import benchmark.reference.tt_check
top = {{m.split('.')[0] for m in sys.modules}}
assert not top & {{'ttcross_tpu_torch', 'ttcross_tpu', 'jax', 'jaxlib', 'flax'}}, top
from benchmark import core
for cell in {[MVN_CELL, ISING_CELL]!r}:
    out, _ = core.run_cell(core.load_cell(Path({str(root)!r}), cell), 3, 0.2, True, 'cpu',
                           time.perf_counter())
    assert out['correct']
print(core.forbidden_modules())
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
