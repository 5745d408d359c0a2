"""Tiny cells of the benchmark for the CPU tests (a helper module, not collected).

make_root(tmp) copies BENCHMARK.json and benchmark/ into tmp and adds two
cells the way a later PR would: new files (a configuration, a traffic mix, a
limits file and a metric each) and new entries of BENCHMARK.json, with no
existing file edited.  The cells are the two configurations' own paths at
CPU sizes: an MVN family of 4 lanes in d = 3, and C_8 through jacobi-rb with
the chain.  Their limits are set from these sizes' own readings on the CPU:
interp_gap and value_gap at most 6e-14 in float64 and at least 5e-7 in the
float32 control; err at most 2e-5 (families) and 1e-6 (C_8), and at least
1e-2 where a sweep returns its state unchanged.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from ttcross_tpu_torch.apps.truths import ISING_C_STR

REPO = Path(__file__).resolve().parents[2]
MVN_CELL, ISING_CELL = "tiny_mvn.lanes4", "tiny_ising.rb"
DUMMY_METRIC = "integrals_per_call.tiny"


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_root(tmp: Path) -> Path:
    """A checkout-like root under tmp with the benchmark and the two tiny cells."""
    root = Path(tmp) / "root"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    mvn = json.loads((bench / "configs" / "mvn_basket_d6.json").read_text())
    mvn.update(d=3, n=33, max_rank=8, max_sweeps=7)
    ising = json.loads((bench / "configs" / "ising_c1024.json").read_text())
    ising.update(m=8, n=33, max_rank=8, max_sweeps=7, truth=ISING_C_STR[8])
    _write(bench / "configs" / "tiny_mvn.json", mvn)
    _write(bench / "configs" / "tiny_ising.json", ising)
    fam = json.loads((bench / "traffic" / "scen1024.json").read_text())
    fam.update(lanes=4)
    fam["check"] = {"lanes_per_call": 2}
    _write(bench / "traffic" / "tiny_lanes4.json", fam)
    rb = json.loads((bench / "traffic" / "rb_chain.json").read_text())
    rb["check"] = {"call_share": 0.5, "cores_per_solve": 3}
    _write(bench / "traffic" / "tiny_rb.json", rb)
    for cell, err in ((MVN_CELL, {"err_geomean": 1e-4}), (ISING_CELL, {"err_worst": 1e-4})):
        lim = {"interp_gap": 1e-9, "value_gap": 1e-9} | err
        _write(bench / "limits" / f"{cell}.json", {"limits": lim, "set_from": "tests"})
    (bench / "metrics" / f"{DUMMY_METRIC}.py").write_text(
        '"""integrals_per_call.tiny: integrals a call answered, over the window."""\n\n\n'
        "def read(run):\n"
        "    return sum(c.integrals for c in run.calls) / len(run.calls) if run.calls else None\n")
    spec["configs"] += [
        {"name": "tiny_mvn", "source": "tests", "file": "benchmark/configs/tiny_mvn.json",
         "reduced": ["d", "n", "max_rank", "max_sweeps"], "why": "CPU size"},
        {"name": "tiny_ising", "source": "tests", "file": "benchmark/configs/tiny_ising.json",
         "reduced": ["m", "n", "max_rank", "max_sweeps"], "why": "CPU size"}]
    spec["workloads"] += [
        {"name": MVN_CELL, "config": "tiny_mvn", "traffic": "tiny_lanes4", "chips": 1, "why": "t"},
        {"name": ISING_CELL, "config": "tiny_ising", "traffic": "tiny_rb", "chips": 1, "why": "t"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [MVN_CELL if "mvn_basket_d6.scen1024" in m["workloads"]
                                               else ISING_CELL]
    spec["per_layer"].append({"name": DUMMY_METRIC, "unit": "integrals", "better": "higher",
                              "source": "program_counter", "layer": "entry",
                              "moves": "integrals_per_s", "workloads": [MVN_CELL]})
    _write(root / "BENCHMARK.json", spec)
    return root
