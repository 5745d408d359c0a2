"""The quad-double deployment of the benchmark (cell ising_c4_qd_r55.qd_solve)
on the CPU: the plain decimal reference against the port's qd integrand and
rule, the spans and pivots of cross_qd (cross/engine_qd.py) under a profiler
session and without one, the span-read metrics of the cell, the frozen qd
roofline bounds against chip_smoke.py's, and the reference's imports."""

import subprocess
import sys
from decimal import Decimal, localcontext
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from benchmark import core, devtrace, roofline_qd
from benchmark.reference import tt_check_qd
from benchmark.reference.ising_c4_qd import PREC, Reference
from ttcross_tpu_torch.apps import ISING_C_STR, make_ising_qd
from ttcross_tpu_torch.cross import cross_qd
from ttcross_tpu_torch.utils import reset_spans, spans
from torch_qd_helpers import one_torch_thread  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(m=4, n=17, max_rank=10)          # chip_smoke.py's QD_SMALL
SEED = 12345


def _decimal(limbs):
    """Each entry's limbs (leading first) summed into a Decimal."""
    return tt_check_qd.to_decimal([np.asarray(torch.as_tensor(e).cpu(), np.float64)
                                   for e in limbs])


@pytest.mark.parametrize("n", [17, 65])
def test_reference_integrand_matches_the_port_qd_integrand(n):
    ref = Reference({"kind": "C", "m": 4, "n": n, "truth": ISING_C_STR[4]})
    _, fun_qd, _ = make_ising_qd(m=4, n=n, device="cpu")
    ind = np.random.default_rng(n).integers(0, n, (512, 3))
    port = _decimal(fun_qd(torch.from_numpy(ind.astype(np.int32))))
    with localcontext() as ctx:
        ctx.prec = PREC
        gap = max(abs(p - r) / abs(r) for p, r in zip(port, ref.integrand(ind)))
    assert gap <= Decimal("1e-60"), gap


@pytest.mark.parametrize("n", [17, 65])
def test_reference_rule_matches_the_port_qd_rule(n):
    ref = Reference({"kind": "C", "m": 4, "n": n, "truth": ISING_C_STR[4]})
    _, fun_qd, wq = make_ising_qd(m=4, n=n, device="cpu")
    nodes, scaled = _decimal(fun_qd.limbs[:4]), _decimal(fun_qd.limbs[4:])
    with localcontext() as ctx:
        ctx.prec = PREC
        for port, mine in ((nodes, ref.nodes), (scaled, ref.scaled), (_decimal(wq[0]), ref.quad[0])):
            gap = max(abs(p - r) / abs(r) for p, r in zip(port, mine))
            assert gap <= Decimal("1e-62"), gap


def _run():
    _, fun_qd, wq = make_ising_qd(m=SMALL["m"], n=SMALL["n"], device="cpu")
    return cross_qd(fun_qd, [SMALL["n"]] * (SMALL["m"] - 1), max_rank=SMALL["max_rank"],
                    pivoting=1, quad=wq, seed=SEED, device="cpu")


@pytest.fixture(scope="module")
def runs():
    """cross_qd at SMALL without a profiler, then under a CPU-only one:
    (plain result, profiled result, the profiled run's span records)."""
    plain = _run()
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _run()
    return plain, traced, spans()


def _limbs(res):
    return [float(e) for e in res.value]


def test_spans_change_nothing(runs):
    plain, traced, _ = runs
    assert _limbs(traced) == _limbs(plain)
    assert (traced.neval, traced.sweeps, traced.ranks) == (plain.neval, plain.sweeps, plain.ranks)
    assert np.array_equal(traced.vip, plain.vip)
    assert [h["host_reads"] for h in traced.history] == [h["host_reads"] for h in plain.history]


def test_span_tree(runs):
    _, res, recs = runs
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert len(roots) == 1 and recs[roots[0]].name == "cross_qd"
    assert recs[0].attrs == {"d": 3, "n": (17, 17, 17), "max_rank": 10}
    kids = [r for r in recs if r.parent == 0]
    assert [r.name for r in kids] == ["engine.init"] + ["engine.sweep"] * res.sweeps + ["qd.solve"]
    sweeps = [i for i, r in enumerate(recs) if r.name == "engine.sweep"]
    assert [recs[i].attrs["it"] for i in sweeps] == list(range(1, res.sweeps + 1))
    for i in sweeps:
        below = [r for r in recs if r.parent == i]
        names = [r.name for r in below]
        assert names.count("engine.hunt") == 2 and names[-1] == "engine.value"
        assert {r.attrs["bond"] for r in below if r.name != "engine.value"} <= {0, 1}
    accepts = sum(r.name == "engine.accept" for r in recs)
    assert accepts == sum(res.ranks[1:-1]) - 2          # every rank past the first
    root = recs[0]
    covered = sum(r.end - r.start for r in kids)
    assert covered >= 0.99 * (root.end - root.start)


def test_host_reads_attributes_add_up(runs):
    _, res, recs = runs
    init = next(r for r in recs if r.name == "engine.init")
    reads = [r.attrs["host_reads"] for r in recs if r.name == "engine.sweep"]
    assert reads == [h["host_reads"] for h in res.history]
    steps = np.diff([init.attrs["host_reads"]] + reads)
    assert (steps > 0).all()
    assert init.attrs["host_reads"] + steps.sum() == res.history[-1]["host_reads"]


def test_vip_rebuilds_the_cross_points(runs):
    """The pivots as tt_check.pivot_sets reads them: the train reproduces
    the port's own integrand at every cross point."""
    _, res, _ = runs
    assert res.vip.shape == (2, max(res.ranks), 4) and res.vip.dtype == np.int64
    n = SMALL["n"]
    _, fun_qd, _ = make_ising_qd(m=4, n=n, device="cpu")
    grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1).reshape(-1, 3)
    table = _decimal(fun_qd(torch.from_numpy(grid.astype(np.int32)))).reshape(n, n, n)

    def port(ind):
        return [table[tuple(row)] for row in np.asarray(ind).tolist()]

    cores = [_decimal(g) for g in res.cores]
    assert tt_check_qd.interp_gap(cores, res.vip, res.ranks, port) < 1e-60


@pytest.mark.parametrize("name", ["sweep_span_ms.qd", "host_reads_per_visit.qd"])
def test_span_metrics_read_the_profiled_call(runs, name):
    _, res, recs = runs
    ends = [r.end for r in recs]
    trace = devtrace.Trace(ops=[], window_s=max(ends) - recs[0].start, busy_s=0.0, gaps=[],
                           launch_shapes={}, marker_found=False, sweeps=res.sweeps)
    value = core._reader(REPO, name)(core.Run(setup_s=0.0, window_s=0.0, calls=[], trace=trace))
    if name == "host_reads_per_visit.qd":
        assert value == res.history[-1]["host_reads"] / (res.sweeps * 2)
    else:
        walls = [r.end - r.start for r in recs if r.name == "engine.sweep"]
        assert value == pytest.approx(1e3 * sum(walls) / len(walls))


@pytest.mark.parametrize("kernel,name", [("qd_score", "qd_score_residual_argmax"),
                                         ("qd_dot", "qd_dot"),
                                         ("ising_qd", "ising_c_integrand_qd_fused")])
def test_frozen_qd_bounds_are_chip_smokes(kernel, name):
    import chip_smoke

    _, _, bound = roofline_qd.KERNELS[kernel]
    for shape in chip_smoke.QD_TABLE_SHAPES[name]:
        assert bound(shape) == chip_smoke._qd_bound(name, shape)[0]


def test_references_import_nothing_of_the_port():
    code = ("import sys; import benchmark.reference.ising_c4_qd, benchmark.reference.tt_check_qd; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('ttcross_tpu_torch', 'ttcross_tpu', 'jax', 'jaxlib')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
