"""The port's distributed quad-double cross (parallel/engine_qd.py::
cross_qd_parallel, spawned workers through parallel/_hub.py) against the
JAX package's hub (forked workers) with the same seed.

Worker w draws its lottery from np.random.default_rng(seed + 7919 w) in
both packages, and every qd operation is the same IEEE f64 sequence, so
the replicated pivot chains (vip, read from every worker), the ranks, the
evaluation counts and the per-sweep and final values are equal: the values
are held within 1e-58 relative (measured bit-equal).  One worker equals
cross_qd.  The workers are spawned with a time limit per message; too many
workers and bad slab bounds raise ValueError, as in the JAX package."""

from decimal import Decimal, localcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ttcross_tpu  # noqa: F401  (x64)
import ttcross_tpu.cross.engine_qd as JE
import ttcross_tpu.parallel.engine_qd as JP
from ttcross_tpu.parallel.engine_qd import cross_qd_parallel as jcross_qd_parallel
from ttcross_tpu_torch.cross import cross_qd
from ttcross_tpu_torch.ops import qd as PQ
from ttcross_tpu_torch.parallel import cross_qd_parallel
from ttcross_tpu_torch.parallel._hub import run_hub
from ttcross_tpu_torch.parallel.engine_qd import _QdAdapter
from test_torch_engine_qd import _plimbs, _rank2, jax_rank2
from torch_qd_helpers import Broken, Rank2QD, one_torch_thread  # noqa: F401  (a fixture)

TIMEOUT = 120.0
QD_LACC = 62 - 4     # cross_qd's default accuracy_log10 is -QD_DPS + 4


def _rel(a, b) -> float:
    with localcontext() as ctx:
        ctx.prec = 80
        x, y = PQ.qd_to_mp(*(float(e) for e in a)), PQ.qd_to_mp(*(float(e) for e in b))
        return float(abs(x - y) / abs(y))


def _jax_hub_with_vips(monkeypatch, tmp_path, fun, n, **kw):
    """The JAX hub's result and each forked worker's final vip (written by
    an engine whose solve_core records it; the fork inherits the patch)."""
    import json

    base = JE.QdEngine

    class Recording(base):
        def solve_core(self, c):
            path = tmp_path / f"vip_{self.rng.bit_generator.state['state']['state']}.json"
            path.write_text(json.dumps([[list(map(int, p)) for p in b] for b in self.vip]))
            return super().solve_core(c)

    monkeypatch.setattr(JP, "QdEngine", Recording)
    res = jcross_qd_parallel(fun, n, **kw)
    vips = {p.read_text() for p in tmp_path.glob("vip_*.json")}
    return res, [json.loads(v) for v in vips]


def _port_hub(fun, n, max_rank, seed, n_workers, mybonds=None, quad=None):
    """The port's hub result and each spawned worker's final vip (from the
    workers' reports)."""
    reports = []
    res = run_hub(_QdAdapter(None, -7.0, "cpu"), fun, n, max_rank, 1, quad, None, -QD_LACC, 8,
                  seed, False, n_workers, mybonds, name="cross_qd_parallel", timeout=TIMEOUT,
                  reports=reports)
    assert not any(s for r in reports for s in r["shapes"].values())   # no launch on the CPU
    return res, [r["vip"] for r in reports]


def _assert_same(pres, jres):
    assert (tuple(pres.ranks), pres.neval, pres.sweeps) == (tuple(jres.ranks), jres.neval,
                                                            jres.sweeps)
    for pr, jr in zip(pres.history, jres.history):
        assert pr["n_evals"] == jr["n_evals"] and pr["pivotmax_log10"] == jr["pivotmax_log10"]
        assert _rel(pr["value"], jr["value"]) <= 1e-58
    assert _rel(pres.value, jres.value) <= 1e-58


@pytest.mark.parametrize("n_workers,d,n,mybonds", [(1, 4, 6, None), (2, 4, 6, None),
                                                   (3, 5, 5, [0, 1, 3, 4])])
def test_hub_equals_jax(n_workers, d, n, mybonds, monkeypatch, tmp_path):
    g1, g2 = _rank2(40 + n_workers, d, n)
    jres, jvips = _jax_hub_with_vips(monkeypatch, tmp_path, jax_rank2(g1, g2, d), [n] * d,
                                     max_rank=4, quad=[np.ones(n)] * d, seed=5,
                                     n_workers=n_workers, mybonds=mybonds)
    pres, pvips = _port_hub(Rank2QD(g1, g2), [n] * d, 4, 5, n_workers, mybonds,
                            quad=[np.ones(n)] * d)
    _assert_same(pres, jres)
    # vip is replicated: every worker of both packages holds the same chains
    assert len(pvips) == n_workers and all(v == pvips[0] for v in pvips)
    assert jvips == [[[list(p) for p in b] for b in pvips[0]]]
    assert max(pres.ranks[1:-1]) == 2
    with localcontext() as ctx:
        ctx.prec = 80
        s1 = s2 = Decimal(1)
        for c in range(d):
            s1 *= sum(Decimal(float(v)) for v in g1[c])
            s2 *= sum(Decimal(float(v)) for v in g2[c])
        got = PQ.qd_to_mp(*(float(e) for e in pres.value))
        assert abs(1 - got / (s1 + s2)) < Decimal("1e-50")
    if n_workers == 1:    # one worker is cross_qd
        ser = cross_qd(Rank2QD(g1, g2), [n] * d, max_rank=4, quad=[np.ones(n)] * d, seed=5,
                       device="cpu")
        assert (ser.ranks, ser.neval) == (tuple(pres.ranks), pres.neval)
        assert _plimbs(ser.value) == _plimbs(pres.value)
        assert all(_plimbs(a) == _plimbs(b) for a, b in zip(ser.cores, pres.cores))


def test_cross_qd_parallel_entry_point_with_truth():
    """The public entry point: two workers, the truth's per-sweep err, the
    result on the requested device."""
    d, n = 4, 6
    g1, g2 = _rank2(60, d, n)
    with localcontext() as ctx:
        ctx.prec = 80
        s1 = s2 = Decimal(1)
        for c in range(d):
            s1 *= sum(Decimal(float(v)) for v in g1[c])
            s2 *= sum(Decimal(float(v)) for v in g2[c])
        truth = s1 + s2
    res = cross_qd_parallel(Rank2QD(g1, g2), [n] * d, max_rank=4, quad=[np.ones(n)] * d,
                            truth=truth, n_workers=2, device="cpu", timeout=TIMEOUT)
    assert res.history[-1]["err"] is not None and res.history[-1]["err"] < Decimal("1e-50")
    assert res.value.e0.device.type == "cpu" and len(res.cores) == d


def test_bad_workers_and_slabs_raise():
    g1, g2 = _rank2(61, 3, 4)
    with pytest.raises(ValueError, match="n_workers"):
        cross_qd_parallel(Rank2QD(g1, g2), [4] * 3, n_workers=3, device="cpu")
    with pytest.raises(ValueError, match="mybonds"):
        cross_qd_parallel(Rank2QD(g1, g2), [4] * 4, n_workers=2, mybonds=[0, 3, 3], device="cpu")
    with pytest.raises(ValueError, match="d >= 2"):
        cross_qd_parallel(Rank2QD(g1, g2), [4], n_workers=1, device="cpu")


def test_a_failing_worker_fails_the_run():
    with pytest.raises(RuntimeError, match="integrand failed"):
        cross_qd_parallel(Broken(), [4] * 3, n_workers=2, device="cpu", timeout=TIMEOUT)
