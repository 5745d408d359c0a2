"""The port's spans (ttcross_tpu_torch/utils/metrics.py::span): named host
intervals that cross / cross_batch, the sweep engines and the chain
evaluator record while a torch.profiler session is active, and nothing
otherwise.

Each engine is run at a tiny size on the CPU under a CPU-only profiler, and
the span tree is held to its exact shape: one root, its children, and the
counts that follow from the sweeps the run made."""

import json
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from ttcross_tpu_torch.apps import make_ising, make_mvn_family
from ttcross_tpu_torch.cross import cross, cross_batch
from ttcross_tpu_torch.utils import SpanRecord, profile_trace, reset_spans, span, spans
from ttcross_tpu_torch.utils import metrics

ACC = 500 * 2.2e-16
D, N, L, R = 4, 17, 3, 6          # the MVN family: d, rule, lanes, rank
M = 12                            # C_12: d = 11
SWEEPS = 12                       # above every run's stop: lanes stop at 8-11 sweeps


def _profiled(fn):
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, spans()


def _family_run(mode):
    fam = make_mvn_family(d=D, n=N, corrs=np.linspace(0.2, 0.6, L), device="cpu")
    return lambda: cross_batch(fam.fun, [fam.n] * D, fam.params, max_rank=R, key=3, pivoting=1,
                               accuracy=ACC, quad=[fam.quad_weights] * D, truth=1.0,
                               max_sweeps=SWEEPS, sweep_mode=mode, device="cpu")


def _chain_run():
    p = make_ising("C", M, N, device="cpu")
    return lambda: cross(p.fun, [p.n] * p.d, max_rank=R, key=5, pivoting=1, accuracy=ACC,
                         quad=[p.quad_weights] * p.d, truth=p.truth, sweep_mode="jacobi-rb",
                         chain=p.chain, max_sweeps=SWEEPS, return_pivots=True, device="cpu")


def _children(recs, i):
    return [r for r in recs if r.parent == i]


def test_nothing_is_recorded_without_a_profiler():
    reset_spans()
    s = span("cross", d=3)
    assert s is span("engine.sweep", it=1) is metrics._NO_SPAN
    with s as inner:
        inner.set(lanes=4)
    _family_run("sequential")()
    assert spans() == []


def test_nesting_parent_and_call_ids():
    def body():
        for c in range(2):
            with span("root", c=c) as root:
                with span("a"):
                    with span("a.b", k=1):
                        pass
                with span("c"):
                    pass
                root.set(done=True)

    _, recs = _profiled(body)
    assert [r.name for r in recs] == ["root", "a", "a.b", "c"] * 2
    assert [r.parent for r in recs] == [None, 0, 1, 0, None, 4, 5, 4]
    assert [r.call for r in recs] == [0] * 4 + [4] * 4
    assert recs[0].attrs == {"c": 0, "done": True} and recs[2].attrs == {"k": 1}
    for r in recs:
        assert isinstance(r, SpanRecord) and r.start <= r.end
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start <= r.start and r.end <= p.end
    reset_spans()
    assert spans() == []


def test_reset_is_refused_inside_an_open_span():
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("root"):
            with pytest.raises(RuntimeError, match="open span"):
                reset_spans()
            with span("a"):
                pass
        reset_spans()
    assert spans() == []


def _check_tree(recs, root_name, hunts_per_sweep, sweeps, chain):
    """The span tree of one call: returns the root."""
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert len(roots) == 1 and roots[0] == 0
    root = recs[0]
    assert root.name == root_name and all(r.call == 0 for r in recs)
    kids = Counter(r.name for r in _children(recs, 0))
    want = {"entry.uniforms": 1, "engine.init": 1, "engine.value": 1,
            "engine.sweep": sweeps, "entry.results": 1}
    if chain:
        want["chain.states"] = 1
    assert kids == want
    up = [r for r in recs if r.name == "entry.upload"]
    assert len(up) == 1 and recs[up[0].parent].name == "entry.uniforms"
    assert up[0].attrs["bytes"] > 0
    sweep_ix = [i for i, r in enumerate(recs) if r.name == "engine.sweep"]
    assert [recs[i].attrs["it"] for i in sweep_ix] == list(range(1, sweeps + 1))
    for i in sweep_ix:
        below = Counter(r.name for r in _children(recs, i))
        want = {"engine.hunt": hunts_per_sweep, "engine.accept": hunts_per_sweep,
                "engine.value": 1}
        if chain:
            want["chain.update"] = hunts_per_sweep
        assert below == want
    # nothing below a hunt, an accept or a value: the device trace has the kernels
    leaves = {"engine.hunt", "engine.accept", "engine.value", "entry.upload", "chain.update",
              "chain.states"}
    assert not [r for r in recs if r.parent is not None and recs[r.parent].name in leaves]
    return root


@pytest.mark.parametrize("mode", ["sequential", "jacobi"])
def test_cross_batch_span_tree(mode):
    run = _family_run(mode)
    res, recs = _profiled(run)
    root = _check_tree(recs, "cross_batch", D - 1 if mode == "sequential" else 1, res.sweeps,
                       chain=False)
    assert root.attrs == {"lanes": L, "d": D, "sweep_mode": mode}
    assert res.sweeps < SWEEPS and len({lane.sweeps for lane in res.lanes}) > 1
    assert [r.attrs for r in recs if r.name == "entry.results"] == [{"lanes": L}]
    hunts = [r.attrs for r in recs if r.name == "engine.hunt"]
    if mode == "sequential":
        # the sweeps alternate direction: >> visits bonds 0 .. d-2, << back
        assert [h["bond"] for h in hunts[:2 * (D - 1)]] == [0, 1, 2, 2, 1, 0]
    else:
        assert hunts == [{"bond": "all"}] * res.sweeps
    # a profiler changes nothing in the result
    plain = run()
    assert plain.sweeps == res.sweeps and plain.neval == res.neval
    for a, b in zip(plain.lanes, res.lanes):
        assert a.values == b.values and a.ranks == b.ranks and a.neval == b.neval
        assert all(torch.equal(x, y) for x, y in zip(a.tt.cores, b.tt.cores))
        assert np.array_equal(a.state.vip, b.state.vip)


def test_cross_chain_rb_span_tree():
    run = _chain_run()
    res, recs = _profiled(run)
    root = _check_tree(recs, "cross", 2, res.sweeps, chain=True)
    assert root.attrs == {"d": M - 1, "sweep_mode": "jacobi-rb", "chain": True}
    assert res.sweeps < SWEEPS
    hunts = [r.attrs for r in recs if r.name == "engine.hunt"]
    assert hunts == [{"bond": "all", "phase": 0}, {"bond": "all", "phase": 1}] * res.sweeps
    plain = run()
    assert (plain.values, plain.ranks, plain.neval, plain.sweeps) == (
        res.values, res.ranks, res.neval, res.sweeps)
    assert all(torch.equal(x, y) for x, y in zip(plain.tt.cores, res.tt.cores))
    assert np.array_equal(plain.state.vip, res.state.vip)


def test_profile_trace_writes_the_spans(tmp_path):
    run = _family_run("jacobi")
    reset_spans()
    with span("outside"):                 # no profiler yet: not recorded
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with span("before"):              # a record ahead of the window
            pass
    with profile_trace(str(tmp_path / "prof")):
        res = run()
    lines = (tmp_path / "prof" / "spans.jsonl").read_text().splitlines()
    recs = [json.loads(line) for line in lines]
    # the window's records left memory with the file; the one before stays
    assert len(recs) > 0 and [r.name for r in spans()] == ["before"]
    assert recs[0]["name"] == "cross_batch" and "parent" not in recs[0] and recs[0]["call"] == 0
    assert sum(r["name"] == "engine.sweep" for r in recs) == res.sweeps
    for r in recs[1:]:
        assert 0 <= r["parent"] < len(recs) and r["call"] == 0
        assert recs[r["parent"]]["start"] <= r["start"] <= r["end"] <= recs[r["parent"]]["end"]
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
