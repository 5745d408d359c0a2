"""The qd engine's index bookkeeping as whole arrays: cross/hostwalk.py's
walk_indices against walk_index, entry for entry, and the hunt's candidate
pairs (cross/engine_qd.py::_free_pairs) against the list comprehension they
replace, order included; a cross_qd whose engine reaches walk_index raises,
so a run that ends proves every hunt took the arrays."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ttcross_tpu_torch.cross.engine_qd as PE
import ttcross_tpu_torch.cross.hostwalk as HW
from ttcross_tpu_torch.apps import ISING_C_STR, make_ising_qd
from ttcross_tpu_torch.cross.hostwalk import walk_index, walk_indices
from torch_qd_helpers import one_torch_thread  # noqa: F401  (a fixture)


def _chains(d, seed):
    """Random pivot chains of a d-dimensional state: ranks r_1..r_{d-1} in
    1-12, modes 2-9; vip[s] holds r_{s+1} entries (row of I[s-1], i_s,
    i_{s+1}, row of J[s+1]) as tuples, as the engine keeps them."""
    rng = np.random.default_rng(seed)
    n = [int(x) for x in rng.integers(2, 10, d)]
    r = [1] + [int(x) for x in rng.integers(1, 13, d - 1)] + [1]
    vip = [[(int(rng.integers(r[s])), int(rng.integers(n[s])), int(rng.integers(n[s + 1])),
             int(rng.integers(r[s + 2]))) for _ in range(r[s + 1])] for s in range(d - 1)]
    return n, r, vip


def _cases(order, b, n, r, rng):
    """(array arguments of walk_indices, the entries in the same order)."""
    if order == "col":
        kk, qq = int(rng.integers(n[b + 1])), int(rng.integers(r[b + 2]))
        return ((np.arange(r[b])[:, None], np.arange(n[b]), kk, qq),
                [(i, j, kk, qq) for i in range(r[b]) for j in range(n[b])])
    if order == "row":
        ii, jj = int(rng.integers(r[b])), int(rng.integers(n[b]))
        return ((ii, jj, np.arange(n[b + 1])[:, None], np.arange(r[b + 2])),
                [(ii, jj, k, q) for k in range(n[b + 1]) for q in range(r[b + 2])])
    if order == "lottery":
        m = 40
        e = np.stack([rng.integers(r[b], size=m), rng.integers(n[b], size=m),
                      rng.integers(n[b + 1], size=m), rng.integers(r[b + 2], size=m)], 1)
        return tuple(e.T), [tuple(int(x) for x in t) for t in e]
    e = (int(rng.integers(r[b])), int(rng.integers(n[b])), int(rng.integers(n[b + 1])),
         int(rng.integers(r[b + 2])))
    return e, [e]


@pytest.mark.parametrize("order", ["col", "row", "lottery", "scalars"])
@pytest.mark.parametrize("d", [2, 3, 4, 6])
def test_walk_indices_is_walk_index_entry_by_entry(d, order):
    rng = np.random.default_rng(100 * d)
    for seed in range(6):
        n, r, vip = _chains(d, 10 * d + seed)
        arrays = [np.asarray(v, np.int64) for v in vip]
        for b in range(d - 1):
            args, entries = _cases(order, b, n, r, rng)
            got = walk_indices(arrays, b, d, *args)
            want = np.array([walk_index(vip, b, d, *e) for e in entries], np.int64)
            assert got.dtype == np.int64 and got.shape == (len(entries), d)
            assert np.array_equal(got, want)


def _comprehension(shape, used):
    return [(i, j) for i in range(shape[0]) for j in range(shape[1]) if (i, j) not in used]


@pytest.mark.parametrize("shape, used", [
    ((1, 7), [(0, 0), (0, 6)]),                              # the first bond's r = 1
    ((5, 4), [(0, 0), (4, 3), (0, 3), (4, 0), (0, 0)]),      # corners, one twice
    ((6, 1), [(5, 0), (2, 0)]),                              # the last bond's r = 1
    ((3, 9), [(1, 4)]),
    ((2, 3), [(i, j) for i in range(2) for j in range(3)]),  # every cell used
])
def test_free_pairs_are_the_comprehension_in_order(shape, used):
    u = np.asarray(used, np.int64)
    got = PE._free_pairs(shape, u[:, 0], u[:, 1])
    want = _comprehension(shape, set(used))
    assert got.dtype == np.int64 and got.shape == (len(want), 2)
    assert [tuple(int(x) for x in p) for p in got] == want
    if want:   # the lottery indexes the pairs with its draws
        draws = np.random.default_rng(3).integers(0, len(want), 50)
        assert got[draws].tolist() == [list(want[i]) for i in draws]


def _engines(monkeypatch):
    """Record the engines cross_qd builds (to read their vip and rng)."""
    seen = []

    class Recorded(PE.QdEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)

    monkeypatch.setattr(PE, "QdEngine", Recorded)
    return seen


def test_a_bond_with_no_free_column_pair_draws_nothing():
    prob, fun, _ = make_ising_qd(m=4, n=5, device="cpu")
    eng = PE.QdEngine(fun, [prob.n] * prob.d, 10, 1, None, -7.0, 8, 0, "cpu")
    eng.init_state()
    eng.vip[0] = [(0, j, 0, 0) for j in range(prob.n)]    # r[0] = 1: every (i, j) used
    state = eng.rng.bit_generator.state
    neval = eng.neval
    assert eng.hunt(0, True) is None
    assert eng.rng.bit_generator.state == state and eng.neval == neval


def test_cross_qd_never_walks_one_entry_at_a_time(monkeypatch):
    prob, fun, w = make_ising_qd(m=4, n=17, device="cpu")
    kw = dict(max_rank=10, quad=w, truth=ISING_C_STR[4], device="cpu")
    seen = _engines(monkeypatch)
    plain = PE.cross_qd(fun, [prob.n] * prob.d, **kw)

    def refuse(*a, **k):
        raise AssertionError("walk_index called")

    monkeypatch.setattr(HW, "walk_index", refuse)
    monkeypatch.setattr(PE, "walk_index", refuse, raising=False)
    patched = PE.cross_qd(fun, [prob.n] * prob.d, **kw)
    a, b = seen
    assert a.vip == b.vip and a.r == b.r
    assert plain.ranks == patched.ranks and plain.sweeps == patched.sweeps
    assert plain.neval == patched.neval == a.neval
    assert np.array_equal(plain.vip, patched.vip)
    assert a.rng.bit_generator.state == b.rng.bit_generator.state
    assert all(isinstance(p, tuple) for v in b.vip for p in v)
    assert [float(e) for e in plain.value] == [float(e) for e in patched.value]
