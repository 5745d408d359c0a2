"""The check fails what it should, at CPU sizes: the port's lower tier
(float32, the check's control) and faults planted in the timed path under
the harness (a sweep that returns its state unchanged; half of each batch
left out and filled with the mean of the rest; each answer altered where it
is produced).  One chip, no exchange between chips to leave out.  And the
reference agrees with the port where both compute the same thing."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import core
from benchmark.reference import ising_c1024, mvn_basket_d6, tt_check
from bench_tiny import ISING_CELL, MVN_CELL, make_root

CELLS = [MVN_CELL, ISING_CELL]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, seed=2 ** 33 + 41, **kw):
    return core.run_cell(core.load_cell(root, cell), seed, 0.3, False, "cpu", time.perf_counter(),
                         **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_the_float32_control_is_not_correct(root, cell):
    out, notes = _run(root, cell, dtype=torch.float32)
    assert not out["correct"], notes[-4:]
    failed = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert {"interp_gap", "value_gap"} <= set(failed)


def _unchanged_state(monkeypatch):
    from ttcross_tpu_torch.cross import batch, engine

    orig = engine.run_sweeps

    def frozen(kit, st, *a, **kw):
        def same(st, it, U, cs=None, **_):
            return st if cs is None else (st, cs)
        return orig(kit._replace(sweep_fn=same), st, *a, **kw)

    monkeypatch.setattr(engine, "run_sweeps", frozen)
    monkeypatch.setattr(batch, "run_sweeps", frozen)


def _half_batch(monkeypatch):
    from ttcross_tpu_torch.apps import ising, mvn

    def halved(f):
        def g(*a, **kw):
            out = f(*a, **kw)
            axis = out.dim() - 1 if out.dim() < 3 else 1      # the rows of the batch
            B = out.shape[axis]
            keep = out.narrow(axis, 0, (B + 1) // 2)
            out = out.clone()
            out.narrow(axis, (B + 1) // 2, B // 2).copy_(
                keep.mean(dim=axis, keepdim=True).expand_as(out.narrow(axis, (B + 1) // 2, B // 2)))
            return out
        return g

    monkeypatch.setattr(mvn, "mvn_pdf_fused", halved(mvn.mvn_pdf_fused))
    monkeypatch.setattr(ising, "ising_integrand_fused", halved(ising.ising_integrand_fused))
    monkeypatch.setattr(ising, "small_table_lookup", halved(ising.small_table_lookup))


def _altered_answer(monkeypatch):
    from ttcross_tpu_torch.cross import batch, engine

    orig = engine.run_sweeps

    def altered(kit, st, *a, **kw):
        return orig(kit._replace(value_fn=lambda s, w: kit.value_fn(s, w) * (1 + 1e-6)), st, *a, **kw)

    monkeypatch.setattr(engine, "run_sweeps", altered)
    monkeypatch.setattr(batch, "run_sweeps", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("plant", [_unchanged_state, _half_batch, _altered_answer])
def test_a_fault_in_the_timed_path_is_not_correct(root, cell, plant, monkeypatch):
    plant(monkeypatch)
    out, notes = _run(root, cell)
    assert not out["correct"], notes[-4:]


def test_the_mvn_reference_agrees_with_the_port():
    from ttcross_tpu_torch.apps import make_mvn_family

    cfg = {"d": 6, "n": 65, "box": [0.52517, 8.52517], "S0": 100.0, "r": 0.0, "T": 1.0,
           "sigma": 0.4, "truth": "1"}
    ref = mvn_basket_d6.Reference(cfg)
    corrs = np.array([0.2, 0.45, 0.6])
    fam = make_mvn_family(d=6, n=65, corrs=corrs, device="cpu")
    np.testing.assert_allclose(ref.nodes, fam.nodes, rtol=0, atol=4e-15)
    # the reference's rule is the exact one to the last bit; the port's
    # weights are within 7e-14 of it (its Newton stops a step early for them)
    np.testing.assert_allclose(ref.weights, fam.quad_weights, rtol=2e-13, atol=0)
    ind = torch.randint(0, 65, (3, 500, 6), generator=torch.Generator().manual_seed(5))
    got = fam.fun(ind.to(torch.int32), fam.params)
    for lane, c in enumerate(corrs):
        want = ref.integrand(float(c))(ind[lane])
        torch.testing.assert_close(got[lane], want, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("m", [8, 40])
def test_the_ising_reference_agrees_with_the_port(m):
    from ttcross_tpu_torch.apps import make_ising

    ref = ising_c1024.Reference({"kind": "C", "m": m, "n": 33, "truth": "1"})
    p = make_ising("C", m, 33, device="cpu")
    np.testing.assert_allclose(ref.nodes, p.nodes, rtol=0, atol=4e-15)
    np.testing.assert_allclose(ref.quad[0], p.quad_weights, rtol=2e-13)
    ind = torch.randint(0, 33, (400, m - 1), generator=torch.Generator().manual_seed(m))
    # a product of d weights, each within 2e-13 of the reference's
    torch.testing.assert_close(p.fun(ind.to(torch.int32)), ref.integrand(ind), rtol=2e-13 * m,
                               atol=1e-300)


def test_the_train_check_reads_a_port_run():
    from ttcross_tpu_torch.apps import make_ising
    from ttcross_tpu_torch.cross import cross

    p = make_ising("C", 40, 17, device="cpu")
    ref = ising_c1024.Reference({"kind": "C", "m": 40, "n": 17, "truth": "1"})
    res = cross(p.fun, [p.n] * p.d, max_rank=6, accuracy=1.1e-13, quad=[p.quad_weights] * p.d,
                sweep_mode="jacobi-rb", chain=p.chain, return_pivots=True, device="cpu")
    cores = list(res.tt.cores)
    assert tt_check.interp_gap(cores, res.state.vip, res.state.rk, ref.integrand) < 1e-12
    assert tt_check.contract(cores, ref.quad) == pytest.approx(res.values[-1], rel=1e-13)
    # another train's cores at the same pivots do not interpolate
    bent = [c * (1 + 1e-7 * (k == 5)) for k, c in enumerate(cores)]
    assert tt_check.interp_gap(bent, res.state.vip, res.state.rk, ref.integrand) > 1e-8
