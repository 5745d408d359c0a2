"""The port's quad-double cross engine (cross/engine_qd.py) against the JAX
package's (ttcross_tpu/cross/engine_qd.py), on the JAX tests' cases.

Both engines draw the lottery from np.random.default_rng(seed) and compute
in the same operation order with IEEE f64 (numpy there, eager torch here),
and the thresholds read log10 of the same leading limbs with numpy: so the
pivots (vip), ranks, evaluation counts, sweeps and every per-sweep qd value
are equal, bit for bit (tolerance: none).  The state of a JAX engine
carried across (interop.qd_state_from_numpy) sweeps to the same state."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ttcross_tpu  # noqa: F401  (x64)
import ttcross_tpu.cross.engine_qd as JE
import ttcross_tpu.ops.qd as JQ
import ttcross_tpu_torch.cross.engine_qd as PE
from ttcross_tpu_torch.apps import ISING_C_STR
from ttcross_tpu_torch.interop import qd_state_from_numpy
from ttcross_tpu_torch.ops import qd as PQ
from torch_qd_helpers import Rank2QD, one_torch_thread  # noqa: F401  (a fixture)


def jax_rank2(g1, g2, d):
    def fun_qd(ind):
        ind = np.asarray(ind)
        p1 = JQ.qd(np.ones(ind.shape[0]))
        p2 = JQ.qd(np.ones(ind.shape[0]))
        for c in range(d):
            p1 = JQ.qd_mul(p1, JQ.qd(g1[c][ind[:, c]]))
            p2 = JQ.qd_mul(p2, JQ.qd(g2[c][ind[:, c]]))
        return JQ.qd_add(p1, p2)

    return fun_qd


def _engines(monkeypatch):
    """Record the engine each package's cross_qd builds (to read its vip)."""
    seen = {}
    for key, mod in (("jax", JE), ("port", PE)):
        base = mod.QdEngine

        class Recorded(base):
            def __init__(self, *a, _key=key, **k):
                super().__init__(*a, **k)
                seen[_key] = self

        monkeypatch.setattr(mod, "QdEngine", Recorded)
    return seen


def _limbs(x):
    return tuple(np.asarray(e, np.float64).tolist() for e in x)


def _plimbs(x):
    return tuple(e.cpu().numpy().tolist() for e in x)


def assert_same_run(jres, pres, jeng, peng):
    assert (pres.ranks, pres.neval, pres.sweeps) == (tuple(jres.ranks), jres.neval, jres.sweeps)
    assert peng.vip == [[tuple(int(v) for v in pv) for pv in b] for b in jeng.vip]
    assert len(pres.history) == len(jres.history)
    for jr, pr in zip(jres.history, pres.history):
        assert pr["pivotmax_log10"] == jr["pivotmax_log10"] and pr["n_evals"] == jr["n_evals"]
        if jr["value"] is not None:
            assert _plimbs(pr["value"]) == _limbs(jr["value"]), jr["it"]
            if jr["err"] is not None:
                assert float(pr["err"]) == pytest.approx(float(jr["err"]), rel=1e-12)
    if jres.value is not None:
        assert _plimbs(pres.value) == _limbs(jres.value)
    for jc, pc in zip(jres.cores, pres.cores):
        assert _plimbs(pc) == _limbs(jc)


def _rank2(seed, d, n, scale=1.0):
    rng = np.random.default_rng(seed)
    g1 = [scale * (1.0 + rng.random(n)) for _ in range(d)]
    g2 = [scale * (0.5 + rng.random(n)) for _ in range(d)]
    return g1, g2


@pytest.mark.parametrize("case", ["exact_rank", "log_domain"])
def test_rank2_runs_equal_jax(case, monkeypatch):
    """Exact-rank recovery (d = 4, n = 6, rank 5, seed 1) and the log-domain
    thresholds (factors ~1e-10, the tensor ~1e-30: d = 3, n = 5, rank 4,
    seed 5); the values also match the closed form to the JAX tests'
    bounds."""
    from decimal import Decimal, localcontext

    d, n, R, seed, scale = (4, 6, 5, 1, 1.0) if case == "exact_rank" else (3, 5, 4, 5, 1e-10)
    g1, g2 = _rank2(seed + 100, d, n, scale)
    seen = _engines(monkeypatch)
    wj = [JQ.qd(np.ones(n)) for _ in range(d)]
    jres = JE.cross_qd(jax_rank2(g1, g2, d), [n] * d, max_rank=R, quad=wj, seed=seed)
    pres = PE.cross_qd(Rank2QD(g1, g2), [n] * d, max_rank=R, quad=[np.ones(n)] * d, seed=seed,
                       device="cpu")
    assert_same_run(jres, pres, seen["jax"], seen["port"])
    assert max(pres.ranks) >= 2
    with localcontext() as ctx:
        ctx.prec = 80
        s1 = s2 = Decimal(1)
        for c in range(d):
            s1 *= sum(Decimal(float(v)) for v in g1[c])
            s2 *= sum(Decimal(float(v)) for v in g2[c])
        rel = abs(1 - PQ.qd_to_mp(*(float(e) for e in pres.value)) / (s1 + s2))
    assert rel < Decimal("1e-55" if case == "exact_rank" else "1e-50")


def test_ising_c4_n17_rank10_equals_jax(monkeypatch):
    """C_4 at n = 17, rank 10, seed 0 (the JAX test's case): every sweep's qd
    value bit-equal, the final error at the rank-10 floor (~4e-13)."""
    from ttcross_tpu.apps.ising import make_ising_qd as jmake
    from ttcross_tpu_torch.apps import make_ising_qd

    seen = _engines(monkeypatch)
    jp, jf, jw = jmake(m=4, n=17)
    jres = JE.cross_qd(jf, [17] * 3, max_rank=10, quad=jw, truth=ISING_C_STR[4])
    pp, pf, pw = make_ising_qd(m=4, n=17, device="cpu")
    pres = PE.cross_qd(pf, [17] * 3, max_rank=10, quad=pw, truth=ISING_C_STR[4], device="cpu")
    assert_same_run(jres, pres, seen["jax"], seen["port"])
    errs = [float(r["err"]) for r in pres.history]
    assert errs[-1] < 1e-11 and errs[-1] < errs[0] and pres.ranks == (1, 10, 10, 1)
    assert all("host_reads" in r for r in pres.history)


def test_stdnorm_d4_62_digits_equals_jax(monkeypatch):
    """bench.py's stdnorm_d4_qd_engine configuration: rank 1 throughout,
    9,666 evaluations, >= 60 digits against pi^2, equal to the JAX run."""
    from decimal import Decimal, localcontext

    from ttcross_tpu.apps.stdnorm import make_stdnorm_qd as jmake
    from ttcross_tpu_torch.apps import TPI_STR, make_stdnorm_qd

    seen = _engines(monkeypatch)
    jp, jf, jw = jmake(d=4, n=201)
    jres = JE.cross_qd(jf, [jp.n] * 4, max_rank=4, quad=jw)
    pp, pf, pw = make_stdnorm_qd(d=4, n=201, device="cpu")
    pres = PE.cross_qd(pf, [pp.n] * 4, max_rank=4, quad=pw, device="cpu")
    assert_same_run(jres, pres, seen["jax"], seen["port"])
    assert pres.ranks == (1, 1, 1, 1, 1) and pres.neval == 9666
    with localcontext() as ctx:
        ctx.prec = 80
        rel = abs(1 - PQ.qd_to_mp(*(float(e) for e in pres.value)) / (Decimal(TPI_STR) / 2) ** 2)
    assert rel < Decimal("1e-60")


def test_one_sweep_from_a_jax_state():
    """A JAX engine swept twice at C_4, n = 17, rank 10; its state (and its
    lottery generator) carried across by qd_state_from_numpy; one more
    sweep in each package leaves the same state, bit for bit."""
    from ttcross_tpu.apps.ising import make_ising_qd as jmake
    from ttcross_tpu_torch.apps import make_ising_qd

    _, jf, _ = jmake(m=4, n=17)
    _, pf, _ = make_ising_qd(m=4, n=17, device="cpu")
    jeng = JE.QdEngine(jf, [17] * 3, 10, 1, None, -7.0, 8, 3)
    jeng.init_state()
    for it in (1, 2):
        for b in (range(2) if it % 2 else range(1, -1, -1)):
            rec = jeng.visit_bond(b, it % 2 == 1)
            if rec is not None and b > 0:
                jeng.apply_left_slice(b, rec["acol"])
            if rec is not None and b < 1:
                jeng.apply_right_slice(b, rec["arow"])
    state = {"vip": jeng.vip, "r": jeng.r, "log_amax": jeng.log_amax,
             "log_pivotmax_prev": jeng.log_pivotmax_prev, "neval": jeng.neval,
             "rng": jeng.rng.bit_generator.state,
             **{k: getattr(jeng, k) for k in ("G", "Cf", "Rf", "itl", "itt")}}
    peng = qd_state_from_numpy(PE.QdEngine(pf, [17] * 3, 10, 1, None, -7.0, 8, 99, "cpu"), state)
    for b in range(2):
        rec = jeng.visit_bond(b, True)
        if rec is not None and b > 0:
            jeng.apply_left_slice(b, rec["acol"])
        if rec is not None and b < 1:
            jeng.apply_right_slice(b, rec["arow"])
    PE.sweep_qd(peng, True)
    assert peng.vip == [[tuple(int(v) for v in pv) for pv in b] for b in jeng.vip]
    assert (peng.r, peng.neval, peng.log_amax) == (list(jeng.r), jeng.neval, jeng.log_amax)
    for k in ("G", "Cf", "Rf", "itl", "itt"):
        for jx, px in zip(getattr(jeng, k), getattr(peng, k)):
            assert _plimbs(px) == _limbs(jx), k


def test_cross_qd_rejects_d1():
    with pytest.raises(ValueError, match="d >= 2"):
        PE.cross_qd(lambda ind: None, [5], device="cpu")


# ------------------------------------------------------ CPU runs (not a test)
def _digits(limbs, truth) -> float:
    from decimal import Decimal, localcontext

    with localcontext() as ctx:
        ctx.prec = 80
        rel = abs(1 - PQ.qd_to_mp(*limbs) / Decimal(truth))
        return float(-rel.log10()) if rel != 0 else 80.0


def _run(which):
    """One phase-17 configuration of chip_smoke.py on the CPU, in the port
    ("port_*") or the JAX package ("jax_*"): digits, evaluations, wall."""
    import time

    from ttcross_tpu.apps.ising import make_ising_qd as jmake
    from ttcross_tpu.cross.defect import cross_defect_corrected_qd as jdefect
    from ttcross_tpu.parallel.engine_qd import cross_qd_parallel as jpar
    from ttcross_tpu_torch.apps import make_ising_qd
    from ttcross_tpu_torch.cross import cross_defect_corrected_qd
    from ttcross_tpu_torch.parallel import cross_qd_parallel

    pkg, conf = which.split("_", 1)
    t0 = time.perf_counter()
    if conf == "c4":                    # cross_qd C_4 n=65 rank 55, seed 0
        if pkg == "jax":
            p, f, w = jmake(m=4, n=65)
            r = JE.cross_qd(f, [p.n] * 3, max_rank=55, quad=w, seed=0)
        else:
            p, f, w = make_ising_qd(m=4, n=65, device="cpu")
            r = PE.cross_qd(f, [p.n] * 3, max_rank=55, quad=w, seed=0, device="cpu")
        out = {"limbs": [float(np.asarray(e)) for e in r.value], "n_evals": r.neval,
               "sweeps": r.sweeps}
    elif conf == "defect":              # C_4 n=33, ranks 16 / 33, 3 levels, key 0
        if pkg == "jax":
            p, f, w = jmake(m=4, n=33)
            limbs, info = jdefect(p.fun, f, [p.n] * 3, w, max_rank=16, max_rank2=33, levels=3)
        else:
            p, f, w = make_ising_qd(m=4, n=33, device="cpu")
            limbs, info = cross_defect_corrected_qd(p.fun, f, [p.n] * 3, w, max_rank=16,
                                                    max_rank2=33, levels=3, device="cpu")
        out = {"limbs": list(limbs), "n_evals": info["nevals"],
               "ranks": [list(x) for x in info["ranks"]]}
    else:                               # "par": 2 workers, C_4 n=65 rank 33, seed 0
        if pkg == "jax":
            p, f, w = jmake(m=4, n=65)
            r = jpar(f, [p.n] * 3, max_rank=33, quad=w, seed=0, n_workers=2)
        else:
            p, f, w = make_ising_qd(m=4, n=65, device="cpu")
            r = cross_qd_parallel(f, [p.n] * 3, max_rank=33, quad=w, seed=0, n_workers=2,
                                  device="cpu")
        out = {"limbs": [float(np.asarray(e)) for e in r.value], "n_evals": r.neval,
               "sweeps": r.sweeps}
    out["wall_s"] = time.perf_counter() - t0
    out["digits"] = _digits(out["limbs"], ISING_C_STR[4])
    return out


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_engine_qd.py [name ...]
    # prints both packages' digits, evaluations and walls at the phase-17
    # configurations of chip_smoke.py (the floors QD_C4_FLOOR and
    # QD_DEFECT_FLOOR stand on them); names: {port,jax}_{c4,defect,par}.
    # Minutes each on one core (the defect: 4-5).
    import json
    import sys

    torch.set_num_threads(1)
    for name in sys.argv[1:] or ["port_c4", "jax_c4", "port_par", "jax_par", "port_defect",
                                 "jax_defect"]:
        print(name, json.dumps(_run(name)), flush=True)
