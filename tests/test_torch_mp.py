"""The port's mp substrate (ops/mp.py), the mp Ising problem
(apps/ising.py::make_ising_mp) and the truths (apps/truths.py) against the
JAX package's, string for string.

Both packages run the same mpmath in this interpreter, so every mp value
is compared exactly (its decimal string at the working precision); the
truths are compared as the strings they are."""

import pickle

import numpy as np
import pytest
from mpmath import mp, mpf

import ttcross_tpu  # noqa: F401  (x64)
import ttcross_tpu.apps.ising as JI
import ttcross_tpu.apps.truths as JT
import ttcross_tpu.ops.mp as JM
import ttcross_tpu_torch.apps.ising as PI
import ttcross_tpu_torch.apps.truths as PT
import ttcross_tpu_torch.ops.mp as PM


def _s(v, dps):
    with JM.workdps(dps):
        return mp.nstr(v, dps, strip_zeros=False)


def _strs(a, dps):
    return [_s(v, dps) for v in np.asarray(a, dtype=object).reshape(-1)]


# ------------------------------------------------------------------ truths
@pytest.mark.parametrize("m", sorted(JT.ISING_C_STR))
def test_ising_c_strings_are_the_jax_packages(m):
    assert PT.ISING_C_STR[m] == JT.ISING_C_STR[m]
    assert PT.ising_truth_str("C", m) == JT.ising_truth_str("C", m)
    assert PT.ising_truth("C", m) == JT.ising_truth("C", m)
    assert PT.ising_truth_mp("C", m, 120) == JT.ising_truth_mp("C", m, 120)


@pytest.mark.parametrize("key", sorted(JT.ISING_DE_STR))
def test_ising_de_strings_are_the_jax_packages(key):
    kind, m = key
    assert PT.ISING_DE_STR[key] == JT.ISING_DE_STR[key]
    assert PT.ising_truth_str(kind, m) == JT.ising_truth_str(kind, m)
    assert PT.ising_truth_mp(kind, m, 120) == JT.ising_truth_mp(kind, m, 120)


def test_constants_carry_the_full_strings():
    """2 pi, log 2 and zeta(3) at ~1000 digits, C_m at ~500: the port's
    strings before this slice were cut to 70."""
    for name in ("TPI_STR", "LOG2_STR", "ZETA3_STR"):
        assert getattr(PT, name) == getattr(JT, name)
        assert len(getattr(PT, name)) > 990
    assert len(PT.ISING_C_STR[4]) > 400
    assert PT.TPI == JT.TPI and PT.LOG2 == JT.LOG2 and PT.ZETA3 == JT.ZETA3


@pytest.mark.parametrize("kind", ["D", "E"])
@pytest.mark.parametrize("m", [2, 3, 4])
def test_small_de_closed_forms_at_dps_120(kind, m):
    """The untabulated small D / E: the mpmath closed forms, as strings at
    dps 120 and as mpf, equal to the JAX package's; the f64 truth too."""
    assert PT.ising_truth_str(kind, m, dps=120) == JT.ising_truth_str(kind, m, dps=120)
    assert PT.ising_truth_str(kind, m, 60) == JT.ising_truth_str(kind, m, 60)
    assert PT.ising_truth_mp(kind, m, 120) == JT.ising_truth_mp(kind, m, 120)
    assert PT.ising_truth(kind, m) == JT.ising_truth(kind, m)


def test_unknown_truths_raise():
    for fn in (PT.ising_truth_str, PT.ising_truth_mp):
        with pytest.raises(KeyError):
            fn("X", 4)
        with pytest.raises(KeyError):
            fn("C", 7)


# ------------------------------------------------------------------ ops/mp
def test_mp_substrate_matches_jax():
    assert PM.dps_newton_iters(120) == JM.dps_newton_iters(120)
    assert [PM.dps_newton_iters(k) for k in (10, 40, 80, 300)] == \
        [JM.dps_newton_iters(k) for k in (10, 40, 80, 300)]
    with PM.workdps(50):
        assert mp.dps == 50
        a, b = PM.mp_array([1, 0.5, mpf(3) / 7]), JM.mp_array([1, 0.5, mpf(3) / 7])
        assert _strs(a, 50) == _strs(b, 50)
        assert PM.mp_zeros((2, 3)).shape == (2, 3) and all(v == 0 for v in PM.mp_zeros(4))
        assert PM.to_mpf(0.1) == JM.to_mpf(0.1) == mpf(0.1)
    assert mp.dps != 50
    for v in (mpf(0), mpf(10) ** -400, mpf("1.5e300") ** 3, mpf(-7)):
        assert PM.mag10(v) == JM.mag10(v)
    assert PM.mag10(0) == float("-inf")


@pytest.mark.parametrize("n, dps", [(9, 40), (17, 120), (20, 60)])
def test_mp_lgwt_matches_jax(n, dps):
    (px, pw), (jx, jw) = PM.mp_lgwt(n, dps), JM.mp_lgwt(n, dps)
    assert _strs(px, dps) == _strs(jx, dps) and _strs(pw, dps) == _strs(jw, dps)
    xf, wf = np.polynomial.legendre.leggauss(n)
    np.testing.assert_allclose([float(v) for v in px], xf, atol=1e-14)
    np.testing.assert_allclose([float(v) for v in pw], wf, atol=1e-14)


# ---------------------------------------------------------- make_ising_mp
@pytest.mark.parametrize("kind, m, n, dps", [("C", 4, 17, 40), ("D", 4, 16, 60),
                                             ("E", 5, 9, 120), ("C", 6, 9, 30)])
def test_make_ising_mp_matches_jax(kind, m, n, dps):
    pd, pn, pf, pq, pt = PI.make_ising_mp(kind, m=m, n=n, dps=dps)
    jd, jn, jf, jq, jt = JI.make_ising_mp(kind, m=m, n=n, dps=dps)
    assert (pd, pn) == (jd, jn) and len(pq) == len(jq) == pd
    assert _strs(pq[0], dps) == _strs(jq[0], dps)
    assert (pt is None) == (jt is None) and (pt is None or _s(pt, dps) == _s(jt, dps))
    ind = np.random.default_rng(7).integers(0, pn, (40, pd))
    assert _strs(pf(ind), dps) == _strs(jf(ind), dps)
    # the integrand pickles (into cross_mp_parallel's spawned workers) and
    # evaluates the same after the round trip
    again = pickle.loads(pickle.dumps(pf))
    assert isinstance(again, PI.IsingMP) and _strs(again(ind[:5]), dps) == _strs(pf(ind[:5]), dps)


def test_make_ising_mp_rejects_unknown_kind():
    with pytest.raises(ValueError):
        PI.make_ising_mp("X", 4, 9, 30)
