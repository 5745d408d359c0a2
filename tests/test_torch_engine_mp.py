"""The port's mpmath cross engine (cross/engine_mp.py::cross_mp) against the
JAX package's, string for string.

Both engines draw their lottery from np.random.default_rng(seed) and do the
same mpmath operations in the same order, so the value, every per-sweep
history entry (value and err as strings at the working precision, the
log10 pivots and evaluation counts as numbers), the solved cores, neval,
ranks and sweeps are equal.  The cases are the JAX tests'
(tests/test_engine_mp.py): Ising C_4, D_4 and E_4, the exact-rank recovery
of a separable-plus-separable tensor, and the same tensor scaled by
1e-400, beyond f64's range (the log-domain thresholds)."""

import numpy as np
import pytest
from mpmath import mp, mpf

import ttcross_tpu  # noqa: F401  (x64)
import ttcross_tpu.apps.ising as JI
from ttcross_tpu.cross.engine_mp import cross_mp as jcross_mp
from ttcross_tpu.cross.engine_mp import mp_tt_value as jmp_tt_value
from ttcross_tpu_torch.apps import make_ising_mp
from ttcross_tpu_torch.cross import cross_mp, mp_tt_value
from ttcross_tpu_torch.ops.mp import workdps


def _s(v, dps):
    if v is None:
        return None
    with workdps(dps):
        return mp.nstr(v, dps, strip_zeros=False)


def _hist(res, dps):
    return [{k: (_s(v, dps) if k in ("value", "err") else v) for k, v in h.items()}
            for h in res.history]


def assert_same_run(p, j, dps):
    assert (p.neval, p.ranks, p.sweeps) == (j.neval, j.ranks, j.sweeps)
    assert _s(p.value, dps) == _s(j.value, dps)
    assert _hist(p, dps) == _hist(j, dps)
    assert len(p.cores) == len(j.cores)
    for a, b in zip(p.cores, j.cores):
        assert a.shape == b.shape
        assert [_s(v, dps) for v in a.reshape(-1)] == [_s(v, dps) for v in b.reshape(-1)]


class Rank2:
    """The JAX tests' separable-plus-separable mp tensor (exact TT rank 2):
    prod_c g1[c][i_c] + prod_c g2[c][i_c], times `scale`."""

    def __init__(self, d, n, dps, scale=1):
        with workdps(dps):
            self.g1 = [np.array([mpf(2 + j) / (3 + c) for j in range(n)], dtype=object)
                       for c in range(d)]
            self.g2 = [np.array([1 / mpf(1 + j + 2 * c) for j in range(n)], dtype=object)
                       for c in range(d)]
            self.scale = mpf(scale)
        self.d, self.dps = d, dps

    def __call__(self, ind):
        with workdps(self.dps):
            out = np.empty(ind.shape[0], dtype=object)
            for t in range(ind.shape[0]):
                p1, p2 = mpf(1), mpf(1)
                for c in range(self.d):
                    p1 *= self.g1[c][ind[t, c]]
                    p2 *= self.g2[c][ind[t, c]]
                out[t] = (p1 + p2) * self.scale
            return out

    def truth(self):
        with workdps(self.dps):
            s1, s2 = mpf(1), mpf(1)
            for c in range(self.d):
                s1 *= sum(self.g1[c])
                s2 *= sum(self.g2[c])
            return (s1 + s2) * self.scale


@pytest.mark.parametrize("kind, m, n, rank, dps", [("C", 4, 17, 8, 40), ("D", 4, 17, 6, 30),
                                                   ("E", 4, 17, 6, 30), ("C", 5, 9, 5, 30)])
def test_ising_matches_jax(kind, m, n, rank, dps):
    """C_4 at n = 17, rank 8, dps 40 (10.28 digits in the JAX package), the
    D / E kinds and a C_5 (d = 4): the same run in both packages."""
    d, n, f, q, t = make_ising_mp(kind, m=m, n=n, dps=dps)
    _, _, jf, jq, jt = JI.make_ising_mp(kind, m=m, n=n, dps=dps)
    p = cross_mp(f, [n] * d, max_rank=rank, pivoting=1, quad=q, truth=t, dps=dps)
    j = jcross_mp(jf, [n] * d, max_rank=rank, pivoting=1, quad=jq, truth=jt, dps=dps)
    assert_same_run(p, j, dps)
    assert p.history[-1]["err"] is not None and p.history[-1]["value"] is not None
    if kind == "C" and m == 4:
        with workdps(dps):
            digits = float(-mp.log10(abs(1 - p.value / t)))
        assert digits > 10.0, digits
        with workdps(dps):
            assert _s(mp_tt_value(p.cores, q), dps) == _s(jmp_tt_value(j.cores, jq), dps)


def test_seed_and_greedy_pivoting_match_jax():
    """Another seed, and pivoting=0 (one column and one row per visit)."""
    d, n, f, q, t = make_ising_mp("C", m=4, n=9, dps=30)
    _, _, jf, jq, jt = JI.make_ising_mp("C", m=4, n=9, dps=30)
    for kw in (dict(seed=3), dict(pivoting=0)):
        p = cross_mp(f, [n] * d, max_rank=5, quad=q, truth=t, dps=30, **kw)
        j = jcross_mp(jf, [n] * d, max_rank=5, quad=jq, truth=jt, dps=30, **kw)
        assert_same_run(p, j, 30)


def test_exact_rank_recovery_matches_jax():
    """The rank-2 tensor is recovered to ~dps digits (ranks 2), the same
    run as the JAX package's; the interpolant is exact at probed entries."""
    d, n, dps = 4, 6, 60
    fun = Rank2(d, n, dps)
    with workdps(dps):
        w = [np.array([mpf(1) for _ in range(n)], dtype=object)] * d
    tru = fun.truth()
    p = cross_mp(fun, [n] * d, max_rank=4, pivoting=1, quad=w, truth=tru, dps=dps)
    j = jcross_mp(fun, [n] * d, max_rank=4, pivoting=1, quad=w, truth=tru, dps=dps)
    assert_same_run(p, j, dps)
    assert max(p.ranks[1:-1]) == 2
    with workdps(dps):
        assert abs(1 - p.value / tru) < mpf(10) ** (-dps + 8)
        ind = np.random.default_rng(0).integers(0, n, (20, d))
        vals = fun(ind)
        for t in range(20):
            v = None
            for c in range(d):
                M = p.cores[c][:, ind[t, c], :]
                v = M if v is None else v @ M
            assert abs(v[0, 0] - vals[t]) < abs(vals[t]) * mpf(10) ** (-dps + 8)


def test_log_domain_extreme_scale_matches_jax():
    """The tensor scaled by 1e-400, beyond f64's underflow: the log-domain
    thresholds keep the cross converging, in both packages alike."""
    d, n, dps = 3, 5, 50
    with workdps(dps):
        fun = Rank2(d, n, dps, scale=mpf(10) ** -400)
        w = [np.array([mpf(1)] * n, dtype=object)] * d
    p = cross_mp(fun, [n] * d, max_rank=4, pivoting=1, quad=w, dps=dps)
    j = jcross_mp(fun, [n] * d, max_rank=4, pivoting=1, quad=w, dps=dps)
    assert_same_run(p, j, dps)
    assert p.value != 0
    with workdps(dps):
        assert abs(1 - p.value / fun.truth()) < mpf(10) ** (-dps + 10)


def test_cross_mp_rejects_one_mode_and_keeps_the_callers_precision():
    dps0 = mp.dps
    with pytest.raises(ValueError):
        cross_mp(Rank2(1, 3, 30), [3], dps=30)
    d, n, f, q, t = make_ising_mp("C", m=3, n=5, dps=30)
    res = cross_mp(f, [n] * d, max_rank=3, quad=q, dps=30)
    assert mp.dps == dps0 and res.value is not None and res.ranks[0] == res.ranks[-1] == 1
