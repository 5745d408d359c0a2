"""The port's TT algebra (ttcross_tpu_torch/tt) against the JAX one."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import ttcross_tpu.tt as jtt
from ttcross_tpu.tt.types import TT as JTT
from ttcross_tpu_torch import tt as ptt
from ttcross_tpu_torch.interop import tt_from_numpy

# f64 sums in another order and another QR/SVD implementation: the trains
# agree entrywise to a few hundred ulps of the tensor's norm
RTOL = 1e-12


def _cores(rng, n=(5, 6, 4, 7), r=(1, 3, 5, 4, 1)):
    return [rng.standard_normal((r[c], n[c], r[c + 1])) for c in range(len(n))]


def _close(a, b, scale):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=RTOL * scale)


def test_full_gather_contract(rng):
    cores = _cores(rng)
    jt, pt = JTT(tuple(cores)), tt_from_numpy(cores, "cpu")
    want = np.asarray(jtt.full(jt))
    scale = np.linalg.norm(want)
    _close(ptt.full(pt).numpy(), want, scale)
    ind = np.stack([rng.integers(0, k, 50) for k in pt.n], axis=1)
    _close(ptt.gather(pt, torch.from_numpy(ind)).numpy(), np.asarray(jtt.gather(jt, ind)), scale)
    ws = [rng.random(k) for k in pt.n]
    np.testing.assert_allclose(float(ptt.contract(pt, ws)), float(jtt.contract(jt, ws)),
                               rtol=RTOL)
    np.testing.assert_allclose(float(ptt.contract(pt)), float(jtt.contract(jt)), rtol=RTOL)
    assert pt.r == jt.r and pt.n == jt.n and pt.ready()


def test_value_matches_jax(rng):
    cores = _cores(rng, n=(4,) * 6, r=(1, 2, 3, 3, 3, 2, 1))
    jt, pt = JTT(tuple(cores)), tt_from_numpy(cores, "cpu")
    x = rng.random((20, 2))
    np.testing.assert_allclose(ptt.value(pt, torch.from_numpy(x), dd=2).numpy(),
                               np.asarray(jtt.value(jt, x, dd=2)), rtol=RTOL)


def test_orthogonalize_matches_jax(rng):
    cores = _cores(rng)
    jt, pt = JTT(tuple(cores)), tt_from_numpy(cores, "cpu")
    jo, po = jtt.orthogonalize(jt), ptt.orthogonalize(pt)
    assert po.r == jo.r
    want = np.asarray(jtt.full(jo))
    _close(ptt.full(po).numpy(), want, np.linalg.norm(want))
    for c in range(po.d - 1):   # left-orthogonal cores up to the shared scale
        g = po.cores[c].reshape(-1, po.r[c + 1])
        gram = (g.T @ g).numpy()
        np.testing.assert_allclose(gram / gram[0, 0], np.eye(po.r[c + 1]), atol=1e-13)


@pytest.mark.parametrize("rmax,tol", [(2, 0.0), (3, 0.0), (None, 1e-3)])
def test_svd_round_matches_jax(rmax, tol, rng):
    cores = _cores(rng)
    jt, pt = JTT(tuple(cores)), tt_from_numpy(cores, "cpu")
    jrnd, prnd = jtt.svd_round(jt, tol=tol, rmax=rmax), ptt.svd_round(pt, tol=tol, rmax=rmax)
    assert prnd.r == jrnd.r
    want = np.asarray(jtt.full(jrnd))
    _close(ptt.full(prnd).numpy(), want, np.linalg.norm(want))


def test_chop_rank_matches_jax(rng):
    from ttcross_tpu.tt.ortho import chop_rank as jchop

    s = np.sort(rng.random(12))[::-1] ** 4
    for tol in (None, 1e-1, 1e-3, 1e-8):
        for rmax in (None, 3, 20):
            assert ptt.chop_rank(s, tol, rmax) == jchop(s, tol, rmax)
