"""The port's alternating-maxvol refinement against the JAX package's.

maxvol_select's pivot order is the algorithm, so the selections are held
exactly; the coefficient matrices to 1e-10 of their scale; a refinement
from the same (I, J) sets picks the same index sets after every sweep and
counts the same evaluations.  The MVN problem here has a perturbed mean
and covariance: the default one is symmetric under permutations of its
modes, and equal candidates would leave a selection to the last bit."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from ttcross_tpu.apps import make_mvn as jmake_mvn
from ttcross_tpu.apps.mvn import MvnDensity as JMvnDensity, MvnProblem as JMvnProblem
from ttcross_tpu.cross import cross as jcross, cross_maxvol as jcross_maxvol
from ttcross_tpu.cross import maxvol_refine as jmaxvol_refine
from ttcross_tpu.cross.chains import pivot_index_sets as jpivot_index_sets
from ttcross_tpu.cross.maxvol import (_pad_sets as jpad_sets, _refine_engine as jrefine_engine,
                                      masked_solve as jmasked_solve, maxvol_select as jmaxvol_select)
from ttcross_tpu_torch.cross import cross_maxvol, masked_solve, maxvol_refine, maxvol_select
from ttcross_tpu_torch.cross.chains import pivot_index_sets
from ttcross_tpu_torch.cross.maxvol import _refine_engine
from ttcross_tpu_torch.interop import mvn_from_numpy, sets_from_numpy

RTOL_B = 1e-10


@pytest.fixture
def rng():
    return np.random.default_rng(20260907)


@pytest.fixture(scope="module")
def problem():
    """(JAX problem, port problem, the greedy cross's (I, J) pivot sets)."""
    d, n = 4, 17
    jp = jmake_mvn(d=d, n=n)
    r = np.random.default_rng(5)
    A = r.normal(size=(d, d)) * 0.1
    cov, mu = jp.density.cov + A @ A.T, jp.density.mu + r.normal(size=d) * 0.1
    dn = JMvnDensity(mu=mu, cov=cov, inv_cov=np.linalg.inv(cov), det_cov=float(np.linalg.det(cov)))
    jp = JMvnProblem(d=d, n=jp.n, nodes=jp.nodes, quad_weights=jp.quad_weights, density=dn,
                     truth=1.0)
    pp = mvn_from_numpy(jp.nodes, jp.quad_weights, dn.mu, dn.cov, dn.inv_cov, dn.det_cov, "cpu")
    res = jcross(jp.fun, [jp.n] * d, max_rank=6, pivoting=1, key=0, return_state=True)
    vip, rk = np.asarray(res.state.vip), np.asarray(res.state.rk)
    sets = jpivot_index_sets(vip, rk)
    assert pivot_index_sets(torch.from_numpy(vip.copy()), torch.from_numpy(rk.copy())) == sets
    return jp, pp, sets


@pytest.mark.parametrize("P,R,r_act,stride", [(40, 6, 6, 1), (60, 8, 5, 3), (30, 4, 1, 2),
                                              (51, 7, 7, 1)])
def test_maxvol_select_matches_jax(P, R, r_act, stride, rng):
    """Random M with padded columns zeroed and a strided candidate mask:
    sel equal on the active block, B to 1e-10, and B[sel[t]] = e_t."""
    mask = np.zeros(P, bool)
    mask[::stride] = True
    M = rng.normal(size=(P, R)) * mask[:, None] * (np.arange(R) < r_act)[None, :]
    for n_exchange in (0, 8):
        sel, B = maxvol_select(torch.from_numpy(M), torch.from_numpy(mask), r_act,
                               n_exchange=n_exchange)
        jsel, jB = jmaxvol_select(jnp.asarray(M), jnp.asarray(mask), r_act, n_exchange=n_exchange)
        assert np.array_equal(sel.numpy(), np.asarray(jsel))
        np.testing.assert_allclose(B.numpy(), np.asarray(jB), rtol=0,
                                   atol=RTOL_B * np.max(np.abs(np.asarray(jB))))
        np.testing.assert_allclose(B.numpy()[sel.numpy()[:r_act], :r_act], np.eye(r_act),
                                   rtol=0, atol=1e-12)
    # the same with the rank as a 0-d tensor, as a bond visit passes it
    sel_t, _ = maxvol_select(torch.from_numpy(M), torch.from_numpy(mask), torch.tensor(r_act))
    assert torch.equal(sel_t, sel)


def test_maxvol_select_exchange_latches_after_the_first_quiet_step(rng):
    """A tolerance that the second exchange does not reach: the loop stops
    for good, as the JAX loop's done flag does, also where a later step
    would improve again."""
    M = rng.normal(size=(80, 5))
    mask = np.ones(80, bool)
    for tol in (1.0, 1.2, 1.5, 3.0):
        sel, B = maxvol_select(torch.from_numpy(M), torch.from_numpy(mask), 5, n_exchange=12, tol=tol)
        jsel, jB = jmaxvol_select(jnp.asarray(M), jnp.asarray(mask), 5, n_exchange=12, tol=tol)
        assert np.array_equal(sel.numpy(), np.asarray(jsel)), tol
        np.testing.assert_allclose(B.numpy(), np.asarray(jB), rtol=0, atol=RTOL_B * 10)


@pytest.mark.parametrize("R,K,r_act", [(6, 20, 6), (8, 15, 5), (5, 9, 1)])
def test_masked_solve_matches_jax(R, K, r_act, rng):
    """torch.linalg.solve on the embedded active block against the JAX
    package's Gauss-Jordan elimination: 1e-12 relative."""
    S = rng.normal(size=(R, R)) + 2 * np.eye(R)
    M = rng.normal(size=(R, K))
    got = masked_solve(torch.from_numpy(S), torch.from_numpy(M), r_act).numpy()
    want = np.asarray(jmasked_solve(jnp.asarray(S), jnp.asarray(M), r_act))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.max(np.abs(want)))
    assert np.all(got[r_act:] == 0)
    np.testing.assert_allclose(S[:r_act, :r_act] @ got[:r_act], M[:r_act], rtol=0, atol=1e-12)


@pytest.mark.parametrize("sweeps", [1, 2])
def test_refine_run_picks_the_jax_index_sets(sweeps, problem):
    """run() from the greedy (I, J) sets: LI, RJ, neval, padded equal after
    `sweeps` sweeps; the padded cores to 1e-10 of their scale."""
    jp, pp, (I, J) = problem
    d, n, R = jp.d, (jp.n,) * jp.d, 6
    LI, RJ, rr = jpad_sets(I, J, d, R)
    jc, jLI, jRJ, jnev, jpad = jrefine_engine(jp.fun, n, R, 8, 1.01).run(
        jnp.asarray(LI), jnp.asarray(RJ), jnp.asarray(rr), jnp.asarray(sweeps, jnp.int32))
    tLI, tRJ, trr = sets_from_numpy(LI, RJ, rr, "cpu")
    pc, pLI, pRJ, pnev, ppad = _refine_engine(pp.fun, n, R, 8, 1.01, "cpu").run(tLI, tRJ, trr, sweeps)
    assert np.array_equal(pLI.numpy(), np.asarray(jLI))
    assert np.array_equal(pRJ.numpy(), np.asarray(jRJ))
    assert (int(pnev), int(ppad)) == (int(jnev), int(jpad))
    assert torch.equal(tLI, torch.from_numpy(LI))                  # the inputs are not changed
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=0,
                               atol=RTOL_B * np.max(np.abs(np.asarray(jc))))


def test_refine_parts_match_jax(problem):
    """emit_core (the masked solve on frozen sets) and first_core, bond by
    bond, against the JAX kit's."""
    jp, pp, (I, J) = problem
    d, n, R = jp.d, (jp.n,) * jp.d, 6
    LI, RJ, rr = jpad_sets(I, J, d, R)
    jkit = jrefine_engine(jp.fun, n, R, 8, 1.01)
    pkit = _refine_engine(pp.fun, n, R, 8, 1.01, "cpu")
    tLI, tRJ, trr = sets_from_numpy(LI, RJ, rr, "cpu")
    z, jz = torch.zeros((), dtype=torch.int64), jnp.zeros((), jnp.int64)
    for b in range(d - 1):
        got, nev, pad = pkit.emit_core(b, tLI, tRJ, trr, z, z)
        want, jnev, jpad = jkit.emit_core(b, jnp.asarray(LI), jnp.asarray(RJ), jnp.asarray(rr), jz, jz)
        assert (int(nev), int(pad)) == (int(jnev), int(jpad))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-9 * np.max(np.abs(np.asarray(want))))
    got, nev, pad = pkit.first_core(tRJ, trr, z, z)
    want, jnev, jpad = jkit.first_core(jnp.asarray(RJ), jnp.asarray(rr), jz, jz)
    assert (int(nev), int(pad)) == (int(jnev), int(jpad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


def test_maxvol_refine_and_cross_maxvol_match_jax(problem):
    """The entry points: refinement from the greedy sets, and the classic
    TT-cross from the key's random column sets (numpy's generator in both
    packages): ranks, n_evals, padded evals equal, the value to 1e-10."""
    jp, pp, sets = problem
    d = jp.d
    kw = dict(quad=[jp.quad_weights] * d, truth=1.0)
    jres = jmaxvol_refine(jp.fun, [jp.n] * d, init_sets=sets, sweeps=2, **kw)
    pres = maxvol_refine(pp.fun, [pp.n] * d, init_sets=sets, sweeps=2, device="cpu", **kw)
    jx = jcross_maxvol(jp.fun, [jp.n] * d, max_rank=5, sweeps=2, key=3, **kw)
    px = cross_maxvol(pp.fun, [pp.n] * d, max_rank=5, sweeps=2, key=3, device="cpu", **kw)
    for j, p in ((jres, pres), (jx, px)):
        assert (p.ranks, p.neval, p.padded_evals, p.sweeps) == (j.ranks, j.neval, j.padded_evals,
                                                                j.sweeps)
        np.testing.assert_allclose(p.values, j.values, rtol=1e-10)
        assert p.tt.ready() and p.tt.r == p.ranks and p.converged
    assert pres.errors[-1] < 0.1
    with pytest.raises(ValueError, match="sweeps"):
        maxvol_refine(pp.fun, [pp.n] * d, init_sets=sets, sweeps=0, device="cpu")
    with pytest.raises(ValueError, match="ranks is required"):
        maxvol_refine(pp.fun, [pp.n] * d, device="cpu")
    with pytest.raises(ValueError, match="exceed the padding"):
        maxvol_refine(pp.fun, [pp.n] * d, ranks=[3, 9, 3], max_rank=6, device="cpu")
