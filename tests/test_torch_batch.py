"""The port's cross_batch (a lane axis through the sequential engine)
against the JAX package's (jax.vmap of its fused engine).

Lanes are fed the JAX lanes' lottery uniforms, recomputed from
jax.random.split(PRNGKey(key), L)[l] and the engine's key chain
(ttcross_tpu/cross/engine.py:798-799).  With the same uniforms each port
lane makes the JAX lane's pivot choices: ranks, sweeps and n_evals after
every sweep exactly, values to 1e-12.  A JAX lane whose stop comes first is
frozen, not swept on (vmap of lax.while_loop selects a finished lane's old
carry), so it is the single JAX run with that lane's key: its final vip is
compared with that run's.  The MVN family is perturbed (per-lane mean and
covariance) so that no two hunt candidates tie to the last bit
(tests/test_torch_apps_mvn.py's note).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_batch.py

prints both packages' worst-lane digits of bench.py's family configuration
(mvn_d6, 4 lanes, corr 0.2-0.6, rank 20) over keys 0-3, the CPU runs that
chip_smoke.py's floor for the family stands on.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from ttcross_tpu.apps import make_mvn_family as jmake_family
from ttcross_tpu.cross import cross as jcross, cross_batch as jcross_batch
from ttcross_tpu_torch.apps import make_mvn_family
from ttcross_tpu_torch.cross import cross, cross_batch, lane_batched, lane_key
from ttcross_tpu_torch.cross.batch import _cross_batch
from ttcross_tpu_torch.parallel import BondMesh
from ttcross_tpu_torch.tt import TT, full

L = 3


def _lane_uniforms(key, L, sweeps, d, nlot):
    """(sweeps, L, d-1, 2, nlot): the JAX lanes' uniforms."""
    out = []
    for k in jax.random.split(jax.random.PRNGKey(key), L):
        lane = []
        for _ in range(sweeps):
            k, sub = jax.random.split(k)
            lane.append(np.asarray(jax.random.uniform(sub, (d - 1, 2, nlot), jnp.float64)))
        out.append(np.stack(lane))
    return np.stack(out, axis=1)


def _port_batch(fun, n, params, R, key, **kw):
    base = dict(accuracy=None, pivoting=1, quad=None, truth=None, dtype=torch.float64,
                verbose=False, max_sweeps=None, small_element=None, small_pivot=None,
                sweep_mode="sequential", mesh=None, device="cpu")
    base.update(kw)
    sweeps = base["max_sweeps"] or R - 1
    lanes = len(torch.utils._pytree.tree_leaves(params)[0])
    U = _lane_uniforms(key, lanes, sweeps, len(n), 2 * (R + max(n)))
    return _cross_batch(fun, n, params, max_rank=R, key=key, uniforms=U, **base)


def _families(d=4, n=17):
    """Both packages' MVN family over corr 0.2-0.6, each lane's mean and
    covariance perturbed."""
    jf = jmake_family(d=d, n=n, corrs=np.linspace(0.2, 0.6, L))
    rng = np.random.default_rng(11)
    mu, inv_cov, norm = [], [], []
    for c in jf.corrs:
        cov = np.full((d, d), 0.16 * c) + np.diag(np.full(d, 0.16 * (1 - c)))
        A = rng.normal(size=(d, d)) * 0.1
        cov = cov + A @ A.T
        mu.append(np.log(100.0) - 0.08 + rng.normal(size=d) * 0.1)
        inv_cov.append(np.linalg.inv(cov))
        norm.append(np.sqrt((2 * np.pi) ** d * np.linalg.det(cov)))
    params = {"mu": np.stack(mu), "inv_cov": np.stack(inv_cov), "norm": np.array(norm)}
    jf = dataclasses.replace(jf, params={k: jnp.asarray(v) for k, v in params.items()})
    pf = make_mvn_family(d=d, n=n, corrs=np.linspace(0.2, 0.6, L), device="cpu")
    pf = dataclasses.replace(pf, params={k: torch.from_numpy(v) for k, v in params.items()})
    return jf, pf


def _assert_same_lane(p, j, rtol=1e-12):
    assert p.ranks == j.ranks and p.sweeps == j.sweeps and p.neval == j.neval
    assert p.padded_evals == j.padded_evals
    assert [h.n_evals for h in p.history] == [h.n_evals for h in j.history]
    np.testing.assert_allclose(p.values, j.values, rtol=rtol)


def _jax_single(fun, n, params, lane, key, L, **kw):
    """The JAX package's cross() of one lane with the lane's split key."""
    par = torch.utils._pytree.tree_map(lambda a: a[lane], params)
    return jcross(lambda i: fun(i, par), n, key=jax.random.split(jax.random.PRNGKey(key), L)[lane],
                  return_state=True, **kw)


def _assert_is_jax(pres, jres, jfun, n, jparams, key, **kw):
    """Every port lane is the JAX lane, and its pivots those of the single
    JAX run with the lane's key."""
    assert len(pres) == len(jres) and pres.neval == jres.neval and pres.sweeps == jres.sweeps
    for lane in range(len(pres)):
        _assert_same_lane(pres[lane], jres[lane])
        single = _jax_single(jfun, n, jparams, lane, key, len(pres), **kw)
        _assert_same_lane(pres[lane], single)
        assert np.array_equal(pres[lane].state.vip, np.asarray(single.state.vip))
        scale = max(float(np.abs(np.asarray(c)).max()) for c in jres[lane].tt.cores)
        for a, b in zip(pres[lane].tt.cores, jres[lane].tt.cores):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-11 * scale)


def test_mvn_family_lanes_match_the_jax_lanes():
    """The perturbed MVN family (d = 4, n = 17, rank 6, 3 lanes), the
    family's integrand lane-batched (one lookup for every lane)."""
    jf, pf = _families()
    kw = dict(pivoting=1, accuracy=500 * 2.2e-16, quad=[jf.quad_weights] * 4, truth=1.0)
    jres = jcross_batch(jf.fun, [jf.n] * 4, jf.params, max_rank=6, key=7, **kw)
    pres = _port_batch(pf.fun, (pf.n,) * 4, pf.params, 6, 7, **kw)
    _assert_is_jax(pres, jres, jf.fun, [jf.n] * 4, jf.params, 7, max_rank=6, **kw)


def test_jacobi_lanes_match_the_jax_lanes():
    """cross_batch(sweep_mode="jacobi"): every (bond, lane) row of the
    perturbed MVN family (d = 4, n = 17, rank 6, 3 lanes) hunts in one
    batch, kernel A batched over P = lanes x bonds fibers, fed the JAX lanes'
    uniforms: each lane is the JAX lane of jax.vmap over its all-bonds
    engine (ranks, sweeps, n_evals after every sweep, values), its pivots
    those of the single JAX run with the lane's key, and its train within
    1e-12 of the JAX lane's (the dense tensors: the all-bonds apply divides
    the factors by the pivots in another order of sums).  (The JAX hunt
    ranks its residuals in f32; on this family no pick meets an f32
    near-tie.)"""
    from ttcross_tpu.tt import full as jfull

    jf, pf = _families()
    kw = dict(pivoting=1, accuracy=500 * 2.2e-16, quad=[jf.quad_weights] * 4, truth=1.0,
              sweep_mode="jacobi")
    jres = jcross_batch(jf.fun, [jf.n] * 4, jf.params, max_rank=6, key=7, **kw)
    pres = _port_batch(pf.fun, (pf.n,) * 4, pf.params, 6, 7, **kw)
    assert len(pres) == len(jres) and pres.neval == jres.neval and pres.sweeps == jres.sweeps
    for lane in range(L):
        _assert_same_lane(pres[lane], jres[lane])
        single = _jax_single(jf.fun, [jf.n] * 4, jf.params, lane, 7, L, max_rank=6, **kw)
        _assert_same_lane(pres[lane], single)
        assert np.array_equal(pres[lane].state.vip, np.asarray(single.state.vip))
        want = np.asarray(jfull(jres[lane].tt))
        np.testing.assert_allclose(full(pres[lane].tt).numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


def test_jacobi_lanes_are_their_single_runs():
    """Each lane of cross_batch(sweep_mode="jacobi") is the port's
    cross(sweep_mode="jacobi") with the lane's parameters and key
    lane_key(key, l): ranks, sweeps, n_evals and vip equal, values to 1e-12
    (on the CPU the plain batched kernel A sums over another number of
    rows); a lane that stops first is frozen while the others sweep on."""
    _, pf = _families()
    kw = dict(pivoting=1, accuracy=500 * 2.2e-16, quad=[pf.quad_weights] * 4, truth=1.0,
              device="cpu", sweep_mode="jacobi")
    res = cross_batch(pf.fun, [pf.n] * 4, pf.params, max_rank=6, key=5, **kw)
    for lane in range(L):
        par = pf.lane(lane)
        single = cross(lambda i, p=par: pf.fun(i, p), [pf.n] * 4, max_rank=6,
                       key=lane_key(5, lane), return_pivots=True, **kw)
        _assert_same_lane(res[lane], single)
        assert np.array_equal(res[lane].state.vip, single.state.vip)


def test_lanes_are_their_single_runs():
    """Each lane of the port's cross_batch is the port's cross() with the
    lane's parameters and key lane_key(key, l): ranks, sweeps, n_evals and
    vip equal, values to 1e-12 (on the CPU the plain version of kernel A
    batched over the lanes sums in another order than the single one's, a
    batched BLAS product against a gemv; on the card the kernels are
    bit-equal, and chip_smoke.py holds every lane to its single run there).  The family's integrand evaluates every lane in one
    call: the lane-batched form agrees with the per-lane one."""
    _, pf = _families()
    kw = dict(pivoting=1, accuracy=500 * 2.2e-16, quad=[pf.quad_weights] * 4, truth=1.0,
              device="cpu")
    res = cross_batch(pf.fun, [pf.n] * 4, pf.params, max_rank=6, key=3, **kw)
    for lane in range(L):
        par = pf.lane(lane)
        single = cross(lambda i, p=par: pf.fun(i, p), [pf.n] * 4, max_rank=6,
                       key=lane_key(3, lane), return_pivots=True, **kw)
        _assert_same_lane(res[lane], single)
        assert np.array_equal(res[lane].state.vip, single.state.vip)
    ind = torch.randint(0, pf.n, (L, 50, 4), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32)
    together = pf.fun(ind, pf.params)
    apart = torch.stack([pf.fun(ind[i], pf.lane(i)) for i in range(L)])
    np.testing.assert_allclose(together.numpy(), apart.numpy(), rtol=1e-14)
    assert lane_key(3, 0) != lane_key(3, 1) and lane_key(3, 1) == lane_key(3, 1) < 2 ** 63


def _lane_cores(rng, d, n, r):
    shapes = [(1 if i == 0 else r, n, r if i < d - 1 else 1) for i in range(d)]
    return [rng.standard_normal((L,) + s) for s in shapes]


def _tt_entry_jax(ind, par):
    v = par[0][0, ind[:, 0], :]
    for c in range(1, len(par)):
        v = jnp.einsum("br,rbs->bs", v, par[c][:, ind[:, c], :])
    return v[:, 0]


def _tt_entry(ind, par):
    """The exact entry of a lane's TT (par: its cores) at each index row;
    generic torch, so cross_batch vmaps it over the lanes."""
    ind = ind.long()
    v = par[0][0].index_select(0, ind[:, 0])
    for c in range(1, len(par)):
        v = torch.einsum("br,rbs->bs", v, par[c].index_select(1, ind[:, c]))
    return v[:, 0]


@pytest.mark.parametrize("piv", [1, -1], ids=["rook", "full"])
def test_lanes_stop_apart_and_freeze(piv):
    """A family of exact TTs of ranks 1, 2 and 3 (in rank-3 cores): with
    accuracy 1e-12 the lanes meet their strike-3 stop at sweeps 3, 4 and 5,
    and a stopped lane is frozen while the others sweep on, as in the JAX
    package: each lane is the JAX lane and the single JAX run with its key,
    recovered to round-off (tests/test_batch.py:36-53), with rook and with
    full pivoting (kernel A's 2-D path once per lane)."""
    d, n = 4, 6
    cores = _lane_cores(np.random.default_rng(2), d, n, 3)
    for lane, r in enumerate((1, 2, 3)):
        for c in range(d):
            if c > 0:
                cores[c][lane, r:] = 0
            if c < d - 1:
                cores[c][lane, :, :, r:] = 0
    kw = dict(max_rank=5, pivoting=piv, accuracy=1e-12, max_sweeps=8)
    jparams = [jnp.asarray(c) for c in cores]
    jres = jcross_batch(_tt_entry_jax, [n] * d, jparams, key=3, **kw)
    pres = _port_batch(_tt_entry, (n,) * d, [torch.from_numpy(c) for c in cores], 5, 3,
                       **{k: v for k, v in kw.items() if k != "max_rank"})
    assert [r.sweeps for r in pres] == [3, 4, 5]
    _assert_is_jax(pres, jres, _tt_entry_jax, [n] * d, jparams, 3, **kw)
    for lane in range(L):
        dense = full(TT(tuple(torch.from_numpy(c[lane]) for c in cores))).numpy()
        got = full(pres[lane].tt).numpy()
        assert np.abs(got - dense).max() < 1e-10 * np.abs(dense).max()
        assert max(pres[lane].ranks) == lane + 1


def test_gaussian_width_family_matches_jax():
    """A vmapped integrand with a scalar parameter per lane (exp(-a |x|^2)
    on [-8, 8]^4, tests/test_batch.py:76-97): rank 1 in every lane, the
    lanes' values those of the JAX lanes, neval the family's total."""
    d, nq = 4, 17
    x, w = np.polynomial.legendre.leggauss(nq)
    x, w = 8 * x, 8 * w
    nodes = torch.from_numpy(x)
    alphas = np.array([0.5, 1.0, 2.0])
    truths = [(np.pi / a) ** (d / 2) for a in alphas]

    def fun(ind, a):
        xs = nodes[ind.long()]
        return torch.exp(-a * (xs * xs).sum(dim=1))

    jx = jnp.asarray(x)
    jres = jcross_batch(lambda ind, a: jnp.exp(-a * jnp.sum(jx[ind] ** 2, axis=1)), [nq] * d,
                        jnp.asarray(alphas), max_rank=4, pivoting=1, accuracy=1e-12,
                        quad=[w] * d, truth=truths, key=0)
    pres = _port_batch(fun, (nq,) * d, torch.from_numpy(alphas), 4, 0, accuracy=1e-12,
                       quad=[w] * d, truth=truths)
    assert pres.neval == sum(r.neval for r in pres) == jres.neval
    for lane in range(L):
        _assert_same_lane(pres[lane], jres[lane])
        assert pres[lane].ranks == (1,) * (d + 1)


def test_argument_checks_match_jax():
    """The JAX package's ValueErrors as ValueErrors, and the mesh's lane
    count check."""
    jfun = lambda ind, par: jnp.zeros(ind.shape[0])  # noqa: E731
    pfun = lambda ind, par: torch.zeros(ind.shape[0], dtype=torch.float64)  # noqa: E731
    cases = [((lambda z: [z((2, 3)), z((3,))]), {}, "lane-axis"),
             ((lambda z: {"a": z((2, 3)), "b": z(())}), {}, "0-d leaf"),
             ((lambda z: z((2,))), dict(pivoting=-1, sweep_mode="jacobi"), "jacobi"),
             ((lambda z: z((2,))), dict(sweep_mode="sideways"), "sweep_mode"),
             ((lambda z: z((2,))), dict(max_rank=1), "max_rank"),
             ((lambda z: z((2,))), dict(truth=[1.0, 2.0, 3.0]), "truth")]
    for params, extra, match in cases:
        kw = {"max_rank": 2, **extra}
        with pytest.raises(ValueError, match=match):
            jcross_batch(jfun, [4] * 3, params(jnp.zeros), **kw)
        with pytest.raises(ValueError, match=match):
            cross_batch(pfun, [4] * 3, params(lambda s: torch.zeros(s, dtype=torch.float64)),
                        device="cpu", **kw)
    with pytest.raises(ValueError, match="d >= 2"):
        jcross_batch(jfun, [4], jnp.zeros((2,)))
    with pytest.raises(ValueError, match="d >= 2"):
        cross_batch(pfun, [4], torch.zeros(2), device="cpu")
    # the lanes of a mesh's run are sharded over its ranks
    # (tests/test_torch_parallel_misc.py runs it)
    mesh = BondMesh(group=None, rank=0, size=3, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="divisible"):
        cross_batch(pfun, [4] * 3, torch.zeros(2), mesh=mesh)
    assert lane_batched(pfun) is pfun and pfun.lane_batched


def worst_lane_digits(keys=range(4)):
    """Both packages' worst-lane digits of bench.py's family line on the CPU."""
    jf = jmake_family(d=6, n=65, corrs=np.linspace(0.2, 0.6, 4))
    pf = make_mvn_family(d=6, n=65, corrs=np.linspace(0.2, 0.6, 4), device="cpu")
    kw = dict(max_rank=20, pivoting=1, accuracy=500 * 2.2e-16, quad=[jf.quad_weights] * 6,
              truth=1.0)
    for key in keys:
        p = cross_batch(pf.fun, [pf.n] * 6, pf.params, key=key, device="cpu", **kw)
        j = jcross_batch(jf.fun, [jf.n] * 6, jf.params, key=key, **kw)
        pd = [round(float(-np.log10(r.errors[-1])), 3) for r in p]
        jd = [round(float(-np.log10(r.errors[-1])), 3) for r in j]
        print(f"key {key}: port lanes {pd} worst {min(pd)} evals {p.neval}; "
              f"jax lanes {jd} worst {min(jd)} evals {j.neval}", flush=True)


if __name__ == "__main__":
    worst_lane_digits()
