"""The MVN / COS option-pricing path of the port against the JAX package.

The same inputs, made from a numpy seed, go through the JAX function and
its counterpart in the port: the integrands (MVN, the MVN family, stdnorm,
the COS coefficients, the Gaussian characteristic function), the CHF / pdf
post-processing on a train carried across as numpy, accchk on the same
sample indices, and whole cross() runs fed the JAX engine's lottery
uniforms (recomputed from its key chain, ttcross_tpu/cross/engine.py:
798-799).  The JAX side runs the CPU branch of its table lookup.

The default MVN problem is symmetric under permutations of its modes
(equal means, equicorrelated, one grid), so two candidates of a hunt can
have residuals that are equal to the last bit, and which one wins hangs on
rounding: from 12 keys x 5 sweeps of JAX pre-sweep states, 2-3 port sweeps
pick the mirrored pivot (at the same pivot value).  The pivot-for-pivot
tests therefore use a density with a perturbed mean and covariance, where
no such tie exists; the default problem is compared at a key where the two
runs agree.
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from ttcross_tpu.apps import (basket_chf as jbasket_chf, basket_pdf as jbasket_pdf,
                              cos_approximate as jcos_approximate, gaussian_chf as jgaussian_chf,
                              make_cos_coefficients as jmake_cos, make_mvn as jmake_mvn,
                              make_mvn_density as jmake_density,
                              make_mvn_family as jmake_family, make_stdnorm as jmake_stdnorm,
                              s_vectors as js_vectors)
from ttcross_tpu.apps.chf import basket_chf_pair as jbasket_chf_pair
from ttcross_tpu.apps.mvn import MvnDensity as JMvnDensity, MvnProblem as JMvnProblem
from ttcross_tpu.config import precision_thresholds
from ttcross_tpu.cross import accchk as jaccchk, cross as jcross
from ttcross_tpu.cross.engine import CrossConfig as JCrossConfig, make_engine as jmake_engine
from ttcross_tpu.tt import gather as jgather
from ttcross_tpu_torch.apps import (basket_chf, basket_chf_pair, basket_pdf, basket_pdf_pair,
                                    cos_approximate, gaussian_chf, make_cos_coefficients,
                                    make_mvn, make_mvn_family, make_stdnorm, s_vectors)
from ttcross_tpu_torch.cross import accchk, cross
from ttcross_tpu_torch.cross.engine import CrossConfig, _cross, make_engine
from ttcross_tpu_torch.interop import (cos_from_numpy, mvn_from_numpy, state_from_numpy,
                                       stdnorm_from_numpy, tt_from_numpy)
from ttcross_tpu_torch.tt import TT, contract, gather
from ttcross_tpu_torch.tt.serialize import load_state

RTOL_INTEGRAND = 1e-13      # integrands: the same f64 operations, sums in another order
RTOL_POST = 1e-12           # CHF / pdf / accchk: chains of d small matmuls


@pytest.fixture
def rng():
    return np.random.default_rng(20260905)


def _jax_uniforms(key, sweeps, d, nlot):
    """The JAX sweep's U (d-1, 2, NLOT) for sweeps 1..sweeps from PRNGKey(key)."""
    k = jax.random.PRNGKey(key)
    out = []
    for _ in range(sweeps):
        k, sub = jax.random.split(k)
        out.append(np.asarray(jax.random.uniform(sub, (d - 1, 2, nlot), jnp.float64)))
    return np.stack(out)


def _port_mvn(jp):
    dn = jp.density
    return mvn_from_numpy(jp.nodes, jp.quad_weights, dn.mu, dn.cov, dn.inv_cov, dn.det_cov, "cpu")


def _asymmetric_mvn(d=4, n=17):
    """Both packages' MVN problem with a perturbed mean and covariance: no
    permutation symmetry, so no exact ties between hunt candidates."""
    jp = jmake_mvn(d=d, n=n)
    rng = np.random.default_rng(5)
    A = rng.normal(size=(d, d)) * 0.1
    cov = jp.density.cov + A @ A.T
    mu = jp.density.mu + rng.normal(size=d) * 0.1
    dn = JMvnDensity(mu=mu, cov=cov, inv_cov=np.linalg.inv(cov), det_cov=float(np.linalg.det(cov)))
    jp = JMvnProblem(d=d, n=jp.n, nodes=jp.nodes, quad_weights=jp.quad_weights, density=dn,
                     truth=1.0)
    return jp, _port_mvn(jp)


def _assert_rel(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.max(np.abs(want)) * 1e-3)


# ------------------------------------------------------------ set-up and integrands
@pytest.mark.parametrize("d,n", [(6, 65), (4, 16)])
def test_makers_bitwise(d, n):
    jm, pm = jmake_mvn(d=d, n=n), make_mvn(d=d, n=n, device="cpu")
    js, ps = jmake_stdnorm(d=d, n=n), make_stdnorm(d=d, n=n, device="cpu")
    for j, p in ((jm, pm), (js, ps)):
        assert (p.d, p.n, p.truth) == (j.d, j.n, j.truth)
        assert np.array_equal(p.nodes, j.nodes) and np.array_equal(p.quad_weights, j.quad_weights)
        assert np.array_equal(p.table.numpy(), j.nodes)
    for f in ("mu", "cov", "inv_cov"):
        assert np.array_equal(getattr(pm.density, f), getattr(jm.density, f))
    assert pm.density.det_cov == jm.density.det_cov
    assert np.array_equal(s_vectors(d), js_vectors(d))
    jf, pf = jmake_family(d=d, n=n), make_mvn_family(d=d, n=n, device="cpu")
    assert pf.corrs == jf.corrs
    for k in ("mu", "inv_cov", "norm"):
        assert np.array_equal(pf.params[k].numpy(), np.asarray(jf.params[k]))


@pytest.mark.parametrize("name", ["mvn", "mvn_family", "stdnorm", "cos", "gaussian_chf"])
def test_integrands_match_jax(name, rng):
    """Random index batches: 1e-13 relative, and 1e-13 of the batch's
    largest value for entries deep in a tail."""
    d, n, B = 6, 65, 700
    ind = rng.integers(0, n, size=(B, d)).astype(np.int32)
    tind = torch.from_numpy(ind)
    if name == "mvn":
        jp, pp = jmake_mvn(d=d, n=n), make_mvn(d=d, n=n, device="cpu")
        got, want = pp.fun(tind), jp.fun(jnp.asarray(ind))
    elif name == "mvn_family":
        jf, pf = jmake_family(d=d, n=n), make_mvn_family(d=d, n=n, device="cpu")
        lane = 2
        got = pf.fun(tind, pf.lane(lane))
        want = jf.fun(jnp.asarray(ind), {k: v[lane] for k, v in jf.params.items()})
    elif name == "stdnorm":
        jp, pp = jmake_stdnorm(d=d, n=n), make_stdnorm(d=d, n=n, device="cpu")
        got, want = pp.fun(tind), jp.fun(jnp.asarray(ind))
    elif name == "cos":
        dens = jmake_density(d, corr=0.5)
        jc = jmake_cos(d, dens.mu, dens.cov, 0.52517, 8.52517)
        pc = cos_from_numpy(jc.mu, jc.sigma, jc.lower, jc.upper, "cpu")
        ind = rng.integers(0, 12, size=(B, d)).astype(np.int32)    # where the tensor is not ~0
        got, want = pc.fun(torch.from_numpy(ind)), jc.fun(jnp.asarray(ind))
        assert float(np.max(np.abs(np.asarray(want)))) > 1e-6
    else:
        dens = jmake_density(d, corr=0.5)
        omega = rng.normal(size=(5, 40, d))
        got = gaussian_chf(omega, dens.mu, dens.cov, device="cpu")
        want = jgaussian_chf(omega, dens.mu, dens.cov)
        assert got.dtype == torch.complex128
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=RTOL_INTEGRAND, atol=RTOL_INTEGRAND * scale)


def test_integrands_zero_outside_the_table_like_jax():
    """An index outside [0, n) reads node value 0 in both packages."""
    ind = np.array([[0, 1, 2, 3], [16, -1, 5, 2], [3, 17, 0, 1]], np.int32)
    jp, pp = jmake_mvn(d=4, n=17), make_mvn(d=4, n=17, device="cpu")
    _assert_rel(pp.fun(torch.from_numpy(ind)).numpy(), jp.fun(jnp.asarray(ind)), RTOL_INTEGRAND)


# ------------------------------------------------------------ the engine on MVN's zeros
def test_init_on_underflowing_pdf_matches_jax():
    """The MVN pdf falls to ~1e-37 of its peak along the first fibers and
    further at the box's corners, where the d = 6 shifted diagonals start:
    the initial search and the rank-1 cross agree with the JAX engine's
    field by field."""
    jp = jmake_mvn(d=6, n=65)
    pp = _port_mvn(jp)
    d, N, R = 6, 65, 4
    se, sp = precision_thresholds(jnp.float64)
    kw = dict(d=d, n=(N,) * d, N=N, R=R, piv=1, small_element=se, small_pivot=sp)
    jst = jmake_engine(jp.fun, JCrossConfig(**kw)).init_fn(jax.random.PRNGKey(0))
    pst = make_engine(pp.fun, CrossConfig(**kw), "cpu").init_fn()
    js = {k: np.asarray(v) for k, v in jst._asdict().items()}
    assert float(np.min(np.abs(js["cores"][0, 0, :, 0]))) < 1e-30 * js["amax"]   # deep in the tail
    for f in pst._fields:
        if f in js:
            np.testing.assert_allclose(getattr(pst, f).numpy(), js[f], rtol=1e-13,
                                       atol=1e-15 * js["amax"], err_msg=f)


# ------------------------------------------------------------ the slice as a whole
def _run_both(jp, pp, R, key=0, **extra):
    """cross() in both packages with the port fed the JAX uniforms."""
    d, N = jp.d, jp.n
    over = extra.get("oversample", 0)
    kw = dict(max_rank=R, pivoting=1, quad=[jp.quad_weights] * d, truth=jp.truth, **extra)
    keep = not over
    jres = jcross(jp.fun, [N] * d, key=key, return_state=keep, **kw)
    kw.setdefault("oversample", 0)
    U = _jax_uniforms(key, R + over - 1, d, 2 * (R + over + N))
    pres = _cross(pp.fun, [N] * d, accuracy=None, key=key, dtype=torch.float64, verbose=False,
                  return_state=keep, max_sweeps=None, small_element=None, small_pivot=None,
                  sweep_mode="sequential", device="cpu", uniforms=U, **kw)
    return jres, pres


def _assert_same_run(jres, pres, rtol=1e-12):
    assert pres.ranks == jres.ranks
    assert pres.sweeps == jres.sweeps
    assert pres.neval == jres.neval
    assert pres.padded_evals == jres.padded_evals
    assert len(pres.values) == len(jres.values)
    np.testing.assert_allclose(pres.values, jres.values, rtol=rtol)
    assert [h.direction for h in pres.history] == [h.direction for h in jres.history]
    if pres.state is not None:
        assert np.array_equal(pres.state.vip.numpy(), np.asarray(jres.state.vip))
        assert np.array_equal(pres.state.rk.numpy(), np.asarray(jres.state.rk))
    core_err = max(float(np.max(np.abs(p.numpy() - np.asarray(j))))
                   for p, j in zip(pres.tt.cores, jres.tt.cores))
    return core_err


@pytest.mark.parametrize("extra", [dict(), dict(refine_sweeps=1), dict(oversample=2),
                                   dict(weighted_lottery=True),
                                   dict(oversample=2, refine_sweeps=1)],
                         ids=["greedy", "refine", "oversample", "weighted", "oversample+refine"])
def test_mvn_cross_matches_jax(extra):
    """MVN d = 4, n = 17, rank 6 (perturbed density, see the module's note):
    ranks, pivots, n_evals, padded evals equal; values to 1e-12 (the
    rounded ones to 1e-11: an SVD in between)."""
    jp, pp = _asymmetric_mvn()
    jres, pres = _run_both(jp, pp, 6, **extra)
    _assert_same_run(jres, pres, rtol=1e-11 if extra.get("oversample") else 1e-12)
    if extra.get("refine_sweeps"):
        assert pres.history[-1 - bool(extra.get("oversample"))].direction == "mv"


def test_default_mvn_cross_matches_jax_at_key_0():
    """The symmetric default problem at a key where no tie decides a pivot."""
    jp = jmake_mvn(d=4, n=17)
    jres, pres = _run_both(jp, _port_mvn(jp), 6, key=0)
    _assert_same_run(jres, pres)


@pytest.mark.parametrize("extra", [dict(), dict(weighted_lottery=True)], ids=["uniform", "weighted"])
def test_stdnorm_cross_matches_jax(extra):
    """stdnorm d = 5, n = 16 (-> 17), rank 4: the integrand is rank 1, so no
    pivot is accepted after the init and the value stays the init's."""
    jp = jmake_stdnorm(d=5, n=16)
    pp = stdnorm_from_numpy(jp.nodes, jp.quad_weights, jp.d, jp.truth, "cpu")
    jres, pres = _run_both(jp, pp, 4, **extra)
    _assert_same_run(jres, pres)
    assert max(pres.ranks) == 1


@pytest.mark.parametrize("wlot", [False, True], ids=["uniform", "weighted"])
def test_mvn_per_sweep_parity(wlot):
    """From each JAX pre-sweep state (4 keys x 5 sweeps), one port sweep with
    the same uniforms picks the same pivots, also when the lottery is
    weighted: the port's f64 CDF of the scaled weights and the JAX engine's
    f32 CDF of the raw ones draw the same candidates here (they could part
    only where a target lands within an f32 rounding of a CDF step)."""
    jp, pp = _asymmetric_mvn()
    d, N, R = jp.d, jp.n, 6
    se, sp = precision_thresholds(jnp.float64)
    kw = dict(d=d, n=(N,) * d, N=N, R=R, piv=1, small_element=se, small_pivot=sp, wlot=wlot)
    jkit = jmake_engine(jp.fun, JCrossConfig(**kw))
    pkit = make_engine(pp.fun, CrossConfig(**kw), "cpu")
    w = np.tile(jp.quad_weights, (d, 1))
    lwj = jnp.asarray(w) if wlot else None
    lw = torch.from_numpy(np.abs(w) / np.abs(w).max(axis=1, keepdims=True)) if wlot else None
    for seed in range(4):
        jst = jkit.init_fn(jax.random.PRNGKey(seed))
        for it in range(1, R):
            _, sub = jax.random.split(jst.key)
            U = np.asarray(jax.random.uniform(sub, (d - 1, 2, 2 * (R + N)), jnp.float64))
            arrays = {k: np.asarray(v) for k, v in jst._asdict().items()}
            pst = pkit.sweep_fn(state_from_numpy(arrays, "cpu"), it, torch.from_numpy(U.copy()),
                                lw=lw)
            jst = jkit.sweep_fn(jst, it, lwj)
            for f in ("rk", "vip", "neval", "padded"):
                assert np.array_equal(getattr(pst, f).numpy(), np.asarray(getattr(jst, f))), \
                    (seed, it, f)
            np.testing.assert_allclose(pst.cores.numpy(), np.asarray(jst.cores), rtol=0,
                                       atol=1e-12 * float(jst.amax))


@pytest.mark.parametrize("mode", ["jacobi", "jacobi-rb"])
def test_weighted_lottery_on_the_all_bonds_hunt_matches_jax(mode):
    jp, pp = _asymmetric_mvn()
    d, N, R = jp.d, jp.n, 5
    kw = dict(max_rank=R, pivoting=1, quad=[jp.quad_weights] * d, truth=1.0,
              weighted_lottery=True, sweep_mode=mode)
    jres = jcross(jp.fun, [N] * d, key=1, return_state=True, **kw)
    pres = _cross(pp.fun, [N] * d, accuracy=None, key=1, dtype=torch.float64, verbose=False,
                  return_state=True, max_sweeps=None, small_element=None, small_pivot=None,
                  oversample=0, device="cpu", uniforms=_jax_uniforms(1, R - 1, d, 2 * (R + N)),
                  **kw)
    assert pres.ranks == jres.ranks and pres.neval == jres.neval
    assert np.array_equal(pres.state.vip.numpy(), np.asarray(jres.state.vip))
    np.testing.assert_allclose(pres.values, jres.values, rtol=1e-11)


@pytest.mark.parametrize("mode,split", [("sequential", 2), ("sequential", 3), ("jacobi-rb", 2)])
def test_init_state_resume_is_the_uninterrupted_run(mode, split, tmp_path):
    """Within the port: `split` sweeps, a checkpoint through save_state /
    load_state, then the rest from init_state, against one run of all the
    sweeps with the same key: every field of the final state bit for bit
    (an odd split resumes on a '<<' sweep)."""
    from ttcross_tpu_torch.tt.serialize import save_state

    pp = make_mvn(d=4, n=17, device="cpu")
    kw = dict(max_rank=6, pivoting=1, quad=[pp.quad_weights] * pp.d, truth=1.0, key=7,
              sweep_mode=mode, return_state=True, device="cpu")
    whole = cross(pp.fun, [pp.n] * pp.d, max_sweeps=5, **kw)
    first = cross(pp.fun, [pp.n] * pp.d, max_sweeps=split, **kw)
    kept = [t.clone() for t in first.state]
    save_state(first.state, str(tmp_path / "st.npz"))
    rest = cross(pp.fun, [pp.n] * pp.d, max_sweeps=5 - split,
                 init_state=load_state(str(tmp_path / "st.npz"), device="cpu"), **kw)
    for f, a, b in zip(whole.state._fields, whole.state, rest.state):
        assert torch.equal(a, b), f
    assert int(rest.state.sweeps) == 5 and rest.neval == whole.neval
    assert rest.values[1:] == whole.values[split + 1:]
    assert [h.direction for h in rest.history] == [h.direction for h in whole.history[split:]]
    assert all(torch.equal(a, b) for a, b in zip(kept, first.state))     # copied, not changed
    with pytest.raises(ValueError, match="pad_state"):
        cross(pp.fun, [pp.n] * pp.d, init_state=first.state, **{**kw, "max_rank": 8})


def test_kwargs_still_not_ported_name_their_item():
    pp = make_stdnorm(d=3, n=9, device="cpu")
    for kw in (dict(host_reeval=True), dict(return_pivots=True), dict(rank_chunks="auto"),
               dict(rank_caps=[2, 2]), dict(adaptive=True), dict(dtype=torch.float32)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7b"):
            cross(pp.fun, [pp.n] * pp.d, max_rank=4, device="cpu", **kw)
    with pytest.raises(ValueError, match="quad"):
        cross(pp.fun, [pp.n] * pp.d, max_rank=4, weighted_lottery=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        accchk(TT((torch.ones(1, 9, 1),) * 3), pp.fun, mesh=object(), device="cpu")


# ------------------------------------------------------------ post-processing
@pytest.fixture(scope="module")
def jax_train():
    """A rank-8 cross of the d = 4 MVN pdf by the JAX package, as numpy."""
    jp = jmake_mvn(d=4, n=33)
    res = jcross(jp.fun, [jp.n] * jp.d, max_rank=8, pivoting=1, key=0)
    return jp, res.tt, [np.asarray(c) for c in res.tt.cores]


def test_chf_pdf_cos_match_jax(jax_train, rng):
    jp, jtt, cores = jax_train
    ptt = tt_from_numpy(cores, "cpu")
    K = 32
    phis = basket_chf(ptt, jp.nodes, jp.quad_weights, K)
    jphis = jbasket_chf(jtt, jp.nodes, jp.quad_weights, K)
    assert phis.dtype == torch.complex128 and phis.shape == (K,)
    np.testing.assert_allclose(phis.numpy(), jphis, rtol=0, atol=RTOL_POST)      # |phi| <= 1
    pr, pi = basket_chf_pair(ptt, jp.nodes, jp.quad_weights, K)
    jr, ji = jbasket_chf_pair(jtt, jp.nodes, jp.quad_weights, K)
    np.testing.assert_allclose(pr.numpy(), jr, rtol=0, atol=RTOL_POST)
    np.testing.assert_allclose(pi.numpy(), ji, rtol=0, atol=RTOL_POST)
    np.testing.assert_allclose(phis.numpy(), pr.numpy() + 1j * pi.numpy(), rtol=0, atol=1e-14)
    xs = np.linspace(20.0, 280.0, 100)
    want = np.asarray(jbasket_pdf(jtt, jp.nodes, jp.quad_weights, xs, K))
    scale = np.max(np.abs(want))
    for got in (basket_pdf(ptt, jp.nodes, jp.quad_weights, xs, K),
                basket_pdf_pair(ptt, jp.nodes, jp.quad_weights, xs, K)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL_POST * scale)
    some = rng.normal(size=K) + 1j * rng.normal(size=K)
    for nt in (None, 20):
        got = cos_approximate(xs, some, 0.0, 300.0, nt, device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(jcos_approximate(xs, some, 0.0, 300.0, nt)),
                                   rtol=0, atol=RTOL_POST * np.max(np.abs(some)))
    with pytest.raises(ValueError, match="n_terms"):
        cos_approximate(xs, some, 0.0, 300.0, K + 1, device="cpu")


def test_pair_chain_is_differentiable(jax_train):
    """Autograd through basket_pdf_pair with respect to the cores agrees
    with jax.grad of the JAX pair chain (the Greeks' route)."""
    jp, jtt, cores = jax_train
    xs = np.array([80.0, 100.0, 130.0])
    leaf = [torch.from_numpy(c.copy()).requires_grad_(True) for c in cores]
    basket_pdf_pair(TT(tuple(leaf)), jp.nodes, jp.quad_weights, xs).sum().backward()
    from ttcross_tpu.apps.chf import basket_pdf_pair as jpair
    from ttcross_tpu.tt import TT as JTT

    grads = jax.grad(lambda cs: jnp.sum(jpair(JTT(tuple(cs)), jp.nodes, jp.quad_weights, xs)))(
        [jnp.asarray(c) for c in cores])
    for g, jg in zip(leaf, grads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.grad.numpy(), jg, rtol=0, atol=1e-11 * np.max(np.abs(jg)))


def test_accchk_on_the_jax_indices(jax_train):
    jp, jtt, cores = jax_train
    nlot = 4096
    keys = jax.random.split(jax.random.PRNGKey(3), jtt.d)       # accchk's own draw
    ind = np.stack([np.asarray(jax.random.randint(keys[c], (nlot,), 0, jtt.n[c]))
                    for c in range(jtt.d)], axis=1)
    want = jaccchk(jtt, jp.fun, nlot=nlot, key=3)
    pp = _port_mvn(jp)
    ptt = tt_from_numpy(cores, "cpu")
    got = accchk(ptt, pp.fun, nlot=nlot, ind=ind, device="cpu")
    assert got["worst_index"] == want["worst_index"]
    for k in ("einf", "efro", "ainf", "afro"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=RTOL_POST * want["afro"])
    own = accchk(ptt, pp.fun, nlot=nlot, key=3, device="cpu")      # the port's own draw
    assert 0.1 < own["efro"] / want["efro"] < 10 and len(own["worst_index"]) == jtt.d
    assert own == accchk(ptt, pp.fun, nlot=nlot, key=3, device="cpu")
    np.testing.assert_allclose(gather(ptt, torch.from_numpy(ind)).numpy(),
                               np.asarray(jgather(jtt, jnp.asarray(ind))), rtol=0,
                               atol=RTOL_POST * want["ainf"])


def test_complex_contraction_of_the_mvn_train(jax_train):
    """mvn_complex: complex128 weights on the device; the real part is the
    real contraction, the imaginary part vanishes."""
    jp, jtt, cores = jax_train
    ptt = tt_from_numpy(cores, "cpu")
    real = contract(ptt, [jp.quad_weights] * jp.d)
    cplx = contract(ptt, [jp.quad_weights.astype(np.complex128)] * jp.d)
    assert cplx.dtype == torch.complex128 and cplx.dim() == 0
    assert abs(cplx.real.item() - real.item()) <= 1e-13 * abs(real.item())
    assert abs(cplx.imag.item()) <= 1e-13


# ------------------------------------------------------------ digits over keys (a script)
def _configs():
    """The path's configurations at the sizes of the reference's test programs
    (bench.py:461-524): name -> (problem maker, cross kwargs)."""
    acc = 500 * 2.2e-16

    def mvn(which, **extra):
        def build():
            p = (make_mvn(d=6, n=65, device="cpu") if which == "port" else jmake_mvn(d=6, n=65))
            return p.fun, [p.n] * p.d, dict(max_rank=20, accuracy=acc, pivoting=1,
                                            quad=[p.quad_weights] * p.d, truth=p.truth, **extra)
        return build

    def stdnorm(which):
        def build():
            p = (make_stdnorm(d=10, n=32, device="cpu") if which == "port"
                 else jmake_stdnorm(d=10, n=32))
            return p.fun, [p.n] * p.d, dict(max_rank=8, accuracy=5 * 2.2e-16, pivoting=1,
                                            quad=[p.quad_weights] * p.d, truth=p.truth)
        return build

    def coscoeff(which):
        def build():
            dens = jmake_density(6, corr=0.5)
            cc = (make_cos_coefficients(6, dens.mu, dens.cov, 0.52517, 8.52517, device="cpu")
                  if which == "port" else jmake_cos(6, dens.mu, dens.cov, 0.52517, 8.52517))
            return cc.fun, [65] * 6, dict(max_rank=20, accuracy=acc, pivoting=1)
        return build

    return {"mvn_d6": lambda w: mvn(w), "mvn_d6_oversample6": lambda w: mvn(w, oversample=6),
            "mvn_d6_refined": lambda w: mvn(w, refine_sweeps=2),
            "mvn_d6_weighted": lambda w: mvn(w, weighted_lottery=True),
            "stdnorm_d10": stdnorm, "coscoeff_d6": coscoeff}


def digits_over_keys(name, keys=range(8), packages=("port", "jax")):
    """Not a test: the digits (for coscoeff_d6: -log10 of accchk's relative
    inf error over 2^14 samples) and n_evals of one configuration of the
    MVN / COS path over lottery keys on the CPU, for either package;
    chip_smoke.py's digit floors stand on these.

        PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_apps_mvn.py [name ...]
    """
    import json
    import statistics

    rows = {}
    for which in packages:
        fun, n, kw = _configs()[name](which)()
        run, chk, extra = ((cross, accchk, dict(device="cpu")) if which == "port"
                           else (jcross, jaccchk, {}))
        rows[which] = []
        for key in keys:
            r = run(fun, n, key=key, **kw, **extra)
            if r.errors:
                digits = float(-np.log10(r.errors[-1]))
            else:
                c = chk(r.tt, fun, nlot=2**14, **extra)
                digits = float(-np.log10(c["einf"] / max(c["ainf"], 1e-300)))
            rows[which].append({"key": key, "digits": digits, "n_evals": int(r.neval),
                                "padded_evals": int(r.padded_evals), "sweeps": int(r.sweeps)})
        dg = [x["digits"] for x in rows[which]]
        rows[which + "_min_median_max"] = [min(dg), statistics.median(dg), max(dg)]
    print(json.dumps({"config": name + ", CPU", **rows}), flush=True)
    return rows


if __name__ == "__main__":
    import sys

    for config in sys.argv[1:] or list(_configs()):
        digits_over_keys(config)
