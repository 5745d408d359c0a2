"""The port's frozen-skeleton module, host re-evaluation and pivot shim
against the JAX package (ttcross_tpu/cross/skeleton.py, cross(host_reeval=,
return_pivots=)).

The same skeleton goes through both packages: the port runs its cross fed
the JAX engine's lottery uniforms (recomputed from its key chain,
ttcross_tpu/cross/engine.py:798-799), so both pick the same pivots.  Then
the skeleton's value, its gradient in the parameter and a vmapped
parameter sweep are compared: values to 1e-12, gradients to 1e-10 relative
(the solves are LU here and QR there), a central difference of the port's
own value to 1e-5 (tests/test_skeleton.py:166), vmap against the pointwise
values to 1e-12 (batched LU solves against single ones).
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from ttcross_tpu.apps import make_ising as jmake_ising
from ttcross_tpu.apps.ising import ising_integrand_np as jising_integrand_np
from ttcross_tpu.apps.mvn import MVN_BOX
from ttcross_tpu.cross import cross as jcross
from ttcross_tpu.cross.skeleton import (derive_host_fun as jderive_host_fun,
                                        extract_skeleton as jextract_skeleton,
                                        reevaluate_host as jreevaluate_host,
                                        skeleton_tt_fn as jskeleton_tt_fn,
                                        skeleton_value_fn as jskeleton_value_fn)
from ttcross_tpu.ops.quadrature import lgwt as jlgwt, map_to_interval as jmap_to_interval
from ttcross_tpu.tt.ortho import svd_round_host as jsvd_round_host
from ttcross_tpu_torch.apps.ising import ising_integrand_np
from ttcross_tpu_torch.cross import (cross, derive_host_fun, extract_skeleton, reevaluate_host,
                                     skeleton_tt_fn, skeleton_value_fn)
from ttcross_tpu_torch.cross.engine import _cross
from ttcross_tpu_torch.drivers.crs_greeks import mvn_rho_fun
from ttcross_tpu_torch.interop import ising_from_numpy
from ttcross_tpu_torch.tt import contract
from ttcross_tpu_torch.tt.ortho import svd_round_host

D, N, R = 4, 17, 8          # MVN rho family: d = 4 on a 17-point rule, rank 8
RHO0 = 0.5


def _jax_uniforms(key, sweeps, d, nlot):
    k = jax.random.PRNGKey(key)
    out = []
    for _ in range(sweeps):
        k, sub = jax.random.split(k)
        out.append(np.asarray(jax.random.uniform(sub, (d - 1, 2, nlot), jnp.float64)))
    return np.stack(out)


def _port_cross(fun, n, R, key, **kw):
    """The port's cross on the CPU with the JAX uniforms of `key`."""
    d = len(n)
    over = kw.get("oversample", 0)
    base = dict(accuracy=None, key=key, dtype=torch.float64, verbose=False, return_state=False,
                max_sweeps=None, small_element=None, small_pivot=None, oversample=0,
                sweep_mode="sequential", device="cpu")
    base.update(kw)
    U = _jax_uniforms(key, R + over - 1, d, 2 * (R + over + max(n)))
    return _cross(fun, n, max_rank=R, uniforms=U, **base)


def _rho_grid():
    x, w = jmap_to_interval(*jlgwt(N), *MVN_BOX)
    return x, w


def _jax_rho_fun(nodes, d, sigma=0.4, T=1.0):
    s2 = sigma * sigma * T
    mu = jnp.full((d,), np.log(100.0) - 0.5 * sigma * sigma * T)

    def fun(ind, rho):
        diff = jnp.take(jnp.asarray(nodes), ind, axis=0) - mu
        denom = 1.0 + (d - 1.0) * rho
        q = (jnp.sum(diff * diff, axis=1) - rho / denom * jnp.sum(diff, axis=1) ** 2) / (s2 * (1.0 - rho))
        det = (s2 ** d) * ((1.0 - rho) ** (d - 1)) * denom
        return jnp.exp(-0.5 * q) / jnp.sqrt((2.0 * jnp.pi) ** d * det)

    return fun


@pytest.fixture(scope="module")
def rho_runs():
    """One cross of the rho family at RHO0 in each package, the same pivots."""
    x, w = _rho_grid()
    jfun, pfun = _jax_rho_fun(x, D), mvn_rho_fun(torch.from_numpy(x), D)
    kw = dict(pivoting=1, quad=[w] * D, truth=1.0)
    jres = jcross(lambda i: jfun(i, RHO0), [N] * D, max_rank=R, key=5, return_state=True, **kw)
    pres = _port_cross(lambda i: pfun(i, torch.tensor(RHO0, dtype=torch.float64)), (N,) * D, R,
                       5, return_state=True, **kw)
    return x, w, jfun, pfun, jres, pres


def test_extract_skeleton_matches_jax(rho_runs):
    x, w, jfun, pfun, jres, pres = rho_runs
    assert np.array_equal(pres.state.vip.numpy(), np.asarray(jres.state.vip))
    js, ps = jextract_skeleton(jres, [N] * D), extract_skeleton(pres, [N] * D, device="cpu")
    assert np.array_equal(ps.ind_all, js.ind_all)
    assert (ps.core_shapes, ps.ahat_shapes, ps.ranks, ps.n) == (js.core_shapes, js.ahat_shapes,
                                                               js.ranks, js.n)
    assert ps.n_samples == js.n_samples and ps.ind.dtype == torch.int32
    # the light shim and a JAX state decode the same way
    shim = SimpleNamespace(vip=np.asarray(jres.state.vip), rk=np.asarray(jres.state.rk))
    assert np.array_equal(extract_skeleton(shim, [N] * D, device="cpu").ind_all, js.ind_all)
    with pytest.raises(ValueError, match="return_state"):
        extract_skeleton(cross(lambda i: pfun(i, torch.tensor(RHO0, dtype=torch.float64)),
                               [N] * D, max_rank=3, max_sweeps=1, device="cpu"), [N] * D,
                         device="cpu")


def test_skeleton_value_grad_and_sweep_match_jax(rho_runs):
    """The frozen-skeleton value, its gradient in rho and a vmapped rho sweep
    against jax.grad / jax.vmap of the JAX skeleton value."""
    x, w, jfun, pfun, jres, pres = rho_runs
    jv = jskeleton_value_fn(jfun, jextract_skeleton(jres, [N] * D), weights=[jnp.asarray(w)] * D)
    pv = skeleton_value_fn(pfun, extract_skeleton(pres, [N] * D, device="cpu"), weights=[w] * D)
    rho = torch.tensor(RHO0, dtype=torch.float64)
    v = float(pv(rho))
    assert abs(v / float(jv(jnp.float64(RHO0))) - 1) < 1e-12
    assert abs(v / pres.values[-1] - 1) < 1e-10
    g = float(torch.func.grad(pv)(rho))
    jg = float(jax.grad(jv)(jnp.float64(RHO0)))
    assert abs(g / jg - 1) < 1e-10, (g, jg)
    # autograd gives the same
    r = rho.clone().requires_grad_()
    pv(r).backward()
    assert abs(float(r.grad) / g - 1) < 1e-11
    h = 1e-5
    fd = (float(pv(rho + h)) - float(pv(rho - h))) / (2 * h)
    assert abs(g - fd) < 1e-5 * max(1.0, abs(g))
    rhos = torch.linspace(0.3, 0.7, 5, dtype=torch.float64)
    swept = torch.func.vmap(pv)(rhos)
    pointwise = torch.stack([pv(t) for t in rhos])
    np.testing.assert_allclose(swept.numpy(), pointwise.numpy(), rtol=1e-12)
    # against the JAX package near rho0: further out the rank-7 skeleton
    # taken at 0.5 is far from its data (1.31 for a mass of 1 at 0.7) and
    # the solves' rounding, LU here and QR there, grows with the pivot
    # submatrices' conditioning (1.5e-10 apart at 0.7)
    near = torch.linspace(0.4, 0.6, 5, dtype=torch.float64)
    jnear = jnp.asarray(near.numpy())
    np.testing.assert_allclose(torch.func.vmap(pv)(near).numpy(), np.asarray(jax.vmap(jv)(jnear)),
                               rtol=1e-12)
    np.testing.assert_allclose(torch.func.vmap(torch.func.grad(pv))(near).numpy(),
                               np.asarray(jax.vmap(jax.grad(jv))(jnear)), rtol=1e-10)


def test_skeleton_tt_fn_matches_jax(rho_runs):
    x, w, jfun, pfun, jres, pres = rho_runs
    js, ps = jextract_skeleton(jres, [N] * D), extract_skeleton(pres, [N] * D, device="cpu")
    rho = 0.6
    jt = jskeleton_tt_fn(jfun, js)(jnp.float64(rho))
    pt = skeleton_tt_fn(pfun, ps)(torch.tensor(rho, dtype=torch.float64))
    assert pt.ready() and pt.r == ps.ranks == tuple(jt.r)
    scale = max(float(np.max(np.abs(np.asarray(c)))) for c in jt.cores)
    for a, b in zip(pt.cores, jt.cores):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10 * scale)
    value = float(contract(pt, [w] * D))
    assert abs(value / float(skeleton_value_fn(pfun, ps, [w] * D)(
        torch.tensor(rho, dtype=torch.float64))) - 1) < 1e-11


@pytest.fixture(scope="module")
def ising():
    jp = jmake_ising("C", 5, 17)
    return jp, ising_from_numpy(jp.nodes, jp.weights, jp.quad_weights, "C", 5, jp.truth, "cpu")


def test_host_twins_match_jax(ising, rng=np.random.default_rng(3)):
    """ising_integrand_np (C, D, E) and svd_round_host: the JAX package's
    numpy, the same operations, so the same bits; the twin within 1e-13 of
    the port's integrand."""
    jp, tp = ising
    ind = rng.integers(0, jp.n, size=(200, jp.d))
    for kind in "CDE":
        assert np.array_equal(ising_integrand_np(ind, jp.nodes, jp.weights, kind),
                              jising_integrand_np(ind, jp.nodes, jp.weights, kind))
    np.testing.assert_allclose(tp.fun_np(ind), tp.fun(torch.from_numpy(ind).int()).numpy(),
                               rtol=1e-13)
    cores = [rng.normal(size=s) for s in [(1, 5, 4), (4, 6, 5), (5, 5, 3), (3, 4, 1)]]
    for tol, rmax in [(0.0, 2), (1e-3, None)]:
        for a, b in zip(svd_round_host(cores, tol, rmax), jsvd_round_host(cores, tol, rmax)):
            assert np.array_equal(a, b)


def test_reevaluate_host_and_derive_host_fun_match_jax(ising):
    jp, tp = ising
    kw = dict(pivoting=1, quad=[jp.quad_weights] * jp.d, truth=jp.truth)
    jres = jcross(jp.fun, [jp.n] * jp.d, max_rank=6, key=2, return_state=True, **kw)
    pres = _port_cross(tp.fun, (tp.n,) * tp.d, 6, 2, return_state=True, **kw)
    js, ps = jextract_skeleton(jres, [jp.n] * jp.d), extract_skeleton(pres, [tp.n] * tp.d,
                                                                    device="cpu")
    assert np.array_equal(ps.ind_all, js.ind_all)
    for a, b in zip(reevaluate_host(tp.fun_np, ps), jreevaluate_host(jp.fun_np, js)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14 * np.abs(b).max())
    fun_np = derive_host_fun(tp.fun, device="cpu")
    got = fun_np(ps.ind_all)
    assert got.dtype == np.float64 and isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, jderive_host_fun(jp.fun)(js.ind_all), rtol=1e-13)


@pytest.mark.parametrize("over", [0, 2], ids=["plain", "oversample"])
def test_cross_host_reeval_matches_jax(over, ising):
    """cross(host_reeval=fun_np) and (host_reeval=True) in both packages,
    the port fed the JAX uniforms: the same n_evals (the run's plus the
    skeleton's samples), ranks after the host rounding, values to 1e-12, an
    'hr' record last, no state."""
    jp, tp = ising
    kw = dict(pivoting=1, quad=[jp.quad_weights] * jp.d, truth=jp.truth, oversample=over)
    device_only = _port_cross(tp.fun, (tp.n,) * tp.d, 6, 4, **kw)
    for how in ("callable", True):
        jres = jcross(jp.fun, [jp.n] * jp.d, max_rank=6, key=4,
                      host_reeval=jp.fun_np if how == "callable" else True, **kw)
        pres = _port_cross(tp.fun, (tp.n,) * tp.d, 6, 4,
                           host_reeval=tp.fun_np if how == "callable" else True, **kw)
        assert pres.neval == jres.neval and pres.padded_evals == jres.padded_evals
        assert pres.ranks == jres.ranks and pres.sweeps == jres.sweeps
        np.testing.assert_allclose(pres.values, jres.values, rtol=1e-12)
        assert [h.direction for h in pres.history] == [h.direction for h in jres.history]
        assert pres.history[-1].direction == "hr" and pres.state is None
        skel = extract_skeleton(_port_cross(tp.fun, (tp.n,) * tp.d, 6 + over, 4,
                                            return_pivots=True, **{**kw, "oversample": 0}),
                                [tp.n] * tp.d, device="cpu")
        assert pres.neval - device_only.neval == skel.n_samples
    if over:
        assert max(pres.ranks) <= 6


def test_return_pivots_and_argument_checks_match_jax(ising):
    jp, tp = ising
    kw = dict(pivoting=1, quad=[jp.quad_weights] * jp.d, truth=jp.truth)
    jres = jcross(jp.fun, [jp.n] * jp.d, max_rank=6, key=1, return_pivots=True, **kw)
    pres = _port_cross(tp.fun, (tp.n,) * tp.d, 6, 1, return_pivots=True, **kw)
    assert isinstance(pres.state.vip, np.ndarray)
    assert np.array_equal(pres.state.vip, np.asarray(jres.state.vip))
    assert np.array_equal(pres.state.rk, np.asarray(jres.state.rk))
    bad = [(dict(oversample=2, return_pivots=True), "return_pivots"),
           (dict(refine_sweeps=1, return_pivots=True), "return_pivots"),
           (dict(host_reeval=jp.fun_np, refine_sweeps=1), "host_reeval"),
           (dict(host_reeval=jp.fun_np, rank_chunks=[4, 6]), "host_reeval")]
    for extra, match in bad:
        with pytest.raises(ValueError, match=match):
            jcross(jp.fun, [jp.n] * jp.d, max_rank=6, **kw, **extra)
        extra = {k: (tp.fun_np if k == "host_reeval" else v) for k, v in extra.items()}
        with pytest.raises(ValueError, match=match):
            cross(tp.fun, [tp.n] * tp.d, max_rank=6, device="cpu", **kw, **extra)
    # host_reeval=False is None: no 'hr' record
    off = cross(tp.fun, [tp.n] * tp.d, max_rank=6, host_reeval=False, device="cpu", **kw)
    assert all(h.direction != "hr" for h in off.history) and off.state is None


def test_hand_kernels_refuse_transformed_tensors():
    """A hand kernel's wrapper refuses a tensor that torch.func.vmap batches,
    or that carries a gradient, with a TypeError naming the lane-batched
    form, and launches on a constant that torch.func.grad wraps (the
    skeleton's indices and node tables); on the CPU the wrappers run their
    plain versions, which vmap."""
    from ttcross_tpu_torch.ops import kernels as K

    with pytest.raises(TypeError, match="lane_batched"):
        torch.func.vmap(lambda t: K._launchable(t)[0])(torch.zeros((2, 3), dtype=torch.int32))
    const = torch.arange(3.0, dtype=torch.float64)

    def through(x):
        (c,) = K._launchable(const[None])
        assert not torch._C._functorch.is_functorch_wrapped_tensor(c) and torch.equal(c[0], const)
        with pytest.raises(TypeError, match="gradient"):
            K._launchable(x * const)
        return (x * const).sum()

    assert float(torch.func.grad(through)(torch.tensor(2.0, dtype=torch.float64))) == 3.0
    tables = torch.rand((1, 5), dtype=torch.float64)
    ind = torch.randint(0, 5, (3, 4, 2), dtype=torch.int32)
    out = torch.func.vmap(lambda i: K.small_table_lookup(tables, i))(ind)
    assert torch.equal(out, torch.stack([K.small_table_lookup(tables, i) for i in ind]))
