"""The port's quantics problems (apps/quantics.py) against the JAX package's.

A function on a virtual 2^K grid is crossed as a K-dimensional binary
tensor.  The port is fed the JAX engine's lottery uniforms (its key chain:
one split per sweep), so the two packages make the same pivot choices
(ranks, n_evals, vip exactly, values to rtol 1e-12), and the trains agree
at real coordinates within 1e-10.  Quantics end bonds are rank-saturated
(2 rows at bond 0): the JAX package's rook / lottery hunt keeps accepting
there, a reference defect the port keeps for parity."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from ttcross_tpu.apps import make_quantics as jmake_quantics
from ttcross_tpu.apps import quantics_cross as jquantics_cross
from ttcross_tpu.cross import cross as jcross
from ttcross_tpu_torch.apps import make_quantics, quantics_cross
from ttcross_tpu_torch.cross.engine import _cross

XS = np.arange(64) / 64.0
POINT_ATOL = 1e-10


def jax_uniforms(key, sweeps, d, nlot):
    k = jax.random.PRNGKey(key)
    out = []
    for _ in range(sweeps):
        k, sub = jax.random.split(k)
        out.append(np.asarray(jax.random.uniform(sub, (d - 1, 2, nlot), jnp.float64)))
    return np.stack(out)


def port_quantics_cross(f, K, max_rank, dd=1, domain=(0.0, 1.0), key=0, **kw):
    """apps.quantics_cross of the port with the JAX run's uniforms."""
    prob = make_quantics(f, K, dd=dd, domain=domain, device="cpu")
    U = jax_uniforms(key, max_rank - 1, prob.d, 2 * (max_rank + prob.n))
    args = dict(accuracy=None, dtype=torch.float64, verbose=False, max_sweeps=None,
                small_element=None, oversample=0, sweep_mode="sequential", return_state=False)
    args.update(kw)
    res = _cross(prob.fun, [prob.n] * prob.d, max_rank=max_rank, key=key,
                 quad=prob.quad_weights, truth=None, small_pivot=1e-14, device="cpu",
                 uniforms=U, **args)
    return prob, res


def assert_same(jres, pres, vip=True):
    assert pres.ranks == tuple(int(x) for x in jres.ranks)
    assert (pres.sweeps, pres.neval, pres.padded_evals) == (jres.sweeps, jres.neval,
                                                             jres.padded_evals)
    if vip:
        assert np.array_equal(pres.state.vip.numpy(), np.asarray(jres.state.vip))
    np.testing.assert_allclose(pres.values, np.asarray(jres.values, np.float64), rtol=1e-12)


def _grid_table(f_j, K):
    """f's values on the 2^K grid as the JAX package computes them, and a
    torch f that looks them up: the two engines then see the same bits."""
    tab = torch.from_numpy(np.array(f_j(jnp.arange(2 ** K) / 2.0 ** K)))
    return lambda x: tab[(x * 2 ** K).long()]


def test_quantics_1d_matches_jax_at_a_saturated_end_bond():
    """exp(x) sin(6 pi x) at K = 12, rank 8, rook.  The function has exact
    quantics rank 2, and bond 0's unfolding has 2 rows, yet both packages
    accept pivots past it: ranks (1, 5, 3, ...), vip chain indices up to 7
    (a reference defect kept for parity).  Pivot for pivot while the
    accepted pivots are above rounding; the first picks that differ are
    f64 noise in both packages (|pivot| < 1e-12 amax: which of the noise
    residuals is largest depends on the summation order), and the trains
    agree at x = i/64 within 1e-10."""
    f_j = lambda x: jnp.exp(x) * jnp.sin(6 * np.pi * x)  # noqa: E731
    f_same = _grid_table(f_j, 12)
    jprob, jres = jquantics_cross(f_j, 12, max_rank=8, pivoting=1, accuracy=1e-13,
                                  return_state=True, max_sweeps=3)
    prob, pres = port_quantics_cross(f_same, 12, 8, pivoting=1, accuracy=1e-13,
                                     return_state=True, max_sweeps=3)
    assert pres.ranks == tuple(int(x) for x in jres.ranks)
    assert [h.n_evals for h in pres.history] == [h.n_evals for h in jres.history]
    jv, pv = np.asarray(jres.state.vip), pres.state.vip.numpy()
    differ = (jv != pv).any(-1)
    amax = float(jres.state.amax)
    assert differ.any() and not differ[:, :2].any()     # sweeps 1-2 pivot for pivot
    assert np.abs(np.asarray(jres.state.lu_d))[differ].max() < 1e-12 * amax
    assert pres.state.lu_d.abs().numpy()[differ].max() < 1e-12 * amax

    jprob, jres = jquantics_cross(f_j, 12, max_rank=8, pivoting=1, accuracy=1e-13,
                                  return_state=True)
    prob, pres = port_quantics_cross(lambda x: torch.exp(x) * torch.sin(6 * np.pi * x), 12, 8,
                                     pivoting=1, accuracy=1e-13, return_state=True)
    assert jres.ranks[1] == 5 and pres.ranks[1] > 2          # the defect, in both
    assert int(pres.state.vip[0, :, 0].max()) > 0            # left-chain index at bond 0
    assert abs(pres.neval - jres.neval) <= 0.02 * jres.neval
    got = prob.value(pres.tt, XS[:, None]).numpy()
    want = np.asarray(jprob.value(jres.tt, XS[:, None]))
    np.testing.assert_allclose(got, want, rtol=0, atol=POINT_ATOL)
    np.testing.assert_allclose(got, np.exp(XS) * np.sin(6 * np.pi * XS), atol=1e-6)


def test_quantics_2d_domain_matches_jax():
    """dd = 2 on [-3, 3)^2: exp(-(x^2 + y^2)) at K = 6 bits per coordinate,
    grid_x as the JAX package maps it, the Riemann sum near the Gaussian
    mass pi, the train at real coordinates."""
    K = 6
    jprob = jmake_quantics(lambda x: jnp.exp(-(x[:, 0] ** 2 + x[:, 1] ** 2)), K, dd=2,
                           domain=(-3.0, 3.0))
    jres = jcross(jprob.fun, [2] * jprob.d, max_rank=8, pivoting=1, accuracy=1e-12,
                  small_pivot=1e-14, quad=jprob.quad_weights, return_state=True)
    prob, pres = port_quantics_cross(lambda x: torch.exp(-(x[:, 0] ** 2 + x[:, 1] ** 2)), K, 8,
                                     dd=2, domain=(-3.0, 3.0), pivoting=1, accuracy=1e-12,
                                     return_state=True)
    ind = np.random.default_rng(0).integers(0, 2, (50, 2 * K)).astype(np.int32)
    np.testing.assert_array_equal(prob.grid_x(torch.from_numpy(ind)).numpy(),
                                  np.asarray(jprob.grid_x(ind)))
    assert_same(jres, pres)
    assert abs(pres.values[-1] - np.pi) < 1e-2
    xy = np.stack([np.linspace(-3, 2.9, 16), np.linspace(2.9, -3, 16)], axis=1)
    np.testing.assert_allclose(prob.value(pres.tt, xy).numpy(),
                               np.asarray(jprob.value(jres.tt, xy)), rtol=0, atol=POINT_ATOL)


def test_quantics_refine_matches_jax():
    """quantics_cross(refine_sweeps=1) at K = 12, rank 10, pivoting 2: the
    same ranks as the JAX package's on the same function values, n_evals
    within 2 % (the greedy picks part at noise-level pivots, as above), the
    refined train equal at x = i/64 within 1e-10 and within 1e-12 of f."""
    f_j = lambda x: jnp.exp(x) * jnp.sin(6 * np.pi * x)  # noqa: E731
    jprob, jres = jquantics_cross(f_j, 12, max_rank=10, pivoting=2, accuracy=1e-13,
                                  refine_sweeps=1)
    prob, pres = port_quantics_cross(_grid_table(f_j, 12), 12, 10, pivoting=2, accuracy=1e-13,
                                     refine_sweeps=1)
    assert pres.ranks == tuple(int(x) for x in jres.ranks)
    assert abs(pres.neval - jres.neval) <= 0.02 * jres.neval
    assert pres.history[-1].direction == "mv"
    got = prob.value(pres.tt, XS[:, None]).numpy()
    np.testing.assert_allclose(got, np.asarray(jprob.value(jres.tt, XS[:, None])), rtol=0,
                               atol=POINT_ATOL)
    assert np.abs(got - np.exp(XS) * np.sin(6 * np.pi * XS)).max() < 1e-12


def test_quantics_cross_exp_integral_on_the_port():
    """The port's own quantics_cross (its key's uniforms): exp(x) is rank 1
    in quantics, and the left Riemann sum over 2^K cells is exact."""
    K = 12
    prob, res = quantics_cross(torch.exp, K, max_rank=4, pivoting=1, accuracy=1e-13,
                               device="cpu")
    assert max(res.ranks) <= 2 and prob.d == K and prob.n == 2
    h = 2.0 ** -K
    tru = h * (np.e - 1.0) / (np.exp(h) - 1.0)
    assert abs(1.0 - res.values[-1] / tru) < 1e-10
    np.testing.assert_allclose(prob.value(res.tt, XS[:32, None]).numpy(), np.exp(XS[:32]),
                               rtol=1e-10)


@pytest.mark.parametrize("K,kw", [(1, {}), (8, dict(dd=0)), (8, dict(base=1)),
                                  (8, dict(domain=(1.0, 1.0)))])
def test_make_quantics_rejects_what_jax_rejects(K, kw):
    with pytest.raises(ValueError):
        jmake_quantics(jnp.exp, K, **kw)
    with pytest.raises(ValueError):
        make_quantics(torch.exp, K, device="cpu", **kw)
