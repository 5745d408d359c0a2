"""The port's extended-precision refinement (cross/refine.py::refine_dd)
against exact rationals and against the JAX package's refine_dd on the same
cross state carried across (interop.state_from_numpy).

The JAX package evaluates the refined quadrature in __float128 on the host
(~33 digits), the port in quad-double (~62 digits), both from the same dd
integrand values: on the exact-rank dyadic tensor both are within 1e-27 of
the exact rational value (the JAX test's bound) and within 1e-29 relative
of each other; on the product Gaussian (d = 4, n = 101, [-8.5, 8.5]) the
port reaches >= 28 digits against pi^2 and agrees with the JAX package's
refinement of the same state to 1e-28 (their dd integrands, __float128 exp
there and dd_exp here, differ by ~1e-32).  The JAX side is skipped only
where its native library is unavailable, as its own test is."""

from decimal import Decimal, localcontext
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ttcross_tpu  # noqa: F401  (x64)
import ttcross_tpu.tt as jtt
from ttcross_tpu import native
from ttcross_tpu.cross import cross as jcross
from ttcross_tpu_torch.cross import refine_dd
from ttcross_tpu_torch.interop import state_from_numpy
from torch_qd_helpers import one_torch_thread  # noqa: F401  (a fixture)

needs_native = pytest.mark.skipif(not native.available(), reason="no native toolchain")


def _np_state(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


@pytest.fixture(scope="module")
def dyadic():
    """An exact-rank (2, 2) train with dyadic-rational entries, its dense
    tensor, the JAX cross's state (rank 3, rook) and the exact quadrature
    with weights 1/8."""
    rng = np.random.default_rng(31)
    d, n = 3, 5
    cores = [np.round(rng.standard_normal((r1, n, r2)) * 16) / 16
             for (r1, r2) in [(1, 2), (2, 2), (2, 1)]]
    T = jtt.from_cores(cores)
    dense = np.asarray(jtt.full(T))
    res = jcross(lambda ind: jtt.gather(T, ind), [n] * d, max_rank=3, pivoting=1, accuracy=1e-12,
                 return_state=True)
    exact = sum((Fraction(float(dense[idx])) * Fraction(1, 8) ** d
                 for idx in np.ndindex(*dense.shape)), Fraction(0))
    return dense, _np_state(res.state), exact


class DenseDD:
    """fun_dd of a dense f64 tensor: its entries, lo parts zero."""

    def __init__(self, dense):
        self.dense = torch.from_numpy(np.array(dense))

    def __call__(self, ind):
        i = ind.long()
        v = self.dense[tuple(i[:, c] for c in range(i.shape[1]))]
        return v, torch.zeros_like(v)


def test_refine_exact_rank_rational(dyadic):
    """The refined quadrature of the exact-rank dyadic tensor is within
    1e-27 of exact rational arithmetic."""
    dense, state, exact = dyadic
    n = list(dense.shape)
    hi, lo, neval = refine_dd(state_from_numpy(state, "cpu"), n, DenseDD(dense),
                              [np.full(k, 0.125) for k in n], device="cpu")
    assert abs(float(Fraction(hi) + Fraction(lo) - exact)) < 1e-27, (hi, lo, float(exact))
    assert neval > 0


@needs_native
def test_refine_matches_jax_on_the_same_state(dyadic):
    from ttcross_tpu.cross.refine import refine_dd as jrefine

    dense, state, exact = dyadic
    n = list(dense.shape)
    w = [np.full(k, 0.125) for k in n]
    jhi, jlo, jn = jrefine(_StateView(state), n, lambda ind: (
        np.array([float(dense[tuple(i)]) for i in ind]), np.zeros(len(ind))), w)
    hi, lo, neval = refine_dd(state_from_numpy(state, "cpu"), n, DenseDD(dense), w, device="cpu")
    assert neval == jn
    assert abs(float((Fraction(hi) + Fraction(lo)) - (Fraction(jhi) + Fraction(jlo)))) \
        <= 1e-29 * abs(float(exact))
    assert abs(float(Fraction(jhi) + Fraction(jlo) - exact)) < 1e-27


class _StateView:
    """The JAX refine_dd reads .vip and .rk."""

    def __init__(self, arrays):
        self.vip, self.rk = arrays["vip"], arrays["rk"]


def _stdnorm_rule(nq, scale):
    """The dd rule on [-scale, scale], mapped in dd."""
    from ttcross_tpu_torch.ops.dd import DD, dd, dd_mul
    from ttcross_tpu_torch.ops.quadrature import gauss_legendre_dd

    (xh, xl), (wh, wl) = gauss_legendre_dd(nq)
    X = dd_mul(DD(torch.from_numpy(xh), torch.from_numpy(xl)), dd(scale))
    W = dd_mul(DD(torch.from_numpy(wh), torch.from_numpy(wl)), dd(scale))
    return X, W


@pytest.fixture(scope="module")
def stdnorm():
    """The product Gaussian, d = 4, n = 101 on [-8.5, 8.5]: the dd rule, the
    JAX cross's state (rank 4, rook) and the port's refinement of it."""
    from ttcross_tpu.apps import make_stdnorm as jmake_stdnorm
    from ttcross_tpu_torch.apps.stdnorm import StdnormDD

    d, nq, scale = 4, 101, 8.5
    X, W = _stdnorm_rule(nq, scale)
    jprob = jmake_stdnorm(d=d, n=nq, a=-scale, b=scale)
    res = jcross(jprob.fun, [nq] * d, max_rank=4, pivoting=1, accuracy=25e-16, return_state=True)
    state = _np_state(res.state)
    wh, wl = [W.hi.numpy()] * d, [W.lo.numpy()] * d
    hi, lo, _ = refine_dd(state_from_numpy(state, "cpu"), [nq] * d, StdnormDD(X, "cpu"), wh, wl,
                          device="cpu")
    return X, W, state, (hi, lo)


def test_refine_stdnorm_beyond_f64(stdnorm):
    """>= 28 digits against pi^2 (exact TT rank 1)."""
    from ttcross_tpu_torch.apps import TPI_STR

    hi, lo = stdnorm[3]
    with localcontext() as ctx:
        ctx.prec = 60
        tru = (Decimal(TPI_STR) / 2) ** 2
        digits = -float((abs(1 - (Decimal(hi) + Decimal(lo)) / tru)).log10())
    assert digits >= 28, digits


@needs_native
def test_refine_stdnorm_matches_jax(stdnorm):
    """The JAX package's refinement of the same state (its __float128
    integrand and contraction) within 1e-28 of the port's."""
    from ttcross_tpu.cross.refine import refine_dd as jrefine

    X, W, state, (hi, lo) = stdnorm
    d, nq = 4, X.hi.shape[0]
    xh, xl = X.hi.numpy(), X.lo.numpy()
    jhi, jlo, _ = jrefine(_StateView(state), [nq] * d, lambda ind: native.stdnorm_dd(ind, xh, xl),
                          [W.hi.numpy()] * d, [W.lo.numpy()] * d)
    with localcontext() as ctx:
        ctx.prec = 60
        apart = abs(Decimal(hi) + Decimal(lo) - (Decimal(jhi) + Decimal(jlo))) / Decimal(jhi)
    assert apart < Decimal("1e-28"), float(apart)
