"""The port's quad-double arithmetic (ttcross_tpu_torch/ops/qd.py) against
the JAX package's numpy path (ttcross_tpu/ops/qd.py).

Tolerance: none.  Both are IEEE binary64 operations in the same order with
no FMA contraction (numpy ufuncs, eager torch on the CPU), so every limb of
every result is bit-equal, on random inputs with populated low limbs, under
cancellation, with subnormal low limbs, and qd_exp over [-710, 710].  The
host conversions (decimal here, mpmath there) give the same limbs; the
80-digit Gauss-Legendre rule's limb tables equal the JAX makers' bit for
bit (both round values accurate to ~1e-80 into limbs whose last is ~1e-64
relative: they could differ only at a rounding tie)."""

from decimal import Decimal, localcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ttcross_tpu  # noqa: F401  (x64)
import ttcross_tpu.ops.qd as J
from ttcross_tpu_torch.ops import qd as P
from ttcross_tpu_torch.tt.types import TT
from torch_qd_helpers import one_torch_thread  # noqa: F401  (a fixture)


def _rand(rng, shape, scale=1.0, tiny=False):
    e0 = rng.standard_normal(shape) * (1e-300 if tiny else scale)
    e1 = e0 * rng.standard_normal(shape) * 1e-17
    e2 = e1 * rng.standard_normal(shape) * 1e-17
    e3 = e2 * rng.standard_normal(shape) * 1e-17
    return J.QD(e0, e1, e2, e3)


def _t(x):
    return P.QD(*(torch.from_numpy(np.ascontiguousarray(e, np.float64)) for e in x))


def _same(a, b):
    return all(np.array_equal(np.asarray(x), y.numpy()) for x, y in zip(a, b))


@pytest.mark.parametrize("op", ["qd_add", "qd_sub", "qd_mul", "qd_div"])
@pytest.mark.parametrize("tiny", [False, True])
def test_binary_ops_bit_equal(op, tiny):
    rng = np.random.default_rng(11)
    x, y = _rand(rng, 500, tiny=tiny), _rand(rng, 500, scale=3.0)
    assert _same(getattr(J, op)(x, y), getattr(P, op)(_t(x), _t(y)))


def test_cancellation_and_unary_ops_bit_equal():
    rng = np.random.default_rng(12)
    x, tiny = _rand(rng, 64), _rand(rng, 64, scale=1e-40)
    assert _same(J.qd_sub(J.qd_add(x, tiny), x), P.qd_sub(P.qd_add(_t(x), _t(tiny)), _t(x)))
    assert _same(J.qd_abs(x), P.qd_abs(_t(x))) and _same(J.qd_neg(x), P.qd_neg(_t(x)))
    b = rng.standard_normal(64)
    assert _same(J.qd_mul_f64(x, b), P.qd_mul_f64(_t(x), torch.from_numpy(b)))
    assert np.array_equal(J.qd_to_float(x), P.qd_to_float(_t(x)).numpy())
    d = J.qd_to_dd(x)
    assert _same((d.hi, d.lo), P.qd_to_dd(_t(x)))
    assert np.array_equal(J.qd_mag10(x), P.qd_mag10(_t(x)).numpy())


@pytest.mark.parametrize("K", [1, 2, 3, 5, 8, 55, 101, 201])
def test_qd_sum_tree_bit_equal(K):
    rng = np.random.default_rng(K)
    x, y = _rand(rng, K), _rand(rng, K)
    assert _same(J.qd_sum(x), P.qd_sum(_t(x)))
    assert _same(J.qd_dot(x, y), P.qd_dot(_t(x), _t(y)))
    X = _rand(rng, (3, K, 4))
    assert _same(J.qd_sum(X, axis=1), P.qd_sum(_t(X), axis=1))


def test_products_bit_equal():
    rng = np.random.default_rng(13)
    A, B = _rand(rng, (7, 6)), _rand(rng, (6, 5))
    assert _same(J.qd_matmul(A, B), P.qd_matmul(_t(A), _t(B)))
    G, v = _rand(rng, (3, 6, 4)), _rand(rng, 6)
    for axis, vv in ((1, v), (0, _rand(rng, 3)), (2, _rand(rng, 4))):
        assert _same(J.qd_vdot_axis(G, vv, axis), P.qd_vdot_axis(_t(G), _t(vv), axis))
    u = _rand(rng, 6)
    assert _same(J.qd_vdot_axis(A, u, 1), P.qd_vdot_axis(_t(A), _t(u), 1))
    cores = [_rand(rng, (1, 5, 3)), _rand(rng, (3, 5, 2)), _rand(rng, (2, 5, 1))]
    w = [_rand(rng, 5) for _ in range(3)]
    assert _same(J.qd_tt_value(cores, w), P.qd_tt_value([_t(c) for c in cores],
                                                         [_t(x) for x in w]))
    assert _same(J.qd_matmul(J.qd_zeros((3, 0)), J.qd_zeros((0, 2))),
                 P.qd_matmul(P.qd_zeros((3, 0)), P.qd_zeros((0, 2))))


def test_exp_bit_equal_over_the_f64_range():
    """qd_exp over [-710, 710], also where the low limbs go subnormal
    (x < ~-590) and where it saturates."""
    rng = np.random.default_rng(14)
    xs = np.concatenate([rng.uniform(-710, 710, 600), rng.uniform(-3, 3, 60),
                         [0.0, -650.0, 700.0, -708.0, 709.0, -710.0, 710.0, -707.99, 708.99]])
    x = J.qd(xs)
    x = J.QD(x.e0, x.e0 * 1e-17 * rng.standard_normal(len(xs)), x.e1, x.e3)
    assert _same(J.qd_exp(x), P.qd_exp(_t(x)))


def test_train_gather_and_contract_bit_equal():
    rng = np.random.default_rng(15)
    d, n = 4, 5
    cores = [rng.standard_normal((1 if c == 0 else r1, n, 1 if c == d - 1 else 3))
             for c, r1 in zip(range(d), (1, 3, 3, 3))]

    class NpTT:    # the JAX functions read .d and .cores
        pass

    jt = NpTT()
    jt.d, jt.cores = d, cores
    t = TT(tuple(torch.from_numpy(c) for c in cores))
    ind = rng.integers(0, n, (37, d))
    assert _same(J.qd_gather_tt(jt, ind), P.qd_gather_tt(t, torch.from_numpy(ind)))
    w = [_rand(rng, n) for _ in range(d)]
    assert _same(J.qd_contract(jt, w), P.qd_contract(t, [_t(x) for x in w]))


def test_decimal_conversions():
    s = "3.14159265358979323846264338327950288419716939937510582097494"
    assert J.qd_from_string(s) == P.qd_from_string(s)
    with localcontext() as ctx:
        ctx.prec = 90
        assert abs(P.qd_to_mp(*P.qd_from_string(s)) / Decimal(s) - 1) < Decimal("1e-63")
        third = P.qd_from_mp(Decimal(1) / 3)
        assert abs(P.qd_to_mp(*third) * 3 - 1) < Decimal("1e-63")
    # qd_exp's constants: ln 2 and 1/k! at 80 digits, the JAX package's limbs
    ln2, inv_fact = J._exp_consts()
    assert tuple(ln2) == P._LN2 and [tuple(c) for c in inv_fact] == P._INV_FACT
    x = P.QD(*(torch.tensor(v, dtype=torch.float64) for v in P._LN2))
    assert P.qd_to_string(x, 40).startswith("0.6931471805599453094172321214581765680755")


@pytest.mark.parametrize("n", [17, 33, 65, 201])
def test_the_80_digit_rule_matches_mp_lgwt(n):
    """The qd makers' limb tables (nodes and weights of gauss_legendre_decimal
    split into limbs) equal the JAX makers' (mp_lgwt at 80 digits), bit for
    bit; the integrands then agree bit for bit too."""
    from ttcross_tpu.apps.ising import make_ising_qd as jmake_ising_qd
    from ttcross_tpu.apps.stdnorm import make_stdnorm_qd as jmake_stdnorm_qd
    from ttcross_tpu_torch.apps import make_ising_qd, make_stdnorm_qd

    rng = np.random.default_rng(n)
    if n != 201:
        jp, jf, jw = jmake_ising_qd(m=4, n=n)
        pp, pf, pw = make_ising_qd(m=4, n=n, device="cpu")
        assert np.array_equal(jp.nodes, pp.nodes) and np.array_equal(jp.weights, pp.weights)
    else:
        jp, jf, jw = jmake_stdnorm_qd(d=4, n=n)
        pp, pf, pw = make_stdnorm_qd(d=4, n=n, device="cpu")
        assert np.array_equal(jp.nodes, pp.nodes)
    assert _same(jw[0], pw[0])
    cells = dict(zip(jf.__code__.co_freevars, (c.cell_contents for c in jf.__closure__)))
    jlimbs = np.stack([*cells["Xn"], *cells["Wn"]] if "Wn" in cells else [*cells["Xn"]])
    assert np.array_equal(jlimbs, pf.limbs[: len(jlimbs)])
    ind = rng.integers(0, n, (300, pp.d))
    assert _same(jf(ind), pf(torch.from_numpy(ind)))
