"""The port's double-double arithmetic (ops/dd.py), its dd quadrature rule
and its dd integrands against the JAX package and its __float128 library.

The dd operations are held against the JAX package's EAGER ones on seeded
numpy inputs: eager torch and eager XLA round every operation once and
neither contracts a multiply-add, so add, mul, div and sum agree bit for
bit.  dd_exp / dd_log within 1e-31 relative: dd_log's Newton steps start
from one f64 log, whose last bit may differ between the libraries, and
XLA:CPU flushes a subnormal lo part of dd_exp's tiniest results to zero.
The integrands are held against the JAX package's JITTED ones
(as its engines call them): XLA:CPU contracts multiply-adds into FMAs
under jit, which moves a dd result's lo part by ~1e-32 relative, so within
1e-30; and against the __float128 library within 1e-28 (the dd arithmetic's
own error over a d-step chain, as tests/test_defect.py:24-40 holds JAX's)."""

from decimal import Decimal, localcontext
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import ttcross_tpu  # noqa: F401  (x64)
import ttcross_tpu.ops.dd as jdd
from ttcross_tpu import native
from ttcross_tpu.apps.ising import make_ising_dd as jmake_ising_dd
from ttcross_tpu.apps.stdnorm import make_stdnorm_dd as jmake_stdnorm_dd
from ttcross_tpu.tt.types import TT as JTT
from ttcross_tpu_torch.apps.ising import IsingDD, make_ising_dd
from ttcross_tpu_torch.apps.stdnorm import StdnormDD
from ttcross_tpu_torch.interop import dd_pair_from_numpy
from ttcross_tpu_torch.ops import dd as pdd
from ttcross_tpu_torch.ops import kernels as K
from ttcross_tpu_torch.ops.quadrature import gauss_legendre_dd
from ttcross_tpu_torch.tt.types import TT
from test_torch_engine_dd import _jax_tables

pytestmark = pytest.mark.skipif(not native.available(), reason="no native toolchain")


@pytest.fixture
def gen():
    return np.random.default_rng(2024)


def _pairs(gen, shape, spread=3.0):
    """Normalized dd pairs of varied magnitudes and signs (numpy)."""
    hi = gen.standard_normal(shape) * 10.0 ** gen.uniform(-spread, spread, shape)
    lo = hi * gen.uniform(-0.5, 0.5, shape) * 2.0 ** -52
    s = hi + lo
    return s, lo - (s - hi)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _bits(p, j):
    """A port DD and a JAX DD hold the same bits."""
    return all(np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
               for a, b in ((p.hi, j.hi), (p.lo, j.lo)))


def _rel(p, ref_hi, ref_lo):
    """max |p - ref| / max |ref|, the dd values compared as hi + lo pairs."""
    d = (np.asarray(p.hi) - ref_hi) + (np.asarray(p.lo) - ref_lo)
    return float(np.abs(d).max() / max(np.abs(ref_hi).max(), 1e-300))


def test_two_sum_two_prod_exact(gen):
    a = gen.standard_normal(300) * 10.0 ** gen.uniform(-8, 8, 300)
    b = gen.standard_normal(300) * 10.0 ** gen.uniform(-8, 8, 300)
    s, e = pdd.two_sum(_t(a), _t(b))
    p, f = pdd.two_prod(_t(a), _t(b))
    for i in range(300):
        assert Fraction(float(s[i])) + Fraction(float(e[i])) == Fraction(a[i]) + Fraction(b[i])
        assert Fraction(float(p[i])) + Fraction(float(f[i])) == Fraction(a[i]) * Fraction(b[i])
    qs, qe = pdd._quick_two_sum(_t(np.abs(a) + np.abs(b)), _t(b * 1e-3))
    assert np.all(np.abs(qe.numpy()) <= np.spacing(np.abs(qs.numpy())))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "neg", "abs"])
def test_elementwise_ops_bit_equal_eager_jax(op, gen):
    xh, xl = _pairs(gen, (7, 33))
    yh, yl = _pairs(gen, (7, 33))
    px, py = pdd.DD(_t(xh), _t(xl)), pdd.DD(_t(yh), _t(yl))
    jx, jy = jdd.DD(jnp.asarray(xh), jnp.asarray(xl)), jdd.DD(jnp.asarray(yh), jnp.asarray(yl))
    if op in ("neg", "abs"):
        got, want = getattr(pdd, "dd_" + op)(px), getattr(jdd, "dd_" + op)(jx)
    else:
        got, want = getattr(pdd, "dd_" + op)(px, py), getattr(jdd, "dd_" + op)(jx, jy)
    assert _bits(got, want)


def test_reductions_bit_equal_eager_jax(gen):
    xh, xl = _pairs(gen, (6, 40))
    yh, yl = _pairs(gen, (40, 5))
    vh, vl = _pairs(gen, (40,))
    px = pdd.DD(_t(xh), _t(xl))
    jx = jdd.DD(jnp.asarray(xh), jnp.asarray(xl))
    assert _bits(pdd.dd_sum(px, axis=1), jdd.dd_sum(jx, axis=1))
    assert _bits(pdd.dd_sum(px, axis=0), jdd.dd_sum(jx, axis=0))
    assert _bits(pdd.dd_sum(px), jdd.dd_sum(jx))
    assert _bits(pdd.dd_dot(_t(vh), _t(vl), _t(vh[::-1].copy()), _t(vl[::-1].copy())),
                 jdd.dd_dot(jnp.asarray(vh), jnp.asarray(vl), jnp.asarray(vh[::-1]),
                            jnp.asarray(vl[::-1])))
    assert _bits(pdd.dd_matvec(_t(xh), _t(xl), _t(vh), _t(vl)),
                 jdd.dd_matvec(jnp.asarray(xh), jnp.asarray(xl), jnp.asarray(vh),
                               jnp.asarray(vl)))
    assert _bits(pdd.dd_matmul(_t(xh), _t(xl), _t(yh), _t(yl)),
                 jdd.dd_matmul(*(jnp.asarray(a) for a in (xh, xl, yh, yl))))


def test_exp_log_match_jax_and_decimal(gen):
    x = np.concatenate([gen.uniform(-700, 700, 60), gen.uniform(-3, 3, 60),
                        [-750.0, 715.0, 0.0, 1e-20]])
    xl = x * gen.uniform(-0.5, 0.5, x.shape) * 2.0 ** -53
    pe = pdd.dd_exp(pdd.DD(_t(x), _t(xl)))
    je = jdd.dd_exp(jdd.DD(jnp.asarray(x), jnp.asarray(xl)))
    fin = np.isfinite(np.asarray(je.hi)) & (np.asarray(je.hi) != 0)
    assert np.array_equal(np.asarray(pe.hi)[~fin], np.asarray(je.hi)[~fin])
    assert np.array_equal(np.asarray(pe.hi), np.asarray(je.hi))
    # XLA:CPU flushes subnormal results to zero and torch does not: a lo
    # part below the smallest normal (results under ~1e-292) may differ by it
    err = np.abs(np.asarray(pe.lo) - np.asarray(je.lo))
    assert np.all(err[fin] <= 1e-31 * np.abs(np.asarray(je.hi))[fin] + np.finfo(np.float64).tiny)
    # and the value itself, in decimal: dd_exp's own error (nine squarings
    # magnify the Taylor sum's ~1e-32 by 2^9, tests/test_dd.py holds 1e-28)
    with localcontext() as ctx:
        ctx.prec = 60
        for i in np.flatnonzero(fin & (np.abs(np.asarray(je.hi)) > 1e-290))[::7]:
            exact = (Decimal(x[i]) + Decimal(xl[i])).exp()
            got = Decimal(float(pe.hi[i])) + Decimal(float(pe.lo[i]))
            assert abs((got - exact) / exact) < Decimal("1e-28")
    y = 10.0 ** gen.uniform(-10, 10, 80)
    pl = pdd.dd_log(pdd.DD(_t(y), torch.zeros(80, dtype=torch.float64)))
    jl = jdd.dd_log(jdd.dd(jnp.asarray(y)))
    err = np.abs((np.asarray(pl.hi) - np.asarray(jl.hi)) + (np.asarray(pl.lo) - np.asarray(jl.lo)))
    assert np.all(err <= 1e-31 * np.abs(np.asarray(jl.hi)))


def test_string_conversions_match_jax():
    s = "0.70119986017642999981651392754834582794624200386529101437882507394940"
    assert pdd.dd_from_string(s) == jdd.dd_from_string(s)
    assert pdd._dd_const(s) == jdd._dd_const(s)
    h, lo = pdd.dd_from_string(s)
    assert (pdd.dd_to_string(pdd.DD(_t(h), _t(lo)))
            == jdd.dd_to_string(jdd.DD(jnp.asarray(h), jnp.asarray(lo))))
    assert pdd._INV_FACT == jdd._INV_FACT and (pdd._LN2_HI, pdd._LN2_LO) == (jdd._LN2_HI, jdd._LN2_LO)


def _train(gen, ranks, n):
    return [gen.standard_normal((ranks[c], n, ranks[c + 1])) for c in range(len(ranks) - 1)]


def test_gather_tt_and_contract_match_jax_and_float128(gen):
    ranks, n = (1, 6, 8, 5, 1), 17
    cores = _train(gen, ranks, n)
    ind = gen.integers(0, n, (64, 4))
    pt, jt = TT(tuple(_t(c) for c in cores)), JTT(cores=[jnp.asarray(c) for c in cores])
    got, want = pdd.dd_gather_tt(pt, _t(ind)), jdd.dd_gather_tt(jt, jnp.asarray(ind))
    assert _rel(got, np.asarray(want.hi), np.asarray(want.lo)) < 1e-30
    # the packed form (D3's plain version) is the same function
    assert _bits(K.dd_gather_tt_plain(K.pack_tt(pt), _t(ind).to(torch.int32)), got)
    wh = [gen.uniform(0, 1, n) for _ in range(4)]
    wl = [w * 2.0 ** -60 for w in wh]
    pc, jc = pdd.dd_contract(pt, wh, wl), jdd.dd_contract(jt, wh, wl)
    assert _rel(pc, float(jc.hi), float(jc.lo)) < 1e-30
    qh, ql = native.contract_q(jt, wh, wl)
    assert _rel(pc, qh, ql) < 1e-28


@pytest.mark.parametrize("n", [17, 65])
def test_gauss_legendre_dd_matches_float128(n):
    (xh, xl), (wh, wl) = gauss_legendre_dd(n)
    (jxh, jxl), (jwh, jwl) = native.gauss_legendre_dd(n)
    assert np.array_equal(xh, jxh) and np.array_equal(wh, jwh)
    assert np.abs((xl - jxl)).max() <= 1e-31 * np.abs(jxh).max()
    assert np.all(np.abs(wl - jwl) <= 1e-31 * jwh)
    assert xh[n // 2] == xl[n // 2] == 0.0 and np.all(np.diff(xh) > 0)


def test_makers_match_jax():
    """make_ising_dd: the f64 problem's tables are the JAX maker's bit for
    bit (the dd rule's hi parts), the dd tables within 1e-31 of its."""
    jprob, jfun, jwh, jwl = jmake_ising_dd(m=4, n=33)
    prob, fun_dd, wh, wl = make_ising_dd(m=4, n=33, device="cpu")
    assert np.array_equal(prob.nodes, jprob.nodes) and np.array_equal(prob.weights, jprob.weights)
    assert np.array_equal(wh[0], jwh[0]) and prob.truth == jprob.truth and prob.d == jprob.d
    tab = fun_dd.tables.numpy()
    (xh, xl), (gh, gl) = native.gauss_legendre_dd(33)
    assert np.abs((tab[0] - (xh + 1) / 2) + tab[1]).max() < 1e-15   # nodes on [0, 1]
    jx = (np.asarray(jfun(jnp.zeros((1, 3), jnp.int32)).hi),)
    px = fun_dd(torch.zeros((1, 3), dtype=torch.int32)).hi.numpy()
    assert abs(px[0] - jx[0][0]) <= 1e-15 * abs(jx[0][0])


def test_ising_integrand_dd_matches_jax_and_float128(gen):
    from ttcross_tpu.apps.ising import ising_c_integrand_dd as jising_dd

    (xh, xl), (wh, wl) = _jax_tables(17)
    for d in (3, 5):
        ind = gen.integers(0, 17, (48, d)).astype(np.int32)
        fun = IsingDD(dd_pair_from_numpy(xh, xl, "cpu"), dd_pair_from_numpy(wh, wl, "cpu"), "cpu")
        got = fun(_t(ind))
        jfun = jax.jit(lambda i: jising_dd(i, jdd.DD(jnp.asarray(xh), jnp.asarray(xl)),
                                           jdd.DD(jnp.asarray(wh), jnp.asarray(wl))))
        want = jfun(jnp.asarray(ind))
        err = np.abs((got.hi.numpy() - np.asarray(want.hi)) + (got.lo.numpy() - np.asarray(want.lo)))
        assert np.all(err <= 1e-30 * np.abs(np.asarray(want.hi)))
        qh, ql = native.ising_c_dd(ind, xh, xl, wh, wl)
        assert np.all(np.abs((got.hi.numpy() - qh) + (got.lo.numpy() - ql)) <= 1e-28 * np.abs(qh))
        # the kernel's plain version, as the wrapper runs it on a CPU tensor
        assert _bits(K.ising_c_integrand_dd_plain(fun.tables, _t(ind)), got)


def test_stdnorm_integrand_dd_matches_jax_and_float128(gen):
    from ttcross_tpu.apps.stdnorm import stdnorm_integrand_dd as jstd_dd

    jprob, jfun, jwh, jwl = jmake_stdnorm_dd(d=3, n=33)
    (xh, xl), _ = native.gauss_legendre_dd(33)
    Xn = jdd.dd_add(jdd.dd_mul(jdd.DD(jnp.asarray(xh), jnp.asarray(xl)), jdd.dd(10.0)),
                    jdd.DD(jnp.zeros(33), jnp.zeros(33)))
    nh, nl = np.asarray(Xn.hi), np.asarray(Xn.lo)
    assert np.array_equal(nh, jprob.nodes)
    ind = gen.integers(0, 33, (64, 3)).astype(np.int32)
    fun = StdnormDD(dd_pair_from_numpy(nh, nl, "cpu"), "cpu")
    got = fun(_t(ind))
    nodes = jdd.DD(jnp.asarray(nh), jnp.asarray(nl))
    assert _bits(got, jstd_dd(jnp.asarray(ind), nodes))           # eager: bit for bit
    # jitted: dd_exp's nine squarings magnify the ~1e-32 of XLA's contracted
    # FMAs 2^9-fold (3.1e-30 measured at a value of 4e-38), so 1e-29
    want = jax.jit(lambda i: jstd_dd(i, nodes))(jnp.asarray(ind))
    wh_ = np.asarray(want.hi)
    err = np.abs((got.hi.numpy() - wh_) + (got.lo.numpy() - np.asarray(want.lo)))
    assert np.all(err <= 1e-29 * np.abs(wh_))
    qh, ql = native.stdnorm_dd(ind, nh, nl)
    assert np.all(np.abs((got.hi.numpy() - qh) + (got.lo.numpy() - ql)) <= 1e-28 * np.abs(qh))


def test_score_and_dot_plain_match_jax_engine_formulas(gen):
    """D1's and D4's plain versions compute the JAX dd engine's products
    (cross/engine_dd.py's lottery residual, _mv_rank, _vm_rank, _mm_left)
    bit for bit."""
    B, T = 30, 8
    bh, bl = _pairs(gen, (B,))
    xh, xl = _pairs(gen, (B, T))
    yh, yl = _pairs(gen, (B, T))
    rank = 5
    m = (np.arange(T) < rank).astype(np.float64)[None, :]
    jdot = jdd.dd_sum(jdd.dd_mul(jdd.DD(jnp.asarray(xh * m), jnp.asarray(xl * m)),
                                 jdd.DD(jnp.asarray(yh), jnp.asarray(yl))), axis=1)
    jres = jdd.dd_sub(jdd.DD(jnp.asarray(bh), jnp.asarray(bl)), jdot)
    mask = gen.random(B) > 0.3
    r, flat, best = K.dd_score_residual_argmax_plain(
        pdd.DD(_t(bh), _t(bl)), pdd.DD(_t(xh), _t(xl)), pdd.DD(_t(yh), _t(yl)),
        torch.tensor([rank], dtype=torch.int32), _t(mask), K.MASK_X)
    assert _bits(r, jres)
    assert int(flat) == int(jnp.argmax(jnp.where(jnp.asarray(mask), jnp.abs(jres.hi), -1.0)))
    assert float(best.hi) == float(r.hi[flat])
    # _mm_left: (R, R) @ (R, N), itl the left factor
    ah, al = _pairs(gen, (6, 6))
    ch, cl = _pairs(gen, (6, 9))
    want = jdd.dd_sum(jdd.dd_mul(jdd.DD(jnp.asarray(ah)[:, :, None], jnp.asarray(al)[:, :, None]),
                                 jdd.DD(jnp.asarray(ch)[None], jnp.asarray(cl)[None])), axis=1)
    x = pdd.DD(*(_t(a)[:, None, :].expand(6, 9, 6) for a in (ah, al)))
    y = pdd.DD(*(_t(a).T[None].expand(6, 9, 6) for a in (ch, cl)))
    assert _bits(K.dd_dot_plain(x, y), want)
