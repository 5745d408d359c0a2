"""Double-double (compensated) arithmetic: the beyond-f64 precision tier.

Counterpart of ttcross_tpu/ops/dd.py.  A DD value is a pair (hi, lo) with
|lo| <= ulp(hi)/2; arrays of DD values are pairs of equal-shape float64
tensors on whatever device they lie (struct of arrays).  Every operation
is built from the error-free transforms two_sum and two_prod, in the JAX
package's operation order: eager torch never contracts a multiply and an
add into an FMA, so on the CPU these functions give the bits of the JAX
package's eager ones, and they are the plain versions of the dd kernels
(ops/kernels.py).  dd_sum is a sequential scan from zero, left to right.

The JAX package's float32-pair range machinery (its _full_f64_range,
_pow2_chain, _exact_pow2: the TPU emulates f64 as a pair of f32s) is not
carried over: the port always has binary64's range, so dd_exp saturates at
the binary64 floor and ceiling, and scales by 2^k with
ops/dense.py::scale_pow2; pow2_balance reads the exponent from the bits
(ops/dense.py::pow2_balance_mats).
"""

from __future__ import annotations

import math
from decimal import Decimal, localcontext
from typing import NamedTuple

import torch

from . import kernels as _kernels
from .dense import pow2_balance_mats, scale_pow2

__all__ = ["DD", "dd", "two_sum", "two_prod", "dd_add", "dd_sub", "dd_mul",
           "dd_div", "dd_neg", "dd_abs", "dd_sum", "dd_dot", "dd_matvec",
           "dd_matmul", "dd_to_float", "dd_from_string", "dd_to_string",
           "dd_contract", "dd_gather_tt", "dd_exp", "dd_log", "pow2_balance"]

_SPLIT = 134217729.0  # 2^27 + 1, Dekker splitting constant for binary64


class DD(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def shape(self):
        return self.hi.shape


def dd(hi, lo=0.0) -> DD:
    """A DD from a tensor (kept where it lies), array or number (on the
    CPU) of hi parts, float64, and lo parts broadcast to its shape."""
    hi = torch.as_tensor(hi, dtype=torch.float64)
    lo = torch.as_tensor(lo, dtype=torch.float64, device=hi.device)
    return DD(hi, lo.expand(hi.shape).clone() if lo.shape != hi.shape else lo)


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly (Knuth)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _quick_two_sum(a, b):
    """Error-free sum assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    t = _SPLIT * a
    ahi = t - (t - a)
    return ahi, a - ahi


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker splitting; no FMA
    dependency, IEEE-correct f64 suffices)."""
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def dd_add(x: DD, y: DD) -> DD:
    s, e = two_sum(x.hi, y.hi)
    e = e + x.lo + y.lo
    s, e = _quick_two_sum(s, e)
    return DD(s, e)


def dd_neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def dd_sub(x: DD, y: DD) -> DD:
    return dd_add(x, dd_neg(y))


def dd_abs(x: DD) -> DD:
    neg = x.hi < 0
    return DD(torch.where(neg, -x.hi, x.hi), torch.where(neg, -x.lo, x.lo))


def dd_mul(x: DD, y: DD) -> DD:
    p, e = two_prod(x.hi, y.hi)
    e = e + x.hi * y.lo + x.lo * y.hi
    p, e = _quick_two_sum(p, e)
    return DD(p, e)


def dd_div(x: DD, y: DD) -> DD:
    q1 = x.hi / y.hi
    r = dd_sub(x, dd_mul(DD(q1, torch.zeros_like(q1)), y))
    q2 = r.hi / y.hi
    r = dd_sub(r, dd_mul(DD(q2, torch.zeros_like(q2)), y))
    q3 = r.hi / y.hi
    s, e = _quick_two_sum(q1, q2)
    s, e2 = _quick_two_sum(s, e + q3)
    return DD(s, e2)


def dd_sum(x: DD, axis=None) -> DD:
    """Sequential compensated sum over one axis (all elements, flattened,
    when axis is None), from zero, left to right: the JAX package's scan
    order (replaces mpblas sum loops)."""
    hi = x.hi.reshape(-1) if axis is None else torch.movedim(x.hi, axis, 0)
    lo = x.lo.reshape(-1) if axis is None else torch.movedim(x.lo, axis, 0)
    acc = DD(torch.zeros(hi.shape[1:], dtype=hi.dtype, device=hi.device),
             torch.zeros(hi.shape[1:], dtype=hi.dtype, device=hi.device))
    for t in range(hi.shape[0]):
        acc = dd_add(acc, DD(hi[t], lo[t]))
    return acc


def dd_dot(xh, xl, yh, yl) -> DD:
    """Compensated dot product of dd vectors (mpdot, mpblas.f90)."""
    return dd_sum(dd_mul(DD(xh, xl), DD(yh, yl)))


def dd_matvec(Ah, Al, xh, xl) -> DD:
    """(m, n) dd matrix times dd vector (mpgemv, mpblas.f90)."""
    x = DD(xh[None, :].expand(Ah.shape), xl[None, :].expand(Ah.shape))
    return dd_sum(dd_mul(DD(Ah, Al), x), axis=1)


def dd_matmul(Ah, Al, Bh, Bl) -> DD:
    """Small dd GEMM by contraction over the shared axis (mpgemm,
    mpblas.f90); shapes (m, k) x (k, n)."""
    prods = dd_mul(DD(Ah[:, :, None], Al[:, :, None]), DD(Bh[None], Bl[None]))
    return dd_sum(prods, axis=1)


def _dd_const(s: str) -> tuple[float, float]:
    with localcontext() as ctx:
        ctx.prec = 60
        v = Decimal(s)
        hi = float(v)
        return hi, float(v - Decimal(hi))


_LN2_HI, _LN2_LO = _dd_const(
    "0.69314718055994530941723212145817656807550013436025525412068")


def _inv_fact() -> list[tuple[float, float]]:
    """1/k! as exact dd pairs, k = 2..16 (the Taylor tail of exp on
    |r| <= ln2/1024)."""
    out = []
    with localcontext() as ctx:
        ctx.prec = 60
        for k in range(2, 17):
            v = Decimal(1) / Decimal(math.factorial(k))
            h = float(v)
            out.append((h, float(v - Decimal(h))))
    return out


_INV_FACT = _inv_fact()
_EXP_FLOOR, _EXP_CEIL = -708.0, 709.9   # binary64's range (the JAX package's full-range branch)


def dd_exp(x: DD) -> DD:
    """Device dd exponential: range reduction x = k ln2 + r, scale r by
    2^-9, Taylor series to dd accuracy, 9 repeated squarings, times 2^k
    (the qd-library scheme).  Elementwise over any shape; flushes to zero
    below x = -708 and overflows to inf above 709.9."""
    k = torch.round(x.hi / _LN2_HI)
    ln2 = DD(torch.full_like(x.hi, _LN2_HI), torch.full_like(x.hi, _LN2_LO))
    r = dd_sub(x, dd_mul(DD(k, torch.zeros_like(k)), ln2))
    r = DD(r.hi * (1.0 / 512.0), r.lo * (1.0 / 512.0))   # exact: power of 2
    # Horner over 1/k! tail, then + r + 1
    p = DD(torch.full_like(x.hi, _INV_FACT[-1][0]), torch.full_like(x.hi, _INV_FACT[-1][1]))
    for ch, cl in reversed(_INV_FACT[:-1]):
        p = dd_add(dd_mul(p, r), DD(torch.full_like(x.hi, ch), torch.full_like(x.hi, cl)))
    p = dd_mul(dd_mul(p, r), r)          # sum_{k>=2} r^k/k!
    p = dd_add(p, r)
    s = dd_add(p, DD(torch.ones_like(x.hi), torch.zeros_like(x.hi)))
    for _ in range(9):
        s = dd_mul(s, s)
    out = DD(scale_pow2(s.hi, k), scale_pow2(s.lo, k))
    z = torch.zeros_like(x.hi)
    hi = torch.where(x.hi < _EXP_FLOOR, z,
                     torch.where(x.hi > _EXP_CEIL, torch.full_like(z, math.inf), out.hi))
    lo = torch.where((x.hi < _EXP_FLOOR) | (x.hi > _EXP_CEIL), z, out.lo)
    return DD(hi, lo)


def pow2_balance(x):
    """Norm-balance by an exact power of two (ttcross_tpu/ops/dd.py:231):
    returns (x * 2^-e, e) with e = floor(log2 max|x|), so max|x * 2^-e| is
    in [1, 2); e is a 0-d float64 tensor on x's device, 0 when max|x| is 0
    or not finite (x then passes through).  The exponent comes from the
    bits (pow2_balance_mats over x as one matrix), where the JAX package
    takes a log2."""
    y, e = pow2_balance_mats(x.reshape(1, 1, -1))
    return y.reshape(x.shape), e[0].to(torch.float64)


def dd_log(x: DD) -> DD:
    """Device dd logarithm by Newton iteration on dd_exp: y_{n+1} = y_n +
    x exp(-y_n) - 1, seeded with the f64 log."""
    y = DD(torch.log(x.hi), torch.zeros_like(x.hi))
    one = DD(torch.ones_like(x.hi), torch.zeros_like(x.hi))
    for _ in range(2):
        e = dd_exp(dd_neg(y))
        y = dd_add(y, dd_sub(dd_mul(x, e), one))
    return y


def dd_to_float(x: DD):
    return x.hi + x.lo


def dd_from_string(s: str) -> tuple[float, float]:
    """Parse a decimal string into (hi, lo) on the host (the truth
    constants, apps/truths.py)."""
    with localcontext() as ctx:
        ctx.prec = 80
        v = Decimal(s)
        hi = float(v)
        lo = float(v - Decimal(hi))
    return hi, lo


def dd_to_string(x, digits: int = 32) -> str:
    """Render a (scalar) DD to `digits` decimal digits (mpsay analogue,
    mpfung1.f90:526)."""
    with localcontext() as ctx:
        ctx.prec = digits + 10
        v = Decimal(float(x.hi)) + Decimal(float(x.lo))
        return f"{v:.{digits}e}"


def dd_gather_tt(t, ind) -> DD:
    """Evaluate an f64 TT at (B, d) indices with all accumulation in dd:
    the chain of matvecs runs through dd_mul / dd_sum, so the result
    carries ~32 significant digits of the exact product of the stored f64
    cores (the defect pipeline's, cross/defect.py).  On the card the defect
    integrand takes the one-launch kernel ops/kernels.py::dd_gather_tt_fused,
    whose plain version this is."""
    return _dd_gather_tt_plain(t.cores, ind)


def _dd_gather_tt_plain(cores, ind) -> DD:
    """The body of dd_gather_tt: v = (1), then per core the products
    dd_mul(v, (G_c[:, i_c, :], 0)) summed over the left rank by dd_sum."""
    ind = torch.as_tensor(ind, device=cores[0].device).long()
    B = ind.shape[0]
    one = torch.ones((B, 1), dtype=torch.float64, device=cores[0].device)
    v = DD(one, torch.zeros_like(one))
    for c, core in enumerate(cores):
        g = core.index_select(1, ind[:, c]).movedim(1, 0)          # (B, r, r2)
        prod = dd_mul(DD(v.hi[:, :, None].expand(g.shape), v.lo[:, :, None].expand(g.shape)),
                      DD(g, torch.zeros_like(g)))                  # (B, r, r2)
        v = dd_sum(prod, axis=1)                                   # (B, r2)
    return DD(v.hi[:, 0], v.lo[:, 0])


def _contract_pairs(cores, weights) -> DD:
    """v = (1), then v <- v @ (sum_n G[:, n, :] w[n]) per core, all in dd:
    each sum in order from zero, the core (then v) the left factor of every
    product.  cores DD (r, n, r'), weights DD (n,), on one device; the body
    of dd_contract and of the dd engine's quadrature (cross/engine_dd.py::
    dd_quad_cores).  Two launches of the dd GEMM per core on the card
    (ops/kernels.py::dd_dot, D4)."""
    one = cores[0].hi.new_ones((1, 1))
    v = DD(one, torch.zeros_like(one))                               # (1, r)
    for g, w in zip(cores, weights):
        r, n, r2 = g.hi.shape
        m = _kernels.dd_dot(DD(g.hi.permute(0, 2, 1), g.lo.permute(0, 2, 1)),
                            DD(w.hi[None, None].expand(r, r2, n),
                               w.lo[None, None].expand(r, r2, n)))  # (r, r')
        v = _kernels.dd_dot(DD(v.hi[:, None].expand(1, r2, r), v.lo[:, None].expand(1, r2, r)),
                            DD(m.hi.T[None], m.lo.T[None]))          # (1, r')
    return DD(v.hi[0, 0], v.lo[0, 0])


def dd_contract(t, weights_hi, weights_lo=None) -> DD:
    """TT contraction against per-mode weights carried in dd: the
    high-precision quadrature path (mptt_quad, dmrggmp.f90:778-888).  The TT
    cores are f64 (exact when promoted to dd); all accumulation is dd.
    Runs where the train lies."""
    dev = t.device
    cores, weights = [], []
    for c in range(t.d):
        g = t.cores[c].to(torch.float64)                         # (r, n, r')
        wh = torch.as_tensor(weights_hi[c], dtype=torch.float64, device=dev)
        wl = (torch.zeros_like(wh) if weights_lo is None
              else torch.as_tensor(weights_lo[c], dtype=torch.float64, device=dev))
        cores.append(DD(g, torch.zeros_like(g)))
        weights.append(DD(wh, wl))
    return _contract_pairs(cores, weights)
