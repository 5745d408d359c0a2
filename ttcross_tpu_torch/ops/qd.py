"""Quad-double (4-limb compensated) arithmetic: the ~62-digit tier.

Counterpart of ttcross_tpu/ops/qd.py.  A QD value is four f64 limbs (e0,
e1, e2, e3) of decreasing magnitude; arrays of them are four equal-shape
float64 tensors on one device (struct of arrays).  Every operation distills
its exact partial terms with a few error-free two_sum sweeps over the term
list (bottom-up VecSum, Ogita-Rump-Oishi), in the JAX package's operation
order, with the error-free transforms of ops/dd.py.  Eager torch never
contracts a multiply and an add into an FMA, so on the CPU these functions
give the bits of the JAX package's numpy path, and they are the plain
versions of the qd kernels Q1-Q5 (ops/kernels.py, csrc/qd_kernels.cu).

The JAX package keeps its qd tier on the host: a TPU's emulated f64 breaks
Dekker's two_prod.  A CUDA card's f64 is IEEE binary64, so here the tier
runs on whatever device its tensors lie on, the card by default.
qd_div, qd_gather_tt, qd_contract, qd_tt_value, qd_matmul and qd_vdot_axis
launch the qd kernels on a CUDA tensor (qd_div's plain body is
_qd_div_plain).

There is no mpmath: the host conversions (qd_from_mp, qd_to_mp,
qd_from_string, qd_to_string) work with Python's decimal at >= 80 digits,
and qd_exp's constants are decimal values split into limbs.
"""

from __future__ import annotations

import math
from decimal import Decimal, localcontext
from fractions import Fraction
from typing import NamedTuple

import torch

from . import kernels as _kernels
from .dd import DD, two_prod, two_sum

__all__ = ["QD", "qd", "qd_add", "qd_sub", "qd_neg", "qd_abs", "qd_mul",
           "qd_mul_f64", "qd_div", "qd_sum", "qd_dot", "qd_from_dd",
           "qd_to_dd", "qd_to_float", "qd_from_string", "qd_to_string",
           "qd_gather_tt", "qd_contract", "qd_from_mp", "qd_to_mp",
           "qd_zeros", "qd_get", "qd_concat", "qd_vdot_axis", "qd_matmul",
           "qd_mag10", "qd_tt_value", "qd_exp", "QD_DIGITS"]

QD_DIGITS = 80   # decimal digits of the host conversions (>= ~70 for full qd precision)


class QD(NamedTuple):
    e0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    e3: torch.Tensor

    @property
    def shape(self):
        return self.e0.shape


def _limb(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, (int, float)):
        return torch.full_like(like, float(v))
    return torch.as_tensor(v, dtype=torch.float64, device=like.device).expand(like.shape).clone()


def qd(e0, e1=0.0, e2=0.0, e3=0.0) -> QD:
    """A QD from a tensor (kept where it lies), array or number (on the CPU)
    of leading limbs, float64, and lower limbs broadcast to its shape."""
    e0 = torch.as_tensor(e0, dtype=torch.float64)
    return QD(e0, _limb(e1, e0), _limb(e2, e0), _limb(e3, e0))


def _distill(terms, passes: int = 4) -> QD:
    """Reduce a list of f64 terms (exact-sum representation) to a QD:
    `passes` bottom-up VecSum sweeps of adjacent two_sum, each an
    error-free transform of the list, then the tail below ulp(e3) folded in
    plainly, in order."""
    t = list(terms)
    K = len(t)
    for _ in range(passes):
        for i in range(K - 2, -1, -1):
            t[i], t[i + 1] = two_sum(t[i], t[i + 1])
    tail = t[3]
    for x in t[4:]:
        tail = tail + x
    return QD(t[0], t[1], t[2], tail)


def qd_neg(x: QD) -> QD:
    return QD(-x.e0, -x.e1, -x.e2, -x.e3)


def qd_abs(x: QD) -> QD:
    neg = x.e0 < 0
    return QD(*(torch.where(neg, -v, v) for v in x))


def qd_add(x: QD, y: QD) -> QD:
    """x + y: the eight limbs merged magnitude-interleaved and distilled."""
    return _distill([x.e0, y.e0, x.e1, y.e1, x.e2, y.e2, x.e3, y.e3])


def qd_sub(x: QD, y: QD) -> QD:
    return qd_add(x, qd_neg(y))


def qd_mul(x: QD, y: QD) -> QD:
    """x * y: the error-free partial products up to order 3 and the order-4
    cross terms (plainly), distilled; x is the left factor of every term."""
    p00, q00 = two_prod(x.e0, y.e0)
    p01, q01 = two_prod(x.e0, y.e1)
    p10, q10 = two_prod(x.e1, y.e0)
    p02, q02 = two_prod(x.e0, y.e2)
    p11, q11 = two_prod(x.e1, y.e1)
    p20, q20 = two_prod(x.e2, y.e0)
    p03 = x.e0 * y.e3
    p12 = x.e1 * y.e2
    p21 = x.e2 * y.e1
    p30 = x.e3 * y.e0
    o4 = x.e1 * y.e3 + x.e2 * y.e2 + x.e3 * y.e1
    return _distill([p00,
                     p01, p10, q00,
                     p02, p11, p20, q01, q10,
                     p03, p12, p21, p30, q02, q11, q20,
                     o4])


def qd_mul_f64(x: QD, b) -> QD:
    """x * b with f64 b (each partial error-free)."""
    b = torch.as_tensor(b, dtype=torch.float64, device=x.e0.device)
    p0, q0 = two_prod(x.e0, b)
    p1, q1 = two_prod(x.e1, b)
    p2, q2 = two_prod(x.e2, b)
    p3 = x.e3 * b
    return _distill([p0, p1, q0, p2, q1, p3, q2])


def _qd_div_plain(x: QD, y: QD) -> QD:
    """The body of qd_div: long division (the Hida-Li-Bailey scheme), five
    quotient limbs, each from the leading limb of the running residual,
    then distilled."""
    q0 = x.e0 / y.e0
    r = qd_sub(x, qd_mul_f64(y, q0))
    q1 = r.e0 / y.e0
    r = qd_sub(r, qd_mul_f64(y, q1))
    q2 = r.e0 / y.e0
    r = qd_sub(r, qd_mul_f64(y, q2))
    q3 = r.e0 / y.e0
    r = qd_sub(r, qd_mul_f64(y, q3))
    q4 = r.e0 / y.e0
    return _distill([q0, q1, q2, q3, q4])


def qd_div(x: QD, y: QD) -> QD:
    """x / y elementwise (shapes that broadcast): _qd_div_plain on CPU
    tensors, one launch of Q5 (ops/kernels.py::qd_div_fused) on CUDA
    tensors."""
    return _kernels.qd_div_fused(x, y)


def qd_from_dd(x: DD) -> QD:
    return QD(x.hi, x.lo, torch.zeros_like(x.hi), torch.zeros_like(x.hi))


def qd_to_dd(x: QD) -> DD:
    return DD(x.e0, x.e1 + (x.e2 + x.e3))


def qd_to_float(x: QD):
    return x.e0 + (x.e1 + (x.e2 + x.e3))


def qd_sum(x: QD, axis=None) -> QD:
    """Compensated reduction by a pairwise tree (log2 K levels of qd_add):
    at each level of K terms, term i < K - ceil(K/2) is added to term
    i + ceil(K/2), and for odd K the middle term rides along unpaired.
    Over all elements, flattened, when axis is None."""
    if axis is not None:
        limbs = [torch.movedim(e, axis, 0) for e in x]
    else:
        limbs = [e.reshape(-1) for e in x]
    K = limbs[0].shape[0]
    cur = QD(*limbs)
    while K > 1:
        half = (K + 1) // 2
        lo = QD(*(e[:K - half] for e in cur))
        hi = QD(*(e[half:K] for e in cur))
        merged = qd_add(lo, hi)
        if K % 2 == 1:   # middle element rides along unpaired
            cur = QD(*(torch.cat([m, e[half - 1:half]], dim=0) for m, e in zip(merged, cur)))
        else:
            cur = merged
        K = half
    return QD(*(e[0] for e in cur))


def qd_dot(x: QD, y: QD) -> QD:
    return qd_sum(qd_mul(x, y))


# ---------------------------------------------------------------- host side
def _decimal(v) -> Decimal:
    if isinstance(v, Decimal):
        return v
    if isinstance(v, Fraction):
        return Decimal(v.numerator) / Decimal(v.denominator)
    if isinstance(v, (str, int)):
        return Decimal(v)
    return Decimal(float(v))


def qd_from_mp(v) -> tuple[float, float, float, float]:
    """Split a decimal value (a Decimal, string, int, Fraction or float)
    into four f64 limbs by repeated subtraction, at max(the context's
    precision, QD_DIGITS) decimal digits."""
    with localcontext() as ctx:
        ctx.prec = max(ctx.prec, QD_DIGITS)
        v = +_decimal(v)
        limbs = []
        for _ in range(4):
            h = float(v)
            limbs.append(h)
            v = v - Decimal(h)
    return tuple(limbs)


def qd_to_mp(e0, e1=0.0, e2=0.0, e3=0.0) -> Decimal:
    """The limb sum as a Decimal, at max(the context's precision,
    QD_DIGITS) digits."""
    with localcontext() as ctx:
        ctx.prec = max(ctx.prec, QD_DIGITS)
        return (Decimal(float(e0)) + Decimal(float(e1)) + Decimal(float(e2))
                + Decimal(float(e3)))


def qd_from_string(s: str) -> tuple[float, float, float, float]:
    return qd_from_mp(str(s))


def qd_to_string(x: QD, dps: int = 65) -> str:
    """A scalar QD rendered to `dps` significant decimal digits."""
    v = qd_to_mp(*(float(e) for e in x))
    with localcontext() as ctx:
        ctx.prec = dps
        return f"{+v:.{dps}g}"


# ------------------------------------------------------------- qd exp
def _exp_consts():
    with localcontext() as ctx:
        ctx.prec = QD_DIGITS
        ln2 = qd_from_mp(Decimal(2).ln())
        inv_fact = [qd_from_mp(Decimal(1) / Decimal(math.factorial(k))) for k in range(2, 20)]
    return ln2, inv_fact


_LN2, _INV_FACT = _exp_consts()
_EXP_FLOOR, _EXP_CEIL = -708.0, 709.0    # binary64 exp(x) range


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k from the exponent bits, k integer-valued: exact for k in [-1022,
    1023], clamped there (the lanes outside are saturated by qd_exp)."""
    e = (k.to(torch.int64).clamp(-1022, 1023) + 1023) << 52
    return e.view(torch.float64)


def _full(like: torch.Tensor, c: float) -> torch.Tensor:
    return torch.full_like(like, c)


def qd_exp(x: QD) -> QD:
    """Quad-double exponential, elementwise over any shape: range reduction
    x = k ln2 + r, r scaled by 2^-9 (exact), the 1/k! Taylor tail by Horner
    at qd precision, 9 squarings, times 2^k (exact).  Relative error ~2e-62
    for results >= ~1e-260; below that the low limbs go subnormal and the
    precision tapers to the f64 floor.  Flushes to 0 below x = -708 and to
    inf above 709 (binary64's range)."""
    k = torch.round(x.e0 / _LN2[0])
    ln2q = QD(*(_full(x.e0, c) for c in _LN2))
    r = qd_sub(x, qd_mul(qd(k), ln2q))
    scale = 1.0 / 512.0
    r = QD(r.e0 * scale, r.e1 * scale, r.e2 * scale, r.e3 * scale)   # exact
    p = QD(*(_full(x.e0, c) for c in _INV_FACT[-1]))
    for c4 in reversed(_INV_FACT[:-1]):
        p = qd_add(qd_mul(p, r), QD(*(_full(x.e0, c) for c in c4)))
    p = qd_mul(qd_mul(p, r), r)          # sum_{k>=2} r^k / k!
    p = qd_add(p, r)
    s = qd_add(p, qd(torch.ones_like(x.e0)))
    for _ in range(9):
        s = qd_mul(s, s)
    pow2 = _pow2(k)
    out = QD(s.e0 * pow2, s.e1 * pow2, s.e2 * pow2, s.e3 * pow2)   # exact
    z = torch.zeros_like(x.e0)
    sat = (x.e0 < _EXP_FLOOR) | (x.e0 > _EXP_CEIL)
    e0 = torch.where(x.e0 < _EXP_FLOOR, z,
                     torch.where(x.e0 > _EXP_CEIL, torch.full_like(z, math.inf), out.e0))
    return QD(e0, torch.where(sat, z, out.e1), torch.where(sat, z, out.e2),
              torch.where(sat, z, out.e3))


# ------------------------------------------------- ragged-array helpers
def qd_zeros(shape, device="cpu") -> QD:
    z = torch.zeros(shape, dtype=torch.float64, device=device)
    return QD(z, torch.zeros_like(z), torch.zeros_like(z), torch.zeros_like(z))


def qd_get(x: QD, idx) -> QD:
    """Limb-wise indexing / slicing: qd_get(x, (i, j)) == x[i, j]."""
    return QD(x.e0[idx], x.e1[idx], x.e2[idx], x.e3[idx])


def qd_concat(parts, axis=0) -> QD:
    return QD(*(torch.cat([torch.atleast_1d(p[i]) for p in parts], dim=axis) for i in range(4)))


def _as_mnt(x: QD) -> QD:
    """A QD (..., T) with at most two leading axes as an (M, N, T) view."""
    nd = x.e0.dim() - 1
    if nd == 0:
        return QD(*(e[None, None] for e in x))
    if nd == 1:
        return QD(*(e[None] for e in x))
    if nd == 2:
        return x
    return QD(*(e.reshape(-1, 1, e.shape[-1]) for e in x))


def qd_vdot_axis(a: QD, v: QD, axis: int) -> QD:
    """Contract one axis of a qd tensor against a qd vector (the
    np.tensordot(a, v, axes=[[axis], [0]]) pattern): the products
    qd_mul(a, v) along `axis` moved last, then qd_sum over it (the tree).
    One launch of Q4 (ops/kernels.py::qd_dot) on a CUDA tensor."""
    am = QD(*(torch.movedim(e, axis, -1) for e in a))
    lead = am.e0.shape[:-1]
    if am.e0.shape[-1] == 0:
        raise ValueError("qd_vdot_axis over an empty axis")
    vb = QD(*(e.reshape((1,) * len(lead) + (-1,)).expand(am.e0.shape) for e in v))
    out = _kernels.qd_dot(_as_mnt(am), _as_mnt(vb), tree=True)
    return QD(*(e.reshape(lead) for e in out))


def qd_matmul(a: QD, b: QD) -> QD:
    """(m, k) @ (k, n) in qd: term t = qd_mul(a[:, t], b[t, :]), the terms
    accumulated by qd_add in order t = 0, 1, ... (the JAX package's k-loop).
    One launch of Q4 (ops/kernels.py::qd_dot) on a CUDA tensor."""
    m, k = a.e0.shape
    n = b.e0.shape[1]
    if k == 0:
        return qd_zeros((m, n), a.e0.device)
    x = QD(*(e[:, None, :].expand(m, n, k) for e in a))
    y = QD(*(e.T[None].expand(m, n, k) for e in b))
    return _kernels.qd_dot(x, y, tree=False)


def qd_mag10(x: QD):
    """log10|x| from the leading limb; -inf at exact zero."""
    return torch.log10(x.e0.abs())


def qd_tt_value(cores, w) -> QD:
    """Plain quadrature contraction of a solved qd train against qd
    per-mode weights (mptt_quad, dmrggmp.f90:778-888): cores: list of QD
    (r, n_c, r'); w: list of QD (>= n_c,)."""
    v = None
    for c, G in enumerate(cores):
        M = qd_vdot_axis(G, qd_get(w[c], slice(0, G.e0.shape[1])), 1)
        v = M if v is None else qd_matmul(v, M)
    return qd_get(v, (0, 0))


# ------------------------------------------------------------ TT evaluation
def _qd_gather_tt_plain(cores, ind) -> QD:
    """The body of qd_gather_tt: v = (1), then per core the products
    qd_mul(v, (G_c[:, i_c, :], 0, 0, 0)) summed over the left rank by
    qd_sum's tree."""
    ind = torch.as_tensor(ind, device=cores[0].device).long()
    B = ind.shape[0]
    one = torch.ones((B, 1), dtype=torch.float64, device=ind.device)
    z = torch.zeros_like(one)
    v = QD(one, z, z, z)
    for c, core in enumerate(cores):
        g = core.index_select(1, ind[:, c]).movedim(1, 0)     # (B, r, r2)
        zg = torch.zeros_like(g)
        prod = qd_mul(QD(*(e[:, :, None] for e in v)), QD(g, zg, zg, zg))
        v = qd_sum(prod, axis=1)                                # (B, r2)
    return QD(*(e[:, 0] for e in v))


def qd_gather_tt(t, ind) -> QD:
    """Evaluate an f64 TT at (B, d) indices with all accumulation in qd
    (the chain of matvecs carries ~62 significant digits of the exact
    product of the stored f64 cores): the defect integrand's.  On a CUDA
    tensor one launch of Q3 (ops/kernels.py::qd_gather_tt_fused) on the
    packed train; the plain version on the CPU."""
    if torch.as_tensor(ind).device.type == "cpu":
        return _qd_gather_tt_plain(t.cores, ind)
    return _kernels.qd_gather_tt_fused(_kernels.pack_tt(t), ind)


def qd_contract(t, weights: list) -> QD:
    """Contract an f64 TT against per-mode qd weight vectors entirely in qd
    (the mptt_quad role at the ~62-digit tier): per core the products
    qd_mul((G, 0, 0, 0), w) summed over the mode by the tree, then v times
    that (r, r') matrix summed over the left rank by the tree.  Runs on the
    weights' device (two launches of Q4 per core on the card)."""
    dev = weights[0].e0.device
    v = None
    for c in range(t.d):
        g = torch.as_tensor(t.cores[c], dtype=torch.float64).to(dev)     # (r1, n, r2)
        r1, n, r2 = g.shape
        w = weights[c]
        gt = g.permute(0, 2, 1)
        zero = torch.zeros_like(g).permute(0, 2, 1)     # the limbs share gt's strides
        m = _kernels.qd_dot(QD(gt, zero, zero, zero),
                            QD(*(e[:n][None, None].expand(r1, r2, n) for e in w)),
                            tree=True)                                      # (r1, r2)
        if v is None:
            v = QD(*(e[0] for e in m))                                      # (r2,)
        else:
            v = QD(*(e[0] for e in _kernels.qd_dot(
                QD(*(e[None, None, :].expand(1, r2, r1) for e in v)),
                QD(*(e.T[None] for e in m)), tree=True)))                   # (r2,)
    return QD(*(e[0] for e in v))
