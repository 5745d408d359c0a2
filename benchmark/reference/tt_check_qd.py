"""Judge a quad-double (or double-double) tensor train in decimal.

tt_check.py's two numbers at a precision no float64 check reaches: a core's
entries are given as limbs (numpy arrays of one shape, the leading limb
first: four for qd, two for dd), and each entry becomes one Decimal, the
limbs' exact sum (as an integer times a power of two) rounded once to the
reference's PREC digits.  The arithmetic is decimal's at PREC digits, on
numpy object arrays.  Nothing of the program is imported: the limbs, the
pivots (vip, rk) and the reported value are the program's outputs, read here
only to be judged.

``interp_gap`` evaluates the train at a core's cross points (left pivot
prefixes x the mode x right pivot suffixes, tt_check.pivot_sets) and compares
it with the reference integrand there.  A point's train value is
left[s] . core[:, i, :] . right[t]; the points come in rows (s, i) of every
t.  Where a core's rows cost more multiplications than ``budget``, a sample
of its rows drawn by ``rng`` is checked, as many as the budget pays for.
``contract`` integrates the train against the reference's quadrature weights.
"""

from __future__ import annotations

from decimal import Context, Decimal, localcontext

import numpy as np

from .ising_c4_qd import PREC
from .tt_check import pivot_sets

__all__ = ["to_decimal", "interp_gap", "contract"]


def to_decimal(limbs) -> np.ndarray:
    """Limb arrays of one shape -> an object array of Decimals of that
    shape, each the limbs' exact sum rounded once to PREC digits."""
    limbs = [np.asarray(x, np.float64) for x in limbs]
    shape = limbs[0].shape
    parts = []
    for x in limbs:
        m, e = np.frexp(x.reshape(-1))
        parts.append(((m * 2.0 ** 53).astype(np.int64).tolist(), (e - 53).tolist()))
    ctx = Context(prec=PREC)
    out = np.empty(len(parts[0][0]), dtype=object)
    for k in range(out.size):
        terms = [(m[k], e[k]) for m, e in parts if m[k]]
        if not terms:
            out[k] = Decimal(0)
            continue
        lo = min(e for _, e in terms)
        total = sum(m << (e - lo) for m, e in terms)
        out[k] = (ctx.divide(Decimal(total), Decimal(1 << -lo)) if lo < 0
                  else ctx.plus(Decimal(total << lo)))
    return out.reshape(shape)


def _interfaces(cores, vip, rk):
    """The train's prefix products at each bond's left pivots, left[b]
    (rk[b+1], rk[b+1]), and its suffix products at each bond's right
    pivots, right[b] (rk[b+1], rk[b+1]), by the nesting of the sets."""
    d = len(cores)
    left, right = [None] * (d - 1), [None] * (d - 1)
    cur = np.array([[Decimal(1)]], dtype=object)
    for b in range(d - 1):
        r = int(rk[b + 1])
        par, idx = vip[b, :r, 0], vip[b, :r, 1]
        cur = np.stack([cur[p].dot(cores[b][:, i, :]) for p, i in zip(par, idx)])
        left[b] = cur
    cur = np.array([[Decimal(1)]], dtype=object)
    for b in range(d - 2, -1, -1):
        r = int(rk[b + 1])
        idx, par = vip[b, :r, 2], vip[b, :r, 3]
        cur = np.stack([cores[b + 1][:, i, :].dot(cur[p]) for i, p in zip(idx, par)])
        right[b] = cur
    return left, right


def interp_gap(cores, vip, rk, fun, rng=None, budget: int | None = None) -> float:
    """The widest gap between the train and the reference integrand at the
    train's cross points, over every core: per core, max |train - f| over
    its checked points divided by max |f| there.

    cores: the train's (r_k, n_k, r_k+1) cores as to_decimal gives them;
    vip (d-1, R, 4), rk: its pivots as the program reports them; fun: the
    reference integrand, ind (B, d) ints -> B Decimals; budget: the
    multiplications a core may take (None: every point), rng the draw of
    the rows where it does not pay for all."""
    d = len(cores)
    vip = np.asarray(vip, np.int64)
    rk = [int(x) for x in np.asarray(rk)]
    I, J = pivot_sets(vip, rk, range(d - 1))
    worst = 0.0
    with localcontext() as ctx:
        ctx.prec = PREC
        left, right = _interfaces(cores, vip, rk)
        one = np.array([[Decimal(1)]], dtype=object)
        for k in range(d):
            g = cores[k]
            a, n, b = g.shape
            Lv = left[k - 1] if k > 0 else one
            Rv = right[k] if k < d - 1 else one
            Il = I[k - 1] if k > 0 else np.zeros((1, 0), np.int64)
            Jr = J[k] if k < d - 1 else np.zeros((1, 0), np.int64)
            S, T = Il.shape[0], Jr.shape[0]
            rows = S * n
            per_row = a * b + T * b
            if budget is not None and rows * per_row > budget:
                pick = np.sort(rng.choice(rows, size=max(1, budget // per_row), replace=False))
            else:
                pick = np.arange(rows)
            top = diff = Decimal(0)
            for q in pick.tolist():
                s, i = divmod(q, n)
                u = Lv[s].dot(g[:, i, :])
                tt = Rv.dot(u)
                ind = np.concatenate([np.repeat(Il[s:s + 1], T, axis=0),
                                      np.full((T, 1), i, np.int64), Jr], axis=1)
                for v, f in zip(tt.tolist(), fun(ind)):
                    top = max(top, abs(f))
                    diff = max(diff, abs(v - f))
            gap = diff / top if top > 0 else Decimal("Infinity")
            worst = max(worst, float(gap))
    return worst


def contract(cores, weights) -> Decimal:
    """sum over every index of the train times the product of the per-mode
    weights (one sequence of n_k Decimals per mode), at PREC digits."""
    with localcontext() as ctx:
        ctx.prec = PREC
        v = np.array([Decimal(1)], dtype=object)
        for g, w in zip(cores, weights):
            w = np.asarray(list(w), dtype=object)
            v = v.dot(g.transpose(0, 2, 1).dot(w))
        return v[0]
