"""Judge a tensor train that a cross run returned, against a plain integrand.

Plain PyTorch, float64, on whatever device the tensors lie on.  Nothing of
the program is imported: the train's cores, its pivots (vip, rk) and its
reported integral are the program's outputs, read here only to be judged.

A cross interpolant reproduces the integrand at its own cross points: for
core k, every point (I_{k-1}[s], i, J_k[t]) of the left pivot prefixes, any
index of mode k, and the right pivot suffixes.  ``interp_gap`` evaluates the
train there and compares it with the reference integrand; ``contract``
integrates the train against the reference's quadrature weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["pivot_sets", "interp_gap", "contract"]


def pivot_sets(vip, rk, bonds):
    """The left prefixes I[b] (rk[b+1], b+1) and right suffixes J[b]
    (rk[b+1], d-b-1) of the pivots at each bond in ``bonds``, as int64
    numpy.  vip[b, s] = (row of I[b-1] it extends, its index of mode b, its
    index of mode b+1, row of J[b+1] it extends): the sets are nested, so
    each is one gather from its neighbour."""
    vip, rk = np.asarray(vip, np.int64), np.asarray(rk, np.int64)
    nb = vip.shape[0]
    bonds = set(int(b) for b in bonds)
    I, J = {}, {}
    prev = np.zeros((1, 0), np.int64)
    for b in range(nb):
        r = int(rk[b + 1])
        prev = np.concatenate([prev[vip[b, :r, 0]], vip[b, :r, 1:2]], axis=1)
        if b in bonds:
            I[b] = prev
    nxt = np.zeros((1, 0), np.int64)
    for b in range(nb - 1, -1, -1):
        r = int(rk[b + 1])
        nxt = np.concatenate([vip[b, :r, 2:3], nxt[vip[b, :r, 3]]], axis=1)
        if b in bonds:
            J[b] = nxt
    return I, J


def _interfaces(cores, vip, rk):
    """The train's prefix products at every bond's left pivots, left[b]
    (rk[b+1], rk[b+1]), and its suffix products at every bond's right
    pivots, right[b] (rk[b+1], rk[b+1]); both by the nesting of the sets."""
    d = len(cores)
    vip = torch.as_tensor(np.asarray(vip, np.int64))
    left, right = [None] * (d - 1), [None] * (d - 1)
    dev = cores[0].device
    cur = torch.ones((1, 1), dtype=torch.float64, device=dev)
    for b in range(d - 1):
        r = int(rk[b + 1])
        par, idx = vip[b, :r, 0].to(dev), vip[b, :r, 1].to(dev)
        g = cores[b].to(torch.float64)[:, idx, :].transpose(0, 1)        # (r, rl, rr)
        cur = torch.einsum("sa,sab->sb", cur[par], g)
        left[b] = cur
    cur = torch.ones((1, 1), dtype=torch.float64, device=dev)
    for b in range(d - 2, -1, -1):
        r = int(rk[b + 1])
        idx, par = vip[b, :r, 2].to(dev), vip[b, :r, 3].to(dev)
        g = cores[b + 1].to(torch.float64)[:, idx, :].transpose(0, 1)    # (r, rl, rr)
        cur = torch.einsum("sab,sb->sa", g, cur[par])
        right[b] = cur
    return left, right


def interp_gap(cores, vip, rk, fun, check_cores=None, block: int = 1 << 14):
    """The widest gap between the train and the reference integrand at the
    train's cross points, over the cores in ``check_cores`` (all if None):
    per core, max |train - f| over its points divided by max |f| there.

    cores: the train's (r_k, n_k, r_k+1) cores; vip, rk: its pivots as the
    program reports them (numpy or tensors); fun: the reference integrand,
    ind (B, d) int64 tensor -> (B,) float64."""
    d = len(cores)
    rk = [int(x) for x in np.asarray(rk)]
    ks = range(d) if check_cores is None else sorted(set(int(k) for k in check_cores))
    I, J = pivot_sets(vip, rk, [k - 1 for k in ks if k > 0] + [k for k in ks if k < d - 1])
    left, right = _interfaces(cores, vip, rk)
    dev = cores[0].device
    worst = 0.0
    for k in ks:
        g = cores[k].to(torch.float64)
        n = g.shape[1]
        Lv = left[k - 1] if k > 0 else torch.ones((1, 1), dtype=torch.float64, device=dev)
        Rv = right[k] if k < d - 1 else torch.ones((1, 1), dtype=torch.float64, device=dev)
        tt = torch.einsum("sa,anb,tb->snt", Lv, g, Rv).reshape(-1)
        Il = torch.as_tensor(I[k - 1] if k > 0 else np.zeros((1, 0), np.int64), device=dev)
        Jr = torch.as_tensor(J[k] if k < d - 1 else np.zeros((1, 0), np.int64), device=dev)
        S, T = Il.shape[0], Jr.shape[0]
        f = torch.empty(S * n * T, dtype=torch.float64, device=dev)
        flat = torch.arange(S * n * T, device=dev)
        for lo in range(0, S * n * T, block):
            q = flat[lo:lo + block]
            s, rest = q // (n * T), q % (n * T)
            i, t = rest // T, rest % T
            ind = torch.cat([Il[s], i[:, None], Jr[t]], dim=1)
            f[lo:lo + block] = fun(ind)
        scale = float(f.abs().max())
        gap = float((tt - f).abs().max()) / scale if scale > 0 else math.inf
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def contract(cores, weights) -> float:
    """sum over every index of the train times the product of the per-mode
    weights (weights: one (n_k,) float64 vector per mode), with the running
    vector renormalised by a power of two per core so that a long chain
    neither underflows nor overflows."""
    dev = cores[0].device
    v = torch.ones(1, dtype=torch.float64, device=dev)
    exp2 = 0
    for g, w in zip(cores, weights):
        w = torch.as_tensor(np.asarray(w, np.float64), device=dev)
        v = torch.einsum("a,anb,n->b", v, g.to(torch.float64), w)
        top = float(v.abs().max())
        if top == 0.0 or not math.isfinite(top):
            return top
        e = math.frexp(top)[1]
        v = v * 2.0 ** -e
        exp2 += e
    return math.ldexp(float(v[0]), exp2)
