"""Ising susceptibility integrands C_m / D_m / E_m.

Counterpart of ttcross_tpu/apps/ising.py (:50-138, :395-466), itself the
batched form of dfunc_ising_discr (test_crs_ising.f90:176-218).  With node
values x_1..x_d and prefix products P_0..P_d (P_0 = 1), the a-term
prod_{i<j} ((P_j - P_i)/(P_j + P_i))^2 is a masked pairwise reduction and
the b-term 1/(v w) uses sums of prefix and suffix products.  The integrand
multiplies the per-dimension quadrature weights itself; the rank-1 quad
tensor carries the rescaling factor 1/val (test_crs_ising.f90:134-144).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..cross.chain_eval import ChainSpec
from ..ops.dd import DD, dd, dd_add, dd_mul
from ..ops.kernels import (ISING_KINDS, ising_c_integrand_dd_fused, ising_c_integrand_qd_fused,
                           ising_integrand_fused, small_table_lookup)
from ..ops.qd import QD, qd_from_mp
from ..ops.quadrature import gauss_legendre_dd, gauss_legendre_decimal, lgwt

__all__ = ["IsingProblem", "make_ising", "ising_integrand", "ising_integrand_np", "ising_c_chain",
           "IsingDD", "ising_c_integrand_dd", "ising_dd_problem", "make_ising_dd",
           "IsingQD", "ising_c_integrand_qd", "make_ising_qd", "IsingMP", "make_ising_mp"]


def ising_integrand(ind, tables, kind: str):
    """Batched Ising integrand: ind (B, d) int32 -> (B,) values.

    tables (2, n): the nodes and the rescaled weights.  kind 'C' -> 2b,
    'D' -> 2ab, 'E' -> 2a, each times the product of weights.  On CUDA one
    fused kernel does the lookup and the whole chain (ops/kernels.py::
    ising_integrand_fused); on the CPU its plain version runs."""
    return ising_integrand_fused(tables, ind, kind)


def ising_integrand_np(ind, nodes, weights, kind: str) -> np.ndarray:
    """Host-numpy twin of ising_integrand: ind (B, d) int -> (B,) f64, the
    JAX package's ising_integrand_np (ttcross_tpu/apps/ising.py:141).  A
    correctly rounded host integrand for cross(host_reeval=prob.fun_np) and
    cross/skeleton.py::reevaluate_host."""
    kid = ISING_KINDS[kind.upper()]
    ind = np.asarray(ind)
    x = np.asarray(nodes)[ind]       # (B, d)
    w = np.asarray(weights)[ind]
    B, d = x.shape
    f = np.full(B, 2.0)
    if kid in (2, 3):  # a-term: prod_{i<j} ((P_j - P_i)/(P_j + P_i))^2
        P = np.concatenate([np.ones((B, 1)), np.cumprod(x, axis=1)], axis=1)
        num = P[:, None, :] - P[:, :, None]
        den = P[:, None, :] + P[:, :, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(den == 0, 0.0, num / den) ** 2
        iu = np.triu(np.ones((d + 1, d + 1), dtype=bool), k=1)
        f = f * np.prod(np.where(iu[None], ratio, 1.0), axis=(1, 2))
    if kid in (1, 2):  # b-term: 1 / ((1 + sum suffix prods)(1 + sum prefix prods))
        v = 1.0 + np.cumprod(x[:, ::-1], axis=1).sum(axis=1)
        wv = 1.0 + np.cumprod(x, axis=1).sum(axis=1)
        f = f / (v * wv)
    return f * np.prod(w, axis=1)


def ising_c_chain(tables) -> ChainSpec:
    """ChainSpec (cross/chain_eval.py) of the C-kind integrand: the value
    2/(v w) prod W (the b-term only) factors through the monoid

        (P, A, Q, W):  P = prod x_i             (block node product)
                       A = sum_k prod_{i<=k} x_i   (prefix-product sums)
                       Q = sum_k prod_{i>=k} x_i   (suffix-product sums)
                       W = prod W_i             (block weight product)

    with merge (L, R) -> (P_L P_R, A_L + P_L A_R, Q_R + P_R Q_L, W_L W_R)
    and finalize 2W / ((1 + A)(1 + Q)).  Nodes lie in [0, 1] and the
    max-normalized weights are <= 1, so every partial is bounded by 1.  The
    a-term of D and E needs all prefix values, not an O(1) state, so only
    kind C has a spec.

    tables (2, n): the nodes and the weights on the problem's device.  lift
    looks both up with ONE small-table lookup (kernel B on the card) on
    the index reshaped to two dimensions, a view where it is contiguous."""
    def identity():
        return dict(P=1.0, A=0.0, Q=0.0, W=1.0)

    def lift(dims, idx):
        del dims  # the mode tables are uniform on the Ising grid
        ind = idx.to(torch.int32).contiguous()      # both free for a contiguous int32 index
        ind = ind.reshape(1, -1) if ind.dim() < 2 else ind.reshape(-1, ind.shape[-1])
        x, w = small_table_lookup(tables, ind).reshape((2,) + idx.shape)
        return dict(P=x, A=x, Q=x, W=w)

    def merge(a, b):
        return dict(P=a["P"] * b["P"],
                    A=a["A"] + a["P"] * b["A"],
                    Q=b["Q"] + b["P"] * a["Q"],
                    W=a["W"] * b["W"])

    def finalize(s):
        return 2.0 * s["W"] / ((1.0 + s["A"]) * (1.0 + s["Q"]))

    return ChainSpec(identity, lift, merge, finalize)


@dataclass(frozen=True)
class IsingProblem:
    """Problem bundle: batched integrand, rank-1 quad weights, truth.

    nodes/weights/quad_weights stay host numpy (they are the problem's
    definition); ``tables`` is the (2, n) tensor of nodes and weights on
    the problem's device (float64, or float32 for the f32 tier), which the
    integrand reads."""

    kind: str
    m: int                    # integral index (C_m / D_m / E_m)
    d: int                    # TT dimension = m - 1
    n: int                    # quadrature size (odd)
    nodes: np.ndarray         # (n,) Gauss-Legendre nodes mapped to [0, 1]
    weights: np.ndarray       # (n,) rescaled weights applied by the integrand
    quad_weights: np.ndarray  # (n,) per-mode entries of the rank-1 quad tensor
    tables: torch.Tensor      # (2, n) nodes and weights on the device
    truth: float | None = None
    rescale: bool = field(default=False)

    def fun(self, ind):
        return ising_integrand(ind, self.tables, self.kind)

    def fun_np(self, ind):
        """The host-numpy twin of fun: ind (B, d) int numpy -> (B,) f64."""
        return ising_integrand_np(ind, self.nodes, self.weights, self.kind)

    @functools.cached_property
    def chain(self):
        """ChainSpec for O(1) hunt-candidate evaluation, kind C only (None
        otherwise); pass it as cross(..., chain=prob.chain)."""
        if self.kind.upper() != "C":
            return None
        return ising_c_chain(self.tables)


def _tables(nodes, weights, device, dtype=torch.float64) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.asarray(nodes, np.float64),
                                      np.asarray(weights, np.float64)])).to(device, dtype)


def make_ising(kind: str = "C", m: int = 6, n: int = 65,
               device: str | torch.device = "cuda",
               dtype: torch.dtype = torch.float64) -> IsingProblem:
    """Build the discretized Ising problem exactly as the reference's test
    program does (test_crs_ising.f90:102-144): Gauss-Legendre on [0, 1] with the
    measure normalization, underflow rescaling for D/E with m >= 10, and
    max-weight normalization for m >= 32.  ``device`` places the tables:
    the card unless the caller asks for ``device="cpu"`` (no fallback).
    ``dtype``: the tables', so the integrand's values' (torch.float32 for
    cross(dtype=torch.float32): the fused kernel's f32 instantiation; the
    JAX package takes its f32 tier from TTCROSS_NO_X64)."""
    from .truths import ising_truth

    kind = kind.upper()
    if kind not in ISING_KINDS:
        raise ValueError(f"unknown Ising integral kind: {kind}")
    if n % 2 == 0:
        n += 1  # the reference adjusts even n (test_crs_ising.f90:40)
    d = m - 1
    x, w = lgwt(n)
    w = 0.5 * w                 # make it a measure on [0,1]
    x = (x + 1.0) / 2.0         # [-1,1] -> [0,1]
    rescale = kind in ("D", "E") and m >= 10
    val = 5.0 * (n // 2) if rescale else float(n // 2)
    if m >= 32:
        # long chains: normalizing by the max weight bounds every weight
        # product by 1 (ttcross_tpu/apps/ising.py:443-455)
        val = float(1.0 / np.max(w))
        rescale = True
    weights = w * val
    quad_weights = np.full(n, 1.0 / val)
    try:
        truth = ising_truth(kind, m)
    except KeyError:
        truth = None
    return IsingProblem(kind=kind, m=m, d=d, n=n, nodes=x, weights=weights,
                        quad_weights=quad_weights,
                        tables=_tables(x, weights, device, dtype), truth=truth,
                        rescale=rescale)


# ------------------------------------------------------------- the dd tier
def _dd_tables(nodes_dd, weights_dd, device) -> torch.Tensor:
    """(4, n) f64 on `device`: node hi, node lo, weight hi, weight lo."""
    return torch.stack([torch.as_tensor(a, dtype=torch.float64).cpu()
                        for a in (nodes_dd[0], nodes_dd[1], weights_dd[0], weights_dd[1])]
                       ).to(device)


def ising_c_integrand_dd(ind, nodes_dd, weights_dd) -> DD:
    """C-kind Ising integrand in double-double arithmetic on ind's device:
    f = 2/(v w) prod_i W_i with the telescoping prefix / suffix product
    sums computed as dd scans (ttcross_tpu/apps/ising.py:172-210).
    nodes_dd, weights_dd: (hi, lo) pairs of (n,) arrays.  On the card one
    launch of ops/kernels.py::ising_c_integrand_dd_fused (D2); on the CPU
    its plain version.  Returns DD (B,)."""
    return ising_c_integrand_dd_fused(_dd_tables(nodes_dd, weights_dd, ind.device), ind)


class IsingDD:
    """fun_dd of the C-kind Ising problem, ind (B, d) int32 -> DD (B,):
    D2 on the card (its plain version on the CPU) over ``tables``, the
    (4, n) dd nodes and weights on the problem's device."""

    def __init__(self, nodes_dd, weights_dd, device):
        self.tables = _dd_tables(nodes_dd, weights_dd, device)

    def __call__(self, ind) -> DD:
        return ising_c_integrand_dd_fused(self.tables, ind)


def ising_dd_problem(nodes_dd, weights_dd, m: int, device):
    """(prob_f64, fun_dd, weights_hi, weights_lo) of the C-kind Ising
    problem on a given dd rule: nodes_dd (Xn) on [0, 1] and weights_dd
    (Wn) already rescaled, (hi, lo) pairs of (n,) arrays.  The f64
    problem's tables are the hi parts, so the f64 cross of the defect
    pipeline approximates the same dd-sampled tensor to f64."""
    from .truths import ising_truth

    xh = np.asarray(torch.as_tensor(nodes_dd[0]).cpu(), np.float64)
    wh = np.asarray(torch.as_tensor(weights_dd[0]).cpu(), np.float64)
    n, d = xh.shape[0], m - 1
    val = float(n // 2)
    quad_weights = np.full(n, 1.0 / val)
    try:
        truth = ising_truth("C", m)
    except KeyError:
        truth = None
    prob = IsingProblem(kind="C", m=m, d=d, n=n, nodes=xh, weights=wh,
                        quad_weights=quad_weights, tables=_tables(xh, wh, device), truth=truth)
    return prob, IsingDD(nodes_dd, weights_dd, device), [quad_weights] * d, [np.zeros(n)] * d


def make_ising_dd(m: int = 6, n: int = 65, device: str | torch.device = "cuda"):
    """Ising C_m problem with dd quadrature data: returns (prob_f64,
    fun_dd, weights_hi, weights_lo) for cross_dd and the defect pipeline
    (ttcross_tpu/apps/ising.py:213-243).  The rule is
    ops/quadrature.py::gauss_legendre_dd, mapped to [0, 1] and rescaled in
    dd on the host; ``device`` places the tables: the card unless the
    caller asks for ``device="cpu"``."""
    if n % 2 == 0:
        n += 1
    (xh, xl), (wh, wl) = gauss_legendre_dd(n)
    half = dd(0.5)
    Xn = dd_mul(dd_add(DD(torch.from_numpy(xh), torch.from_numpy(xl)), dd(1.0)), half)
    Wn = dd_mul(DD(torch.from_numpy(wh), torch.from_numpy(wl)), dd(0.5 * float(n // 2)))
    return ising_dd_problem(Xn, Wn, m, device)


# ------------------------------------------------------------- the qd tier
def _qd_tables(nodes_qd, weights_qd) -> np.ndarray:
    """(8, n) float64 host array: node limbs e0..e3, then weight limbs."""
    return np.stack([np.asarray(torch.as_tensor(a).cpu(), np.float64)
                     for a in (*nodes_qd, *weights_qd)])


def ising_c_integrand_qd(ind, nodes_qd, weights_qd) -> QD:
    """C-kind Ising integrand in quad-double arithmetic (~62 digits) on
    ind's device: the telescoping prefix / suffix product sums as qd scans,
    2 / (v w) by qd_div, then the weight product
    (ttcross_tpu/apps/ising.py:246-278).  nodes_qd, weights_qd: QDs (or
    4-tuples of arrays) of (n,) limbs.  On the card one launch of
    ops/kernels.py::ising_c_integrand_qd_fused (Q1); on the CPU its plain
    version.  Returns QD (B,)."""
    tables = torch.from_numpy(_qd_tables(nodes_qd, weights_qd)).to(ind.device)
    return ising_c_integrand_qd_fused(tables, ind)


class IsingQD:
    """fun_qd of the C-kind Ising problem, ind (B, d) int -> QD (B,): Q1 on
    the card (its plain version on the CPU) over ``tables``, the (8, n) qd
    nodes and weights on the problem's device.  A module-level class, so it
    pickles (as host limbs and the device's name) into the spawned workers
    of parallel/engine_qd.py::cross_qd_parallel, which place the tables
    again on their own card."""

    def __init__(self, limbs: np.ndarray, device):
        self.limbs = np.ascontiguousarray(limbs, np.float64)
        self.device = torch.device(device)
        self.tables = torch.from_numpy(self.limbs).to(self.device)

    def __getstate__(self):
        return {"limbs": self.limbs, "device": str(self.device)}

    def __setstate__(self, state):
        self.__init__(state["limbs"], state["device"])

    def __call__(self, ind) -> QD:
        ind = torch.as_tensor(ind, device=self.device)
        if ind.device.type == "cuda":
            ind = ind.to(torch.int32)
        return ising_c_integrand_qd_fused(self.tables, ind)


def make_ising_qd(m: int = 6, n: int = 65, dps: int = 80, device: str | torch.device = "cuda"):
    """Ising C_m problem with quad-double quadrature data: returns
    (prob_f64, fun_qd, weights_qd) for cross_qd and the qd defect pipeline
    (ttcross_tpu/apps/ising.py:281-323).  The rule is
    ops/quadrature.py::gauss_legendre_decimal at dps + 20 digits, mapped to
    [0, 1] and split into qd limbs at max(dps, 80) digits; the f64
    problem's nodes and weights are the leading limbs, so its cross
    approximates the same qd-sampled tensor to f64.  ``device`` places the
    tables and the weights: the card unless the caller asks for
    ``device="cpu"``."""
    from decimal import Decimal, localcontext

    from .truths import ising_truth

    if n % 2 == 0:
        n += 1
    d = m - 1
    x, w = gauss_legendre_decimal(n, dps + 20)
    val = n // 2
    with localcontext() as ctx:
        ctx.prec = dps + 20
        Xl = np.array([qd_from_mp((xi + 1) / 2) for xi in x])            # (n, 4)
        Wl = np.array([qd_from_mp(wi * val / 2) for wi in w])
        wq = qd_from_mp(Decimal(1) / val)
    fun_qd = IsingQD(np.concatenate([Xl.T, Wl.T]), device)
    quad_weights = np.full(n, 1.0 / val)    # 1/(n//2) is exact in f64
    prob = IsingProblem(kind="C", m=m, d=d, n=n, nodes=np.ascontiguousarray(Xl[:, 0]),
                        weights=np.ascontiguousarray(Wl[:, 0]), quad_weights=quad_weights,
                        tables=_tables(Xl[:, 0], Wl[:, 0], device), truth=ising_truth("C", m))
    weights_qd = [QD(*(torch.full((n,), c, dtype=torch.float64, device=device) for c in wq))] * d
    return prob, fun_qd, weights_qd


# ------------------------------------------------------------- the mp tier
class IsingMP:
    """fun_mp of make_ising_mp: ind (B, d) int -> (B,) object array of mpf,
    the reference's dfunc_ising_discr (test_crs_ising.f90:176-218) in mpmath
    arithmetic at `dps` digits, on the host (the mp tier never uses the
    card).  The JAX package's fun_mp is a closure that its forked workers
    inherit; this one is a module-level class holding the kind, d, dps and
    the mpf nodes and weights, so it pickles into the spawned workers of
    parallel/engine_mp.py::cross_mp_parallel."""

    def __init__(self, kind: str, d: int, dps: int, nodes, weights):
        self.kind, self.d, self.dps = kind, int(d), int(dps)
        self.nodes, self.weights = nodes, weights

    def __call__(self, ind):
        from mpmath import mpf

        from ..ops.mp import workdps

        kid, d, nodes, weights = ISING_KINDS[self.kind], self.d, self.nodes, self.weights
        ind = np.asarray(ind)
        with workdps(self.dps):
            out = np.empty(ind.shape[0], dtype=object)
            for t in range(ind.shape[0]):
                xs = [nodes[ind[t, s]] for s in range(d)]
                f = mpf(2)
                if kid in (2, 3):  # a-term: prod_{i<j} ((u-1)/(u+1))^2
                    P = [mpf(1)]
                    for v in xs:
                        P.append(P[-1] * v)
                    a = mpf(1)
                    for i in range(d + 1):
                        for j in range(i + 1, d + 1):
                            ratio = (P[j] - P[i]) / (P[j] + P[i])
                            a *= ratio * ratio
                    f *= a
                if kid in (1, 2):  # b-term: 2/(v w)
                    pre = mpf(1)
                    wsum = mpf(1)
                    for v in xs:
                        pre *= v
                        wsum += pre
                    suf = mpf(1)
                    vsum = mpf(1)
                    for v in reversed(xs):
                        suf *= v
                        vsum += suf
                    f /= vsum * wsum
                for s in range(d):
                    f *= weights[ind[t, s]]
                out[t] = f
            return out


def make_ising_mp(kind: str = "C", m: int = 4, n: int = 33, dps: int = 120):
    """Ising problem at arbitrary precision (the test_mpf_ising role, the
    data plane of mptt_dmrgg; ttcross_tpu/apps/ising.py:326-427): the mp
    Gauss-Legendre rule on [0, 1], the mp integrand, mp rank-1 quad weights,
    the mp truth.  Host code, no device.

    Returns (d, n, fun_mp, quad_w, truth_mp); fun_mp is an IsingMP."""
    from mpmath import mpf

    from ..ops.mp import mp_lgwt, workdps
    from .truths import ising_truth_mp

    kind = kind.upper()
    if kind not in ISING_KINDS:
        raise ValueError(f"unknown Ising integral kind: {kind}")
    if n % 2 == 0:
        n += 1
    d = m - 1
    with workdps(dps):
        x, w = mp_lgwt(n, dps)
        half = mpf(1) / 2
        nodes = np.array([(xi + 1) * half for xi in x], dtype=object)
        val = mpf(n // 2)
        weights = np.array([wi * half * val for wi in w], dtype=object)
        quad_w = np.array([1 / val] * n, dtype=object)
        try:
            truth = ising_truth_mp(kind, m, dps)
        except KeyError:
            truth = None
    return d, n, IsingMP(kind, d, dps, nodes, weights), [quad_w] * d, truth
