"""Product standard-normal integrand: exp(-sum x^2) on [-10, 10]^d.

Counterpart of ttcross_tpu/apps/stdnorm.py:23-43 (test_crs_stdnorm.f90:
integrand at lines 154-170, truth pi^(d/2) at line 83).  The integrand does
not apply weights; they live in the rank-1 quad tensor (lines 100-107).
The node lookup is ops/dense.py::table_lookup: kernel B on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.dd import DD, dd, dd_add, dd_exp, dd_mul, dd_neg, dd_sum
from ..ops.dense import table_lookup
from ..ops.qd import QD, qd_exp, qd_from_mp, qd_mul, qd_neg, qd_sum
from ..ops.quadrature import gauss_legendre_dd, gauss_legendre_decimal, lgwt, map_to_interval

__all__ = ["StdnormProblem", "make_stdnorm", "StdnormDD", "stdnorm_integrand_dd",
           "stdnorm_dd_problem", "make_stdnorm_dd", "StdnormQD", "make_stdnorm_qd"]


@dataclass(frozen=True)
class StdnormProblem:
    """nodes / quad_weights stay host numpy (the problem's definition);
    ``table`` is the (n,) tensor of nodes on the problem's device,
    which the integrand reads."""

    d: int
    n: int
    nodes: np.ndarray
    quad_weights: np.ndarray
    truth: float
    table: torch.Tensor

    def fun(self, ind):
        """ind (B, d) int32 on the problem's device -> (B,) values."""
        x = table_lookup(self.table, ind)
        return torch.exp(-(x * x).sum(dim=1))


def make_stdnorm(d: int = 6, n: int = 65, a: float = -10.0, b: float = 10.0,
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float64) -> StdnormProblem:
    """``device`` places the node table: the card unless the caller asks
    for ``device="cpu"`` (no fallback); ``dtype``: the table's, so the
    integrand's values' (torch.float32 for the f32 tier)."""
    if n % 2 == 0:
        n += 1
    x, w = lgwt(n)
    x, w = map_to_interval(x, w, a, b)
    return StdnormProblem(d=d, n=n, nodes=x, quad_weights=w,
                          truth=float(np.pi) ** (d / 2),
                          table=torch.from_numpy(x).to(device, dtype))


# ------------------------------------------------------------- the dd tier
def stdnorm_integrand_dd(ind, nodes_dd) -> DD:
    """exp(-sum x^2) in double-double arithmetic via the dd exponential
    (ops/dd.py::dd_exp; ttcross_tpu/apps/stdnorm.py:45-54): plain torch dd
    operations on ind's device, no hand kernel.  nodes_dd: a DD of (n,)
    tensors on that device.  Returns DD (B,)."""
    i = ind.long()
    x = DD(nodes_dd.hi[i], nodes_dd.lo[i])     # (B, d)
    return dd_exp(dd_neg(dd_sum(dd_mul(x, x), axis=1)))


class StdnormDD:
    """fun_dd of the product-Gaussian problem: ind (B, d) int32 -> DD (B,)
    over ``nodes``, the dd nodes on the problem's device."""

    def __init__(self, nodes_dd, device):
        self.nodes = DD(*(torch.as_tensor(a, dtype=torch.float64).cpu().to(device)
                          for a in nodes_dd))

    def __call__(self, ind) -> DD:
        return stdnorm_integrand_dd(ind, self.nodes)


def stdnorm_dd_problem(nodes_dd, weights_dd, d: int, device):
    """(prob_f64, fun_dd, weights_hi, weights_lo) on a given dd rule
    (nodes_dd, weights_dd: (hi, lo) pairs of (n,) arrays on the box)."""
    xh = np.asarray(torch.as_tensor(nodes_dd[0]).cpu(), np.float64)
    wh = np.asarray(torch.as_tensor(weights_dd[0]).cpu(), np.float64)
    wl = np.asarray(torch.as_tensor(weights_dd[1]).cpu(), np.float64)
    prob = StdnormProblem(d=d, n=xh.shape[0], nodes=xh, quad_weights=wh,
                          truth=float(np.pi) ** (d / 2), table=torch.from_numpy(xh).to(device))
    return prob, StdnormDD(nodes_dd, device), [wh] * d, [wl] * d


def make_stdnorm_dd(d: int = 6, n: int = 65, a: float = -10.0, b: float = 10.0,
                    device: str | torch.device = "cuda"):
    """stdnorm problem with dd quadrature data: returns (prob_f64, fun_dd,
    weights_hi, weights_lo) for the defect pipeline, the beyond-f64 tier of
    a transcendental integrand (ttcross_tpu/apps/stdnorm.py:57-83).  The
    rule is ops/quadrature.py::gauss_legendre_dd, mapped to [a, b] in dd on
    the host; ``device`` places the tables: the card unless the caller asks
    for ``device="cpu"``."""
    if n % 2 == 0:
        n += 1
    (xh, xl), (wh, wl) = gauss_legendre_dd(n)
    half_len = dd(0.5 * (b - a))
    mid = dd(0.5 * (b + a))
    Xn = dd_add(dd_mul(DD(torch.from_numpy(xh), torch.from_numpy(xl)), half_len),
                DD(mid.hi.expand(n), mid.lo.expand(n)))
    Wn = dd_mul(DD(torch.from_numpy(wh), torch.from_numpy(wl)), half_len)
    return stdnorm_dd_problem(Xn, Wn, d, device)


# ------------------------------------------------------------- the qd tier
class StdnormQD:
    """fun_qd of the product-Gaussian problem, ind (B, d) int -> QD (B,):
    exp(-sum x^2) in qd, the sum by qd_sum's tree and the exponential by
    ops/qd.py::qd_exp, plain qd operations on the problem's device (no hand
    kernel; ttcross_tpu/apps/stdnorm.py:117-122).  Pickles as host limbs and
    the device's name."""

    def __init__(self, limbs: np.ndarray, device):
        self.limbs = np.ascontiguousarray(limbs, np.float64)
        self.device = torch.device(device)
        self.nodes = QD(*(torch.from_numpy(a).to(self.device) for a in self.limbs))

    def __getstate__(self):
        return {"limbs": self.limbs, "device": str(self.device)}

    def __setstate__(self, state):
        self.__init__(state["limbs"], state["device"])

    def __call__(self, ind) -> QD:
        i = torch.as_tensor(ind, device=self.device).long()
        x = QD(*(e[i] for e in self.nodes))                       # (B, d)
        return qd_exp(qd_neg(qd_sum(qd_mul(x, x), axis=1)))


def make_stdnorm_qd(d: int = 4, n: int = 201, a: float = -12.5, b: float = 12.5, dps: int = 80,
                    device: str | torch.device = "cuda"):
    """stdnorm problem with quad-double quadrature data for the qd cross
    engine: returns (prob_f64, fun_qd, weights_qd)
    (ttcross_tpu/apps/stdnorm.py:86-124).  The box is wider than the
    reference's [-10, 10]: int_{|x|>10} exp(-x^2) ~ 2e-45 would cap any rule
    at ~44.7 digits, [-12.5, 12.5] pushes it to ~6e-70.  The rule is
    ops/quadrature.py::gauss_legendre_decimal at dps + 20 digits, mapped to
    [a, b] and split into qd limbs; ``device`` places the tables: the card
    unless the caller asks for ``device="cpu"``."""
    from decimal import Decimal, localcontext

    if n % 2 == 0:
        n += 1
    x, w = gauss_legendre_decimal(n, dps + 20)
    with localcontext() as ctx:
        ctx.prec = dps + 20
        hl = (Decimal(repr(b)) - Decimal(repr(a))) / 2
        mid = (Decimal(repr(b)) + Decimal(repr(a))) / 2
        Xl = np.array([qd_from_mp(hl * xi + mid) for xi in x])       # (n, 4)
        Wl = np.array([qd_from_mp(wi * hl) for wi in w])
    prob = StdnormProblem(d=d, n=n, nodes=np.ascontiguousarray(Xl[:, 0]),
                          quad_weights=np.ascontiguousarray(Wl[:, 0]),
                          truth=float(np.pi) ** (d / 2),
                          table=torch.from_numpy(np.ascontiguousarray(Xl[:, 0])).to(device))
    weights_qd = [QD(*(torch.from_numpy(np.ascontiguousarray(Wl[:, k])).to(device)
                       for k in range(4)))] * d
    return prob, StdnormQD(Xl.T, device), weights_qd
