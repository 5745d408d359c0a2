"""Equicorrelated multivariate-normal pdf integrand.

Counterpart of ttcross_tpu/apps/mvn.py (mvn_pdf.f90: the lognormal-model
covariance sigma = 0.4, corr = 0.5, X0 = log 100, mvn_init at :15-60, and
the Mahalanobis-exponent pdf, :63-83).  The problem is an immutable bundle
with the inverse covariance computed on the host once; the mean, the
inverse covariance and the node table lie on the problem's device from
construction, so a call copies nothing from the host.  An integrand call
(MvnProblem.fun, MvnFamily.fun) is ops/kernels.py::mvn_pdf_fused: on the
card one launch that looks the nodes up and forms the density (kernel B's
redesign on this path), on the CPU its plain version, the JAX package's
composition of the lookup, the quadratic form and exp.

Used by the MVN probability program (test_crs_mvn.f90: mass = 1 on the
cumulant box [0.52517, 8.52517]) and by the CHF / pdf / COS pipelines.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..cross.batch import lane_batched
from ..ops.kernels import mvn_pdf_fused
from ..ops.quadrature import lgwt, map_to_interval

__all__ = ["MvnDensity", "make_mvn_density", "MvnProblem", "make_mvn",
           "MvnFamily", "make_mvn_family"]

# Cumulant-derived integration box with L = 10 (test_crs_mvn.f90:81-83)
MVN_BOX = (0.525170, 8.525170)


def _quad_form(diff, inv_cov):
    """diff_b^T inv_cov diff_b for every row b."""
    return ((diff @ inv_cov) * diff).sum(dim=1)


@dataclass(frozen=True)
class MvnDensity:
    """N(mu, cov) density with precomputed inverse covariance; mu_t,
    inv_cov_t and norm_t are mu, inv_cov and the normalisation
    sqrt((2 pi)^d det_cov) (shape (1,)) on the density's device."""

    mu: np.ndarray
    cov: np.ndarray
    inv_cov: np.ndarray
    det_cov: float
    mu_t: torch.Tensor
    inv_cov_t: torch.Tensor
    norm_t: torch.Tensor

    @property
    def d(self) -> int:
        return self.mu.shape[0]

    def pdf(self, x):
        """Batched pdf: x (B, d) tensor on the density's device -> (B,)."""
        expo = _quad_form(x - self.mu_t, self.inv_cov_t)
        norm = np.sqrt((2.0 * np.pi) ** self.d * self.det_cov)
        return torch.exp(-0.5 * expo) / norm


def density_from_numpy(mu, cov, inv_cov, det_cov: float, device,
                       dtype: torch.dtype = torch.float64) -> MvnDensity:
    mu, cov, inv_cov = (np.asarray(a, np.float64) for a in (mu, cov, inv_cov))
    norm = np.sqrt((2.0 * np.pi) ** mu.shape[0] * float(det_cov))
    return MvnDensity(mu=mu, cov=cov, inv_cov=inv_cov, det_cov=float(det_cov),
                      mu_t=torch.from_numpy(mu).to(device, dtype),
                      inv_cov_t=torch.from_numpy(inv_cov).to(device, dtype),
                      norm_t=torch.tensor([norm], dtype=torch.float64).to(device, dtype))


def make_mvn_density(d: int, r: float = 0.0, T: float = 1.0, sigma: float = 0.4,
                     corr: float = 0.5, device: str | torch.device = "cuda",
                     dtype: torch.dtype = torch.float64) -> MvnDensity:
    """Equicorrelated lognormal-model density (mvn_init, mvn_pdf.f90:15-60);
    its tensors in ``dtype`` (torch.float32: the f32 tier)."""
    X0 = np.log(100.0)
    mu = np.full(d, X0 + (r - 0.5 * sigma**2) * T)
    cov = np.full((d, d), sigma * corr * sigma * T)
    np.fill_diagonal(cov, sigma * sigma * T)
    return density_from_numpy(mu, cov, np.linalg.inv(cov), float(np.linalg.det(cov)), device,
                              dtype)


@dataclass(frozen=True)
class MvnProblem:
    """nodes / quad_weights stay host numpy; ``table`` is the (n,) node
    tensor on the problem's device."""

    d: int
    n: int
    nodes: np.ndarray
    quad_weights: np.ndarray
    density: MvnDensity
    truth: float
    table: torch.Tensor

    def fun(self, ind):
        """ind (B, d) int32 on the problem's device -> (B,) pdf values: one
        fused launch on the card (a family of one lane's arithmetic)."""
        dn = self.density
        return mvn_pdf_fused(self.table, ind, dn.mu_t, dn.inv_cov_t, dn.norm_t)


def _rule(n: int):
    if n % 2 == 0:
        n += 1
    x, w = lgwt(n)
    return (n, *map_to_interval(x, w, *MVN_BOX))


def make_mvn(d: int = 6, n: int = 65, r: float = 0.0, T: float = 1.0, sigma: float = 0.4,
             corr: float = 0.5, device: str | torch.device = "cuda",
             dtype: torch.dtype = torch.float64) -> MvnProblem:
    """``device`` places the node table and the density's parameters: the
    card unless the caller asks for ``device="cpu"`` (no fallback).
    ``dtype``: of the table and the parameters, so of the integrand's
    values (torch.float32 for cross(dtype=torch.float32); the JAX package
    takes its f32 tier from a global switch, TTCROSS_NO_X64)."""
    n, x, w = _rule(n)
    return MvnProblem(d=d, n=n, nodes=x, quad_weights=w,
                      density=make_mvn_density(d, r, T, sigma, corr, device=device, dtype=dtype),
                      truth=1.0, table=torch.from_numpy(x).to(device, dtype))


@dataclass(frozen=True)
class MvnFamily:
    """A correlation family of MVN problems: params carries per-lane
    (mu, inv_cov, norm) tensors with a leading lane axis; ``fun(ind, par)``
    is the parameterized integrand for one lane's slice of params (the
    vectorized form of the reference's `par` callback argument,
    dmrgg.f90:18), and for every lane at once with the whole params
    (cross/batch.py::cross_batch)."""

    d: int
    n: int
    nodes: np.ndarray
    quad_weights: np.ndarray
    corrs: tuple
    params: dict
    table: torch.Tensor
    truth: float = 1.0       # each lane integrates its pdf mass

    @lane_batched
    def fun(self, ind, par):
        """ind (L, B, d) int32 with the whole params -> (L, B): every lane
        in one mvn_pdf_fused launch on the card (on the CPU the lookup and
        the quadratic forms of every lane with inv_cov (L, d, d) at once,
        cross/batch.py::lane_batched).  ind (B, d) with one lane's par ->
        (B,) runs the same as a family of one, so a lane's single run does
        the lane's arithmetic."""
        if ind.dim() == 2:
            return self.fun(ind[None], {k: v[None] for k, v in par.items()})[0]
        return mvn_pdf_fused(self.table, ind.contiguous(), par["mu"], par["inv_cov"], par["norm"])

    def lane(self, i: int) -> dict:
        """The parameters of lane i."""
        return {k: v[i] for k, v in self.params.items()}


def make_mvn_family(d: int = 6, n: int = 65, corrs=(0.3, 0.5, 0.7), r: float = 0.0,
                    T: float = 1.0, sigma: float = 0.4,
                    device: str | torch.device = "cuda") -> MvnFamily:
    """Equicorrelated MVN problems across correlation values, one lane per
    corr (every lane's mass is 1 on the shared cumulant box)."""
    n, x, w = _rule(n)
    dens = [make_mvn_density(d, r, T, sigma, float(c), device="cpu") for c in corrs]
    params = {
        "mu": torch.from_numpy(np.stack([dn.mu for dn in dens])).to(device),
        "inv_cov": torch.from_numpy(np.stack([dn.inv_cov for dn in dens])).to(device),
        "norm": torch.from_numpy(np.array(
            [np.sqrt((2.0 * np.pi) ** d * dn.det_cov) for dn in dens])).to(device),
    }
    return MvnFamily(d=d, n=n, nodes=x, quad_weights=w,
                     corrs=tuple(float(c) for c in corrs), params=params,
                     table=torch.from_numpy(x).to(device))
