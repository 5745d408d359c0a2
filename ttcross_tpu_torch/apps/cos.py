"""Fang-Oosterlee COS method pipeline: sign vectors, Gaussian characteristic
function, COS coefficient tensors, and density reconstruction.

Counterpart of ttcross_tpu/apps/cos.py (s_vectors.f90, funcs.f90's
gaussian_chf_nd, coefficients.f90's calc_coefficient, cos_approx.f90).
Everything is a batched function closed over an immutable problem bundle
whose sign vectors, mean and covariance lie on the problem's device; the
coefficient tensor's entry evaluation is a (B, 2^(d-1), d) sweep for the
cross engine's batched integrand protocol.  The card has complex128, so
gaussian_chf returns it directly; the (re, im) pair forms stay for real
autograd.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.dense import as_tensor

__all__ = ["s_vectors", "gaussian_chf", "gaussian_chf_parts", "CosCoefficients",
           "make_cos_coefficients", "cos_approximate", "cos_approximate_pair"]


def s_vectors(d: int) -> np.ndarray:
    """All 2^(d-1) sign vectors with first component +1, shape (2^(d-1), d)
    (generate_s_vectors, s_vectors.f90:7-29)."""
    k = np.arange(2 ** (d - 1))
    bits = (k[:, None] >> np.arange(d - 1)[None, :]) & 1
    return np.concatenate([np.ones((k.size, 1), dtype=np.int64), 1 - 2 * bits], axis=1)


def gaussian_chf_parts(omega, mu, sigma, device=None):
    """Real and imaginary parts of phi(omega) = exp(i omega.mu - omega^T
    Sigma omega / 2) as (magnitude * cos, magnitude * sin), batched over
    the leading axes of omega."""
    omega = as_tensor(omega, device, torch.float64)
    mu, sigma = (as_tensor(a, omega.device, torch.float64) for a in (mu, sigma))
    dot_mu = omega @ mu
    quad = ((omega @ sigma) * omega).sum(dim=-1)
    mag = torch.exp(-0.5 * quad)
    return mag * torch.cos(dot_mu), mag * torch.sin(dot_mu)


def gaussian_chf(omega, mu, sigma, device=None):
    """phi(omega) = exp(i omega.mu - 1/2 omega^T Sigma omega) as a
    complex128 tensor, batched over the leading axes of omega
    (gaussian_chf_nd, funcs.f90:8-26)."""
    return torch.complex(*gaussian_chf_parts(omega, mu, sigma, device))


@dataclass(frozen=True)
class CosCoefficients:
    """COS coefficient tensor of a Gaussian: the black-box integrand
    crossed by test_crs_coscoeff (calc_coefficient, coefficients.f90:33-65).
    mu / sigma stay host numpy; sv_t (2^(d-1), d), mu_t and sigma_t are the
    sign vectors, the mean and the covariance on the problem's device."""

    d: int
    mu: np.ndarray
    sigma: np.ndarray
    lower: float
    upper: float
    sv_t: torch.Tensor
    mu_t: torch.Tensor
    sigma_t: torch.Tensor

    def fun(self, ind):
        """Batched entry evaluation: ind (B, d) int -> (B,) f64.

        f(ind) = 2/(b-a)^d  sum_s  Re[ e^{-i a sum_j t_j} phi(t) ],
        with t_j = pi s_j ind_j / (b - a)  (0-based ind; the reference's
        ind_j - 1 with 1-based indices, coefficients.f90:52-57), in real
        arithmetic: Re[e^{i(t.mu - a sum t)}] e^{-q/2} = e^{-q/2} cos(...)."""
        one_over = 1.0 / (self.upper - self.lower)
        t = (np.pi * one_over) * self.sv_t[None, :, :] * ind[:, None, :].to(torch.float64)
        dot_mu = t @ self.mu_t                                          # (B, S)
        quad = ((t @ self.sigma_t) * t).sum(dim=-1)
        phase = dot_mu - self.lower * t.sum(dim=-1)
        real_sum = (torch.exp(-0.5 * quad) * torch.cos(phase)).sum(dim=-1)
        return 2.0 * one_over**self.d * real_sum


def make_cos_coefficients(d: int, mu, sigma, lower: float, upper: float,
                          device: str | torch.device = "cuda") -> CosCoefficients:
    """``device`` places the sign vectors, the mean and the covariance: the
    card unless the caller asks for ``device="cpu"`` (no fallback)."""
    mu = np.asarray(mu, dtype=np.float64)
    sigma = np.asarray(sigma, dtype=np.float64)
    return CosCoefficients(
        d=d, mu=mu, sigma=sigma, lower=float(lower), upper=float(upper),
        sv_t=torch.from_numpy(s_vectors(d).astype(np.float64)).to(device),
        mu_t=torch.from_numpy(mu).to(device), sigma_t=torch.from_numpy(sigma).to(device))


def cos_approximate_pair(xs, phir, phii, lower: float, upper: float):
    """COS reconstruction from a CHF real / imaginary pair (phir, phii),
    each (K,), on their device: real-valued torch operations end to end, so
    autograd flows through the pair."""
    dev = phir.device
    xs = torch.atleast_1d(as_tensor(xs, dev, torch.float64))
    K = phir.shape[0]
    kk = torch.arange(K, dtype=torch.float64, device=dev)
    omega = kk * np.pi / (upper - lower)
    coeff = 2.0 / (upper - lower) * (phir * torch.cos(omega * lower)
                                     + phii * torch.sin(omega * lower))
    coeff = coeff * torch.where(kk == 0, 0.5, 1.0)
    return torch.cos(omega[None, :] * (xs[:, None] - lower)) @ coeff


def cos_approximate(xs, phis, lower: float, upper: float, n_terms: int | None = None,
                    device=None):
    """COS density reconstruction from characteristic-function values,
    vectorized over xs (cos_approximate_array, cos_approx.f90:88-127):

      pdf(x) = sum_{k=0}^{K-1} c_k cos(omega_k (x - a)),
      c_k = 2/(b-a) Re[phi_k e^{-i omega_k a}],  c_0 halved.

    phis: complex (K,) tensor (the result lies on its device) or numpy."""
    phis = as_tensor(phis, device, torch.complex128)
    K = phis.shape[0] if n_terms is None else n_terms
    if K > phis.shape[0]:
        raise ValueError("n_terms exceeds the number of CHF values")
    return cos_approximate_pair(xs, phis.real[:K], phis.imag[:K], lower, upper)
