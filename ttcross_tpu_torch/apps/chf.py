"""Characteristic function and density of the lognormal basket sum.

Counterpart of ttcross_tpu/apps/chf.py (the complex contraction pipelines
of test_crs_chf.f90:153-168 and test_crs_pdf.f90:136-209): after crossing
the MVN pdf once, evaluate the basket-sum characteristic function

  phi_k = ztt_quad(tt, qq_k),   qq_k[p](x) = w(x) * exp(i omega_k e^x / d),
  omega_k = k pi / (upper - lower)

through complex weight tensors (the reference's dtt -> ztt promotion +
ztt_quad, dmrgg.f90:1418-1523), then reconstruct the density by the COS
method.  basket_chf contracts in complex128 on the train's device, all K
terms as one batched chain; the ``_pair`` forms carry (re, im) in real
arithmetic, so autograd differentiates them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dense import as_tensor
from ..tt.types import TT
from .cos import cos_approximate, cos_approximate_pair

__all__ = ["basket_chf", "basket_chf_pair", "basket_pdf", "basket_pdf_pair"]


def _phase_weights(t: TT, nodes, weights, n_terms: int, lower: float, upper: float):
    """weights (n,) and phase (K, n) = omega_k e^{x} / d on the train's device."""
    weights, nodes = (as_tensor(a, t.device, torch.float64) for a in (weights, nodes))
    omega = torch.arange(n_terms, dtype=torch.float64, device=t.device) * np.pi / (upper - lower)
    return weights, omega[:, None] * torch.exp(nodes)[None, :] / t.d


def basket_chf_pair(t: TT, nodes, weights, n_terms: int = 32,
                    lower: float = 0.0, upper: float = 300.0):
    """(Re phi_k, Im phi_k), each (K,), of the basket-sum CHF in real pair
    arithmetic end to end: differentiable by autograd with respect to the
    cores (and to nodes / weights given as tensors)."""
    w, phase = _phase_weights(t, nodes, weights, n_terms, lower, upper)
    wr, wi = w[None, :] * torch.cos(phase), w[None, :] * torch.sin(phase)
    vr = torch.ones((n_terms, 1, 1), dtype=torch.float64, device=t.device)
    vi = torch.zeros((n_terms, 1, 1), dtype=torch.float64, device=t.device)
    for g in t.cores:
        mr = torch.einsum("inj,kn->kij", g, wr)                # (K, r, r')
        mi = torch.einsum("inj,kn->kij", g, wi)
        vr, vi = vr @ mr - vi @ mi, vr @ mi + vi @ mr
    return vr[:, 0, 0], vi[:, 0, 0]


def basket_chf(t: TT, nodes, weights, n_terms: int = 32,
               lower: float = 0.0, upper: float = 300.0) -> torch.Tensor:
    """phi_0..phi_{K-1} of the basket sum (1/d) sum_p e^{X_p} under the
    crossed density TT (test_crs_chf.f90:153-168), a complex128 (K,) tensor
    on the train's device: the K contractions run as one batched complex
    chain with the per-mode weight matrix W (K, n)."""
    w, phase = _phase_weights(t, nodes, weights, n_terms, lower, upper)
    W = torch.complex(w[None, :] * torch.cos(phase), w[None, :] * torch.sin(phase))
    v = torch.ones((n_terms, 1, 1), dtype=torch.complex128, device=t.device)
    for g in t.cores:
        v = v @ torch.einsum("inj,kn->kij", g.to(torch.complex128), W)
    return v[:, 0, 0]


def basket_pdf_pair(t: TT, nodes, weights, xs, n_terms: int = 32,
                    lower: float = 0.0, upper: float = 300.0) -> torch.Tensor:
    """Basket-sum density through the pair chain and the pair
    reconstruction: real-valued and differentiable by autograd."""
    phir, phii = basket_chf_pair(t, nodes, weights, n_terms, lower, upper)
    return cos_approximate_pair(xs, phir, phii, lower, upper)


def basket_pdf(t: TT, nodes, weights, xs, n_terms: int = 32,
               lower: float = 0.0, upper: float = 300.0) -> torch.Tensor:
    """Density of the basket sum on points xs via CHF + COS reconstruction
    (test_crs_pdf.f90 pipeline), on the train's device."""
    phis = basket_chf(t, nodes, weights, n_terms, lower, upper)
    return cos_approximate(xs, phis, lower, upper, n_terms)
