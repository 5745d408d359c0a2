"""Applications of the port: the Ising C_m / D_m / E_m integrands, the
product standard normal, the equicorrelated MVN pdf, the COS / CHF
option-pricing pipeline, and quantics problems on virtual 2^K grids."""

from .chf import basket_chf, basket_chf_pair, basket_pdf, basket_pdf_pair
from .cos import (CosCoefficients, cos_approximate, cos_approximate_pair, gaussian_chf,
                  gaussian_chf_parts, make_cos_coefficients, s_vectors)
from .ising import IsingProblem, ising_integrand, make_ising
from .mvn import (MvnDensity, MvnFamily, MvnProblem, make_mvn, make_mvn_density,
                  make_mvn_family)
from .quantics import QuanticsProblem, make_quantics, quantics_cross
from .stdnorm import StdnormProblem, make_stdnorm
from .truths import CHF_REFERENCE, CHF_RHO05, MVN_MASS, STDNORM, ising_truth

__all__ = [
    "IsingProblem", "ising_integrand", "make_ising",
    "MvnDensity", "MvnFamily", "MvnProblem", "make_mvn", "make_mvn_density", "make_mvn_family",
    "QuanticsProblem", "make_quantics", "quantics_cross",
    "StdnormProblem", "make_stdnorm",
    "CosCoefficients", "cos_approximate", "cos_approximate_pair", "gaussian_chf",
    "gaussian_chf_parts", "make_cos_coefficients", "s_vectors",
    "basket_chf", "basket_chf_pair", "basket_pdf", "basket_pdf_pair",
    "CHF_REFERENCE", "CHF_RHO05", "MVN_MASS", "STDNORM", "ising_truth",
]
