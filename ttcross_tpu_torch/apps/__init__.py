"""Applications of the port: the Ising C_m / D_m / E_m integrands, the
product standard normal, the equicorrelated MVN pdf, the COS / CHF
option-pricing pipeline, quantics problems on virtual 2^K grids, the dd
tier's problems (make_ising_dd, make_stdnorm_dd), the qd tier's
(make_ising_qd, make_stdnorm_qd) and the mp tier's (make_ising_mp, host
only)."""

from .chf import basket_chf, basket_chf_pair, basket_pdf, basket_pdf_pair
from .cos import (CosCoefficients, cos_approximate, cos_approximate_pair, gaussian_chf,
                  gaussian_chf_parts, make_cos_coefficients, s_vectors)
from .ising import (IsingDD, IsingMP, IsingProblem, IsingQD, ising_c_integrand_dd,
                    ising_c_integrand_qd, ising_dd_problem, ising_integrand, make_ising,
                    make_ising_dd, make_ising_mp, make_ising_qd)
from .mvn import (MvnDensity, MvnFamily, MvnProblem, make_mvn, make_mvn_density,
                  make_mvn_family)
from .quantics import QuanticsProblem, make_quantics, quantics_cross
from .stdnorm import (StdnormDD, StdnormProblem, StdnormQD, make_stdnorm, make_stdnorm_dd,
                      make_stdnorm_qd, stdnorm_dd_problem, stdnorm_integrand_dd)
from .truths import (CHF_REFERENCE, CHF_RHO05, ISING_C_STR, ISING_DE_STR, LOG2_STR, MVN_MASS,
                     STDNORM, TPI_STR, ZETA3_STR, ising_truth, ising_truth_mp, ising_truth_str)

__all__ = [
    "IsingProblem", "ising_integrand", "make_ising",
    "IsingDD", "ising_c_integrand_dd", "ising_dd_problem", "make_ising_dd",
    "IsingQD", "ising_c_integrand_qd", "make_ising_qd", "IsingMP", "make_ising_mp",
    "MvnDensity", "MvnFamily", "MvnProblem", "make_mvn", "make_mvn_density", "make_mvn_family",
    "QuanticsProblem", "make_quantics", "quantics_cross",
    "StdnormProblem", "make_stdnorm",
    "StdnormDD", "make_stdnorm_dd", "stdnorm_dd_problem", "stdnorm_integrand_dd",
    "StdnormQD", "make_stdnorm_qd",
    "CosCoefficients", "cos_approximate", "cos_approximate_pair", "gaussian_chf",
    "gaussian_chf_parts", "make_cos_coefficients", "s_vectors",
    "basket_chf", "basket_chf_pair", "basket_pdf", "basket_pdf_pair",
    "CHF_REFERENCE", "CHF_RHO05", "ISING_C_STR", "ISING_DE_STR", "MVN_MASS", "STDNORM", "TPI_STR",
    "LOG2_STR", "ZETA3_STR", "ising_truth", "ising_truth_mp", "ising_truth_str",
]
