"""Applications of the port: the Ising C_m / D_m / E_m integrands."""

from .ising import IsingProblem, ising_integrand, make_ising
from .truths import ising_truth

__all__ = ["IsingProblem", "ising_integrand", "ising_truth", "make_ising"]
