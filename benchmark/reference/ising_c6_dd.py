"""Plain reference of the ising_c6_dd_r64 configuration: the Ising
susceptibility integral C_6 (Bailey, Borwein and Crandall, "Integrals of the
Ising class", J. Phys. A 39 (2006) 12271) in d = 5 variables, at the
substitution of the upstream test program (test_crs_ising.f90:102-144), in
Python's decimal at PREC = 100 significant digits, some 70 beyond what a
double-double value holds.

The rule, the integrand and the quadrature weights are those of
reference/ising_c4_qd.py, which is generic in m (any C-kind m below 32):
imported here, not copied.  Nothing of the program is imported or read;
the truth is the configuration's 500-digit string.
"""

from __future__ import annotations

from .ising_c4_qd import PREC, Reference, gauss_legendre_01

__all__ = ["PREC", "Reference", "gauss_legendre_01"]
