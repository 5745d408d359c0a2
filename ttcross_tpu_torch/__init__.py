"""ttcross_tpu_torch: the PyTorch/CUDA port of ttcross_tpu.

DMRG-greedy tensor-train cross interpolation (Dolgov & Savostyanov,
arXiv:1903.11554) for PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (sm_90a).  The JAX package ``ttcross_tpu`` is the reference this
package is tested against; this package imports neither it nor jax.

Entry points: the problem makers of ``ttcross_tpu_torch.apps``
(``make_ising``, ``make_mvn``, ``make_stdnorm``, ``make_cos_coefficients``),
``ttcross_tpu_torch.cross`` (``cross``, ``maxvol_refine``, ``cross_maxvol``,
``accchk``) and the loaders of ``ttcross_tpu_torch.tt``; all run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

from .tt.types import TT, from_cores, ones, rank1, zeros  # noqa: F401

__version__ = "0.1.0"

__all__ = ["TT", "from_cores", "ones", "rank1", "zeros",
           "apps", "cross", "interop", "ops", "tt", "utils"]
