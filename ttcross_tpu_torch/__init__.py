"""ttcross_tpu_torch: the PyTorch/CUDA port of ttcross_tpu.

DMRG-greedy tensor-train cross interpolation (Dolgov & Savostyanov,
arXiv:1903.11554) for PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (sm_90a).  The JAX package ``ttcross_tpu`` is the reference this
package is tested against; this package imports neither it nor jax.

Entry points: the problem makers of ``ttcross_tpu_torch.apps``
(``make_ising``, ``make_mvn``, ``make_stdnorm``, ``make_cos_coefficients``,
``make_quantics``, ``quantics_cross``), ``ttcross_tpu_torch.cross``
(``cross``, ``cross_batch``, ``maxvol_refine``, ``cross_maxvol``,
``accchk``, ``cross_dd``, ``cross_defect_corrected``), the loaders of
``ttcross_tpu_torch.tt``, and the distributed engines of
``ttcross_tpu_torch.parallel`` (``cross_parallel``, ``cross_dd_parallel``,
``maxvol_refine_parallel``, ``pcontract``: one process per rank of a
torch.distributed group); all run on the card (``device="cuda"``) unless
the caller passes ``device="cpu"``.  The
f64 tier is the default; ``dtype=torch.float32`` (cross, cross_batch and
the makers) runs the f32 tier.  The mp tier (``cross_mp``,
``cross_mp_parallel``, ``ising_cross_mp_native``, ``cross_mp_native``) and
``ttcross_tpu_torch.native`` are host code, as in the JAX package; the
drivers of ``ttcross_tpu_torch.drivers`` run the precision tiers from the
command line (``python -m ttcross_tpu_torch.drivers.<name>``).
"""

from .tt.types import TT, from_cores, ones, rank1, zeros  # noqa: F401

__version__ = "0.1.0"

__all__ = ["TT", "from_cores", "ones", "rank1", "zeros",
           "apps", "cross", "drivers", "interop", "native", "ops", "parallel", "tt", "utils"]
