"""ttcross_tpu_torch: the PyTorch/CUDA port of ttcross_tpu.

DMRG-greedy tensor-train cross interpolation (Dolgov & Savostyanov,
arXiv:1903.11554) for PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (sm_90a).  The JAX package ``ttcross_tpu`` is the reference this
package is tested against; this package imports neither it nor jax.

Entry points: ``ttcross_tpu_torch.apps.make_ising`` and
``ttcross_tpu_torch.cross.cross``, each with an explicit ``device``.
"""

__all__ = ["apps", "cross", "interop", "ops", "tt", "utils"]
