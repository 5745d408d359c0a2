"""Dense operations, the growing LU and the hand-written CUDA kernels."""
