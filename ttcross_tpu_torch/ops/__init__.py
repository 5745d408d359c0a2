"""Dense operations, the growing LU, double-double arithmetic (ops/dd.py)
and the hand-written CUDA kernels."""
