"""The benchmark of ttcross_tpu_torch on NVIDIA H100 cards: see core.py and
BENCHMARK.json at the root of the checkout."""
